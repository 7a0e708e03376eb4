"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 [arXiv:2403.17297], as ``repro.configs.internlm2_1p8b``."""

import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.lm import LMConfig

register(
    ArchSpec(
        arch_id="internlm2-1.8b",
        family="lm",
        model_cfg=LMConfig(
            name="internlm2-1.8b",
            n_layers=24,
            d_model=2048,
            n_heads=16,
            n_kv_heads=8,
            d_ff=8192,
            vocab_size=92544,
            head_dim=128,
            rope_theta=1000000.0,
            dtype=torch.bfloat16,
            remat="full",
        ),
        shapes=LM_SHAPES,
        micro_batches={"train_4k": 4},
    )
)
