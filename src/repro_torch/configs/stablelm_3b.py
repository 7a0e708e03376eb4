"""stablelm-3b [dense]: 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304 [hf:stabilityai/stablelm-2-1_6b family; unverified], as
``repro.configs.stablelm_3b``."""

import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.lm import LMConfig

register(
    ArchSpec(
        arch_id="stablelm-3b",
        family="lm",
        model_cfg=LMConfig(
            name="stablelm-3b",
            n_layers=32,
            d_model=2560,
            n_heads=32,
            n_kv_heads=32,
            d_ff=6912,
            vocab_size=50304,
            head_dim=80,
            rope_theta=10000.0,
            dtype=torch.bfloat16,
            remat="full",
        ),
        shapes=LM_SHAPES,
        micro_batches={"train_4k": 4},
    )
)
