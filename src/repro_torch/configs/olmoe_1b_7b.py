"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) vocab=50304,
MoE 64 experts top-8, d_expert=1024 [arXiv:2409.02060], as
``repro.configs.olmoe_1b_7b``."""

import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

register(
    ArchSpec(
        arch_id="olmoe-1b-7b",
        family="lm",
        model_cfg=LMConfig(
            name="olmoe-1b-7b",
            n_layers=16,
            d_model=2048,
            n_heads=16,
            n_kv_heads=16,
            d_ff=0,
            vocab_size=50304,
            head_dim=128,
            rope_theta=10000.0,
            dtype=torch.bfloat16,
            remat="full",
            moe=MoEConfig(
                n_experts=64,
                top_k=8,
                d_expert=1024,
                capacity_factor=1.25,
                group_size=1024,
            ),
        ),
        shapes=LM_SHAPES,
        micro_batches={"train_4k": 4},
    )
)
