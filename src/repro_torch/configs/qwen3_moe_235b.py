"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, d_expert=1536 [hf:Qwen/Qwen3 family], as
``repro.configs.qwen3_moe_235b``. Pod-scale: its cells build on meta
tensors, and no path on the card runs them."""

import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

register(
    ArchSpec(
        arch_id="qwen3-moe-235b-a22b",
        family="lm",
        model_cfg=LMConfig(
            name="qwen3-moe-235b-a22b",
            n_layers=94,
            d_model=4096,
            n_heads=64,
            n_kv_heads=4,
            d_ff=0,
            vocab_size=151936,
            head_dim=128,
            rope_theta=1000000.0,
            dtype=torch.bfloat16,
            remat="full",
            moe=MoEConfig(
                n_experts=128,
                top_k=8,
                d_expert=1536,
                capacity_factor=1.25,
                group_size=1024,
            ),
        ),
        shapes=LM_SHAPES,
        micro_batches={"train_4k": 16},
        notes=(
            "AdamW moments stored bf16 (optim.adamw moment_dtype): 235B fp32 "
            "moments would need 7.3 GB/chip on 256 chips, over the v5e budget "
            "with activations; see EXPERIMENTS.md §Dry-run."
        ),
    )
)
