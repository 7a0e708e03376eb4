"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias [hf:Qwen/Qwen1.5 family], as
``repro.configs.qwen1p5_110b``. Pod-scale: its cells build on meta tensors,
and no path on the card runs them."""

import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.lm import LMConfig

register(
    ArchSpec(
        arch_id="qwen1.5-110b",
        family="lm",
        model_cfg=LMConfig(
            name="qwen1.5-110b",
            n_layers=80,
            d_model=8192,
            n_heads=64,
            n_kv_heads=8,
            d_ff=49152,
            vocab_size=152064,
            head_dim=128,
            qkv_bias=True,
            rope_theta=1000000.0,
            dtype=torch.bfloat16,
            remat="full",
        ),
        shapes=LM_SHAPES,
        # the JAX config's microbatches: its dry-run reckons 86 GB of
        # layer-boundary activations a TPU device without accumulation
        micro_batches={"train_4k": 16},
    )
)
