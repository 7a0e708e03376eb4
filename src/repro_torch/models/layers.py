"""Shared primitive layers (plain functions on tensors)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm with fp32 internals (bf16-safe), BERT's eps by default."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (the JAX package's ``approximate=True``)."""
    return F.gelu(x, approximate="tanh")
