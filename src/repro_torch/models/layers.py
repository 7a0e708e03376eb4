"""Shared primitive layers (plain functions on tensors)."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F


def dense_init(
    generator: torch.Generator,
    d_in: int,
    d_out: int,
    *,
    scale: Optional[float] = None,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device],
) -> torch.Tensor:
    """A (d_in, d_out) weight drawn normal x ``scale`` (1 / sqrt(d_in) by
    default) from ``generator``, which lives on ``device``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, device=device) * scale
    return w.to(dtype)


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
