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


def linear(params, x: torch.Tensor, *, bias_key: str = "b", weight_key: str = "w") -> torch.Tensor:
    """``x @ params[weight_key]``, plus ``params[bias_key]`` where present."""
    y = x @ params[weight_key]
    if bias_key in params:
        y = y + params[bias_key]
    return y


def rms_norm(scale: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 internals, cast back to x's type."""
    dtype = x.dtype
    x = x.float()
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def rotary_embedding(
    positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
    dtype: torch.dtype = torch.float32,
):
    """(..., S) int positions -> cos and sin, (..., S, head_dim / 2) each:
    the angles in fp32, both cast to ``dtype`` before any rotation."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) rotated by cos and sin (..., S, D / 2), broadcast over
    the heads: the two halves of D are the pair (not interleaved)."""
    x1, x2 = x.chunk(2, dim=-1)
    cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
