"""Attention for the BERT towers: the plain (B, S, H, D) einsum path.

Logits are taken in fp32 whatever the input type, masked positions get the
finite ``NEG_INF``, the softmax is fp32 and is cast to v's type before the
value product, as in ``repro.models.attention.plain_attention``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision import NEG_INF


def plain_attention(
    q: torch.Tensor,           # (B, Sq, H, D)
    k: torch.Tensor,           # (B, Skv, H, D)
    v: torch.Tensor,           # (B, Skv, H, D)
    *,
    kv_mask: Optional[torch.Tensor] = None,   # (B, Skv) bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
