"""Plain PyTorch version of the flash attention kernel: materialises the full
(B, H, Sq, Skv) scores, as ``repro.kernels.flash_attention.ref``.

Logits are fp32 products of the inputs, scaled; a causal mask (column >
row, rows counted from 0) and a False ``kv_mask`` entry give the finite
``NEG_INF``, so a row with no visible key averages every value; the fp32
softmax is cast to v's type before the value product. The CPU path of
``ops.flash_attention`` and the card's checks of the kernel use it; the
main path never calls it on a GPU.

``flash_attention_error`` holds a kernel's output against this version and
against the exact attention (the fp32 softmax times v in fp32, nothing
rounded), with an allowance for each output element.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision import NEG_INF, STATS_DTYPE


def _softmax(q, k, causal, kv_mask, scale, q_offset=0) -> torch.Tensor:
    """The fp32 softmax (B, H, Sq, Skv) of the scaled, masked logits; under
    the causal mask q's rows are positions q_offset, q_offset + 1, ..."""
    sq, d = q.shape[1], q.shape[3]
    group = q.shape[2] // k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kr = k.repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(STATS_DTYPE), kr.to(STATS_DTYPE)) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, NEG_INF)
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    return torch.softmax(logits, dim=-1)


def _values(probs: torch.Tensor, v: torch.Tensor, q_heads: int) -> torch.Tensor:
    vr = v.repeat_interleave(q_heads // v.shape[2], dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vr)


def flash_attention_ref(
    q: torch.Tensor,   # (B, Sq, H, D)
    k: torch.Tensor,   # (B, Skv, Hk, D)
    v: torch.Tensor,   # (B, Skv, Hk, D)
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,   # (B, Skv) bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    probs = _softmax(q, k, causal, kv_mask, scale).to(v.dtype)
    return _values(probs, v, q.shape[2])


#: fp32 inputs: the same fp32 products and exponentials summed in another
#: order, so each element within this share of the largest |v|
FP32_RTOL = 1e-5
#: bf16 inputs: a mean error from the exact attention no larger than this
#: many times the plain version's own (both round the same kinds of numbers
#: to bf16, so the two mean errors are about equal)
BF16_MEAN_RATIO = 1.25


def bf16_allowance(weighted_abs_v: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """What bf16 rounding lets two attention outputs differ by, per element.
    ``weighted_abs_v`` is a = sum_j p_j |v_j| and ``exact`` the exact output
    o. Each side rounds its probabilities to bf16 before the value product
    (the kernel each tile's unnormalised exp(s - m), the plain version the
    normalised softmax: at most 2^-8 a each) and its output to bf16 (at most
    2^-8 |o| each), so 2^-7 (a + |o|); 2^-12 a is room for the fp32 sums and
    the second-order terms."""
    return 2.0 ** -7 * (weighted_abs_v + exact.abs()) + 2.0 ** -12 * weighted_abs_v


def flash_attention_error(
    out: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> dict:
    """``out`` (a kernel's output on q, k, v) against this plain version and
    the exact attention. ``q_offset``: q and out are the rows from that
    position on of a longer causal pass (a check of some rows only). Returns ``max_abs_err`` (|out - plain|), ``worst``
    (the largest |out - plain| over its element's allowance: ``FP32_RTOL``
    of max|v| for fp32, ``bf16_allowance`` for bf16), and ``mean_err`` and
    ``plain_mean_err``, the mean |error| of out and of the plain version
    from the exact attention (for fp32 the plain version is the exact one,
    so its mean error is 0). The allowance is below a typical |o| at every
    shape, but a kernel that drops or misweights a tile of late keys can
    stay inside it element by element; the mean error then shows it."""
    probs = _softmax(q, k, causal, kv_mask, scale, q_offset)
    plain = _values(probs.to(v.dtype), v, q.shape[2]).float()
    exact = _values(probs, v.to(STATS_DTYPE), q.shape[2])
    diff = (out.float() - plain).abs()
    if v.dtype == torch.bfloat16:
        allowance = bf16_allowance(_values(probs, v.to(STATS_DTYPE).abs(), q.shape[2]), exact)
    else:
        allowance = torch.full_like(diff, FP32_RTOL * v.float().abs().max().item())
    return {
        "max_abs_err": diff.max().item(),
        "worst": (diff / allowance).max().item(),
        "mean_err": (out.float() - exact).abs().mean().item(),
        "plain_mean_err": (plain - exact).abs().mean().item(),
    }


def error_ok(err: dict, dtype: torch.dtype) -> bool:
    """Whether ``flash_attention_error``'s result passes: every element
    within its allowance, and for bf16 a mean error no more than
    ``BF16_MEAN_RATIO`` times the plain version's."""
    return err["worst"] <= 1.0 and (
        dtype != torch.bfloat16 or err["mean_err"] <= BF16_MEAN_RATIO * err["plain_mean_err"])
