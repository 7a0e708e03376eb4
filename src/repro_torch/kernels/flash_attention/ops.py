"""Wrapper of the flash attention CUDA kernel (csrc/flash_attention.cu), as
``repro.kernels.flash_attention.ops``.

``flash_attention(q, k, v, causal=, kv_mask=, scale=, block_q=, block_k=)``
is a ``torch.autograd.Function``. Its forward is the kernel for CUDA tensors
(built from source at its first launch; it launches or raises) and the
plain version (ref.py) for CPU tensors. Its backward, as the JAX package's
``_bwd``, is not a kernel: it recomputes the attention through
``models.attention.chunked_attention`` (blocks of ``block_q`` x
``block_k``) under autograd and returns dq, dk and dv.

The shape contract is the JAX kernel's: q (B, Sq, H, D), k and v (B, Skv,
Hk, D) with H a multiple of Hk, ``Sq % min(block_q, Sq) == 0`` and
``Skv % min(block_k, Skv) == 0``, so both packages take the same inputs.
``kv_mask=None`` means every key is visible. q, k and v may be strided
views (the split heads of one fused projection): the kernel reads them
through their batch, row and head strides; a last dimension that is not
contiguous is copied first.

``flash_attention.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.attention import chunked_attention

NAME = "flash_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel takes: multiples of 16 (the tensor-core tile) up to 128
HEAD_DIMS = range(16, 129, 16)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd_launch.argtypes = (
        [ptr] * 5 + [i32] * 6 + [i64] * 9 + [ctypes.c_float, i32, i32, i32, ptr]
    )
    lib.flash_attention_fwd_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, kv_mask, block_q, block_k) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q (B, Sq, H, D) and k, v (B, Skv, Hk, D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, sq, h, d = q.shape
    _, skv, hk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or min(b, sq, skv, h, hk, d) < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    if h % hk:
        raise ValueError(f"query heads ({h}) must be a multiple of kv heads ({hk})")
    if kv_mask is not None and (kv_mask.dtype != torch.bool or tuple(kv_mask.shape) != (b, skv)):
        raise ValueError(
            f"kv_mask must be bool ({b}, {skv}); got {kv_mask.dtype} {tuple(kv_mask.shape)}"
        )
    bq, bk = min(block_q, sq), min(block_k, skv)
    if sq % bq or skv % bk:
        raise ValueError(
            f"flash_attention needs Sq % min(block_q, Sq) == 0 and Skv % min(block_k, Skv)"
            f" == 0; got Sq={sq}, block_q={block_q}, Skv={skv}, block_k={block_k}"
        )
    for name, t in (("k", k), ("v", v), ("kv_mask", kv_mask)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """t itself when its last dim is contiguous, else an explicit copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _launch(q, k, v, kv_mask, causal: bool, scale: float) -> torch.Tensor:
    """One launch of the kernel: (B, Sq, H, D) in q's type."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"the kernel takes q, k, v all float32 or all bfloat16; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    b, sq, h, d = q.shape
    _, skv, hk, _ = k.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not a multiple of 16 in [16, 128]")
    lib = _library()
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    mask = None if kv_mask is None else kv_mask.contiguous().view(torch.uint8)
    vec = int(all(
        t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])
        for t in (q, k, v)
    ))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(),
            b, sq, skv, h, hk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(causal), _DTYPE_CODES[q.dtype], vec,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed: {lib.flash_attention_error_string(err).decode()}"
        )
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, block_q, block_k):
        if q.device.type == "cpu":
            out = flash_attention_ref(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale)
        else:
            sc = scale if scale is not None else q.shape[-1] ** -0.5
            out = _launch(q, k, v, kv_mask, causal, sc)
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.cfg = (causal, scale, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        causal, scale, block_q, block_k = ctx.cfg
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), need)]
            out = chunked_attention(
                *qkv, causal=causal, kv_mask=kv_mask, scale=scale,
                q_chunk=block_q, kv_chunk=block_k,
            )
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(qkv, need) if n], g))
        return (*(next(grads) if n else None for n in need), None, None, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_q: int = 256,
    block_k: int = 512,
) -> torch.Tensor:
    """Attention over BSHD tensors with GQA, an optional causal mask and a
    (B, Skv) key mask; differentiable w.r.t. q, k and v."""
    _check(q, k, v, kv_mask, block_q, block_k)
    return _FlashAttention.apply(q, k, v, kv_mask, causal, scale, block_q, block_k)


flash_attention.launches = 0
