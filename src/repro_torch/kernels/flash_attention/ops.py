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
views (the split heads of one fused projection): the kernel reads them in
place through their batch, row and head strides (by TMA for bf16). TMA, and
the fp32 path's 16-byte copies, need a 16-byte aligned base and batch, row
and head strides that are 16-byte multiples, and a contiguous last
dimension: a tensor that breaks any of these is copied to a contiguous one
first (``_tma_ready``), and the kernel keeps one load path.

The bf16 kernel's tile shape (query rows ``BQ``, keys ``BK`` a tile) is
``tile_plan``'s plain function of the shape; ``block_q`` and ``block_k``
are the JAX op's shape contract and the backward's chunks, not the kernel's
tiles.

``flash_attention.launches`` counts the kernel's launches and
``flash_attention.paths`` the path of each (``PATHS``: ``"hopper"``, the
bf16 TMA + ``wgmma`` kernel; ``"fp32"``, the CUDA-core kernel);
``reset_launches()`` zeroes both.
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
#: the most shared memory one block may use on sm_90 (227 KB), and the part
#: of a SM's shared memory reserved for each resident block
SMEM_LIMIT = 232_448
BLOCK_RESERVED_SMEM = 1024
PATHS = ("hopper", "fp32")


def smem_bytes_mirror(block_q: int, block_k: int, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block, as the kernel lays it out. bf16:
    the q tile and two stages of K and V tiles, each ceil(d / 64) chunks of
    rows x 128 bytes, 9 barriers and 1024 bytes to align the base. fp32
    (64 x 64 tiles): q, k and v tiles of rows d + 4 floats, the scores, the
    accumulator, three row vectors and the column states, each 128-aligned.
    Only the CPU tests use this mirror of the layout; on the card the plan
    asks the library (``flash_attention_smem_bytes``), and a CUDA test holds
    the two equal."""
    if dtype == torch.float32:
        def a128(x):
            return -(-x // 128) * 128

        tile = a128(64 * (d + 4) * 4)
        return 4 * tile + a128(64 * 68 * 4) + 3 * a128(64 * 4) + a128(64)
    nc = -(-d // 64)
    return nc * block_q * 128 + 2 * 2 * nc * block_k * 128 + 8 * 9 + 1024


def tile_plan(b: int, sq: int, skv: int, h: int, d: int, dtype: torch.dtype, *, sms: int,
              sm_smem: int, smem_bytes=smem_bytes_mirror, causal: bool = False):
    """(BQ, BK) of the kernel at this shape on a card of ``sms`` SMs with
    ``sm_smem`` bytes of shared memory each; ``smem_bytes(BQ, BK, d, dtype)``
    is the shared memory of a block. fp32: 64 x 64. bf16: BK = 128 when the
    keys fill more than one 64-key tile, else 64. Where two 64-row blocks of
    128 keys fit a SM (D <= 64 on an H100), BQ = 64, and BK falls to 64 once
    those blocks fill the card's two slots a SM more than twice over (an
    index encode batch; the BERT passage pass of a train chunk fills them
    1.45 times). Else (one block a SM) BQ = 128 (two consumer warpgroups)
    when the queries fill more than one warpgroup's 64 rows and its blocks
    fill the SMs at least once, else 64; under a causal mask BK = 64 up to
    256 keys (the LM retriever's 256-token passage pass: 128 x 64 0.0186 ms
    against 128 x 128 0.0204 on an H100). Fitted to the shapes
    ``bench.py`` times (PERF.md)."""
    if dtype == torch.float32:
        return 64, 64
    bk = 128 if skv > 64 else 64
    if 2 * (smem_bytes(64, 128, d, dtype) + BLOCK_RESERVED_SMEM) <= sm_smem:
        slots = 2 * sms
        return 64, (64 if b * h * -(-sq // 64) > 2 * slots else bk)
    if causal and skv <= 256:
        bk = 64
    return (128 if sq > 64 and b * h * -(-sq // 128) >= sms else 64), bk


def _library_smem_bytes(block_q: int, block_k: int, d: int, dtype: torch.dtype) -> int:
    return _library().flash_attention_smem_bytes(_DTYPE_CODES[dtype], block_q, block_k, d)


@functools.lru_cache(maxsize=None)
def _plan(b: int, sq: int, skv: int, h: int, d: int, dtype: torch.dtype, device: int,
          causal: bool = False):
    """tile_plan on card ``device``, with its SMs and their shared memory and
    the built library's shared memory a block; one computation a shape."""
    props = torch.cuda.get_device_properties(device)
    return tile_plan(b, sq, skv, h, d, dtype, sms=props.multi_processor_count,
                     sm_smem=props.shared_memory_per_multiprocessor,
                     smem_bytes=_library_smem_bytes, causal=causal)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd_launch.argtypes = (
        [ptr] * 5 + [i32] * 6 + [i64] * 9 + [ctypes.c_float, i32, i32, i32, i32, ptr]
    )
    lib.flash_attention_fwd_launch.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [i32] * 4
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    lib.flash_attention_kernel_attributes.argtypes = [i32] * 4 + [ctypes.POINTER(i32)] * 2
    lib.flash_attention_kernel_attributes.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def kernel_attributes(block_q: int, block_k: int, d: int, dtype: torch.dtype) -> dict:
    """Registers a thread and local memory a thread (stack frame and spills:
    0 when ptxas spilled nothing) of the kernel under this plan, as the card
    reports them for the built library."""
    lib, regs, local = _library(), ctypes.c_int(), ctypes.c_int()
    err = lib.flash_attention_kernel_attributes(_DTYPE_CODES[dtype], block_q, block_k, d,
                                                ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"no flash_attention kernel for {dtype} {block_q}x{block_k} at D={d}: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    return {"registers": regs.value, "local_bytes": local.value}


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


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernel can read it in place (a contiguous last dim,
    a 16-byte aligned base, and batch, row and head strides that are 16-byte
    multiples), else an explicit contiguous copy (a new, aligned tensor)."""
    size = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:3])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v, kv_mask, causal: bool, scale: float, tiles=None) -> torch.Tensor:
    """One launch of the kernel: (B, Sq, H, D) in q's type. ``tiles``
    (BQ, BK) defaults to the shape's plan (``tile_plan``); it is the only
    way to run another plan, and only the kernel's benchmark and its CUDA
    tests pass it."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"the kernel takes q, k, v all float32 or all bfloat16; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    b, sq, h, d = q.shape
    _, skv, hk, _ = k.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not a multiple of 16 in [16, 128]")
    if tiles is None:
        tiles = _plan(b, sq, skv, h, d, q.dtype, q.device.index, causal)
    bq, bk = tiles
    lib = _library()
    q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    mask = None if kv_mask is None else kv_mask.contiguous().view(torch.uint8)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(),
            b, sq, skv, h, hk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(causal), _DTYPE_CODES[q.dtype], bq, bk,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed: {lib.flash_attention_error_string(err).decode()}"
        )
    flash_attention.launches += 1
    flash_attention.paths["hopper" if q.dtype == torch.bfloat16 else "fp32"] += 1
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


def reset_launches() -> None:
    """Zero the launch count and the path counts."""
    flash_attention.launches = 0
    flash_attention.paths = dict.fromkeys(PATHS, 0)


reset_launches()
