"""Wrappers of the fused InfoNCE CUDA kernels (csrc/fused_infonce.cu).

``fused_infonce_stats(q, p, labels, col_valid, inv_tau)`` returns per-row
``(lse, pos, amax)``, fp32, and is differentiable w.r.t. q and p (a
``torch.autograd.Function``): its backward launches the dQ kernel only when
q needs a gradient and the dP kernel only when p does. ``amax`` is
metrics-only (marked non-differentiable; its cotangent is dropped, as the
JAX ``_stats_bwd`` drops it). The (M, N) score matrix never reaches device
memory in either direction.

Three entry points, one per kernel, each with a launch count:
``fused_infonce_fwd.launches``, ``fused_infonce_dq.launches``,
``fused_infonce_dp.launches``. On CPU tensors they are the plain version
(ref.py); on CUDA tensors they launch their kernel or raise. Each kernel is
built from source at its first launch.

``merge_row_stats``, ``fused_infonce_rows`` and ``fused_infonce_loss`` are
plain tensor code over the stats, as in ``repro.kernels.fused_infonce.ops``.
The per-row ``(lse, pos, amax)`` triple is the carried online-softmax state:
stats over disjoint column chunks compose exactly with ``merge_row_stats``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.precision import STATS_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.fused_infonce.ref import infonce_stats_ref, infonce_stats_vjp_ref

NAME = "fused_infonce"
BLOCK_M = 64
BLOCK_N = 64
#: most tiles one block walks along the split axis (its coefficient strip)
SPLIT_TILES = 8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_infonce_fwd_launch.argtypes = (
        [ptr] * 8 + [i32] * 5 + [ctypes.c_float, i32, i32, ptr]
    )
    for fn in (lib.fused_infonce_dq_launch, lib.fused_infonce_dp_launch):
        fn.argtypes = [ptr] * 9 + [i32] * 5 + [ctypes.c_float, i32, i32, ptr]
    for fn in (lib.fused_infonce_fwd_launch, lib.fused_infonce_dq_launch,
               lib.fused_infonce_dp_launch):
        fn.restype = ctypes.c_int
    lib.fused_infonce_error_string.argtypes = [ctypes.c_int]
    lib.fused_infonce_error_string.restype = ctypes.c_char_p
    for fn in ("fused_infonce_block_m", "fused_infonce_block_n", "fused_infonce_split_tiles"):
        getattr(lib, fn).restype = ctypes.c_int
    if (lib.fused_infonce_block_m(), lib.fused_infonce_block_n(),
            lib.fused_infonce_split_tiles()) != (BLOCK_M, BLOCK_N, SPLIT_TILES):
        raise RuntimeError("fused_infonce.cu and ops.py disagree on tile sizes")
    return lib


def split_plan(n_tiles: int, other_tiles: int, sm_count: int) -> Tuple[int, int]:
    """(splits, tiles_per_split) along the split axis: enough splits that
    other_tiles x splits blocks fill the SMs once, each split at most
    SPLIT_TILES tiles (the block's coefficient strip in shared memory)."""
    want = max(1, min(n_tiles, -(-sm_count // other_tiles)))
    per = min(SPLIT_TILES, -(-n_tiles // want))
    return -(-n_tiles // per), per


def _check(q, p, labels, col_valid):
    if q.dim() != 2 or p.dim() != 2 or q.shape[1] != p.shape[1]:
        raise ValueError(f"need q (M, d) and p (N, d); got {tuple(q.shape)}, {tuple(p.shape)}")
    if q.shape[0] < 1 or p.shape[0] < 1 or q.shape[1] < 1:
        raise ValueError(f"empty operand: q {tuple(q.shape)}, p {tuple(p.shape)}")
    for name, t in (("q", q), ("p", p)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16; got {t.dtype}")
    if labels.dtype != torch.int32 or labels.shape != (q.shape[0],):
        raise ValueError(
            f"labels must be int32 ({q.shape[0]},); got {labels.dtype} {tuple(labels.shape)}"
        )
    if col_valid is not None and (
        col_valid.dtype != torch.bool or col_valid.shape != (p.shape[0],)
    ):
        raise ValueError(
            f"col_valid must be bool ({p.shape[0]},); got {col_valid.dtype} "
            f"{tuple(col_valid.shape)}"
        )
    for name, t in (("p", p), ("labels", labels), ("col_valid", col_valid)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("p", p), ("labels", labels), ("col_valid", col_valid)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (row-major)")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_infonce runs on cuda or cpu tensors, not {q.device}")


def _check_rows(q, **rows):
    for name, t in rows.items():
        if t.dtype != STATS_DTYPE or t.shape != (q.shape[0],):
            raise ValueError(f"{name} must be float32 ({q.shape[0]},); got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def _operands(q, p):
    """q and p in their common type (bf16 with bf16, else fp32), as the
    TPU kernel's ``_prep_operands``; 16-byte loads where rows and bases allow."""
    ct = torch.promote_types(q.dtype, p.dtype)
    q, p = q.to(ct), p.to(ct)
    vec = int(
        (q.shape[1] * q.element_size()) % 16 == 0
        and q.data_ptr() % 16 == 0
        and p.data_ptr() % 16 == 0
    )
    return q, p, ct, vec


def _raise_on(err: int, what: str, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.fused_infonce_error_string(err).decode()}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def fused_infonce_fwd(
    q: torch.Tensor,                             # (M, d)
    p: torch.Tensor,                             # (N, d)
    labels: torch.Tensor,                        # (M,) int32
    col_valid: Optional[torch.Tensor] = None,    # (N,) bool
    inv_tau: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lse, pos, amax) per row, fp32. Not differentiable: use
    ``fused_infonce_stats`` for that."""
    _check(q, p, labels, col_valid)
    if q.device.type == "cpu":
        with torch.no_grad():
            return infonce_stats_ref(q, p, labels, col_valid, inv_tau=inv_tau)
    lib = _library()
    q, p, ct, vec = _operands(q, p)
    m, d = q.shape
    n = p.shape[0]
    dev = q.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    m_tiles = -(-m // BLOCK_M)
    splits, per = split_plan(-(-n // BLOCK_N), m_tiles, sms)
    lse, pos, amax = (torch.empty((m,), dtype=STATS_DTYPE, device=dev) for _ in range(3))
    part = torch.empty((3, m, splits) if splits > 1 else (1,), dtype=STATS_DTYPE, device=dev)
    with torch.cuda.device(dev):
        err = lib.fused_infonce_fwd_launch(
            q.data_ptr(), p.data_ptr(), labels.data_ptr(),
            None if col_valid is None else col_valid.data_ptr(),
            lse.data_ptr(), pos.data_ptr(), amax.data_ptr(), part.data_ptr(),
            m, n, d, splits, per, float(inv_tau), _DTYPE_CODES[ct], vec, _stream(dev),
        )
    _raise_on(err, "fused_infonce forward", lib)
    fused_infonce_fwd.launches += 1
    return lse, pos, amax


def _grad(which, q, p, labels, col_valid, lse, g_lse, g_pos, inv_tau):
    lib = _library()
    q, p, ct, vec = _operands(q, p)
    m, d = q.shape
    n = p.shape[0]
    dev = q.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    m_tiles, n_tiles = -(-m // BLOCK_M), -(-n // BLOCK_N)
    if which == "dq":
        splits, per = split_plan(n_tiles, m_tiles, sms)
        rows, launch = m, lib.fused_infonce_dq_launch
    else:
        splits, per = split_plan(m_tiles, n_tiles, sms)
        rows, launch = n, lib.fused_infonce_dp_launch
    out = torch.empty((rows, d), dtype=ct, device=dev)
    partial = torch.empty(
        (splits, rows, d) if splits > 1 else (1,), dtype=STATS_DTYPE, device=dev
    )
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(), p.data_ptr(), labels.data_ptr(),
            None if col_valid is None else col_valid.data_ptr(),
            lse.data_ptr(), g_lse.data_ptr(), g_pos.data_ptr(),
            out.data_ptr(), partial.data_ptr(),
            m, n, d, splits, per, float(inv_tau), _DTYPE_CODES[ct], vec, _stream(dev),
        )
    _raise_on(err, f"fused_infonce {which}", lib)
    return out


def fused_infonce_dq(q, p, labels, col_valid, lse, g_lse, g_pos, inv_tau=1.0) -> torch.Tensor:
    """dQ (M, d) in q's type for the row cotangents (g_lse, g_pos) of the
    forward whose lse is given."""
    _check(q, p, labels, col_valid)
    _check_rows(q, lse=lse, g_lse=g_lse, g_pos=g_pos)
    if q.device.type == "cpu":
        return infonce_stats_vjp_ref(q, p, labels, col_valid, g_lse, g_pos, inv_tau=inv_tau)[0]
    out = _grad("dq", q, p, labels, col_valid, lse, g_lse, g_pos, inv_tau)
    fused_infonce_dq.launches += 1
    return out.to(q.dtype)


def fused_infonce_dp(q, p, labels, col_valid, lse, g_lse, g_pos, inv_tau=1.0) -> torch.Tensor:
    """dP (N, d) in p's type for the row cotangents (g_lse, g_pos)."""
    _check(q, p, labels, col_valid)
    _check_rows(q, lse=lse, g_lse=g_lse, g_pos=g_pos)
    if q.device.type == "cpu":
        return infonce_stats_vjp_ref(q, p, labels, col_valid, g_lse, g_pos, inv_tau=inv_tau)[1]
    out = _grad("dp", q, p, labels, col_valid, lse, g_lse, g_pos, inv_tau)
    fused_infonce_dp.launches += 1
    return out.to(p.dtype)


fused_infonce_fwd.launches = 0
fused_infonce_dq.launches = 0
fused_infonce_dp.launches = 0


def reset_launches() -> None:
    """Set the three launch counts to 0."""
    fused_infonce_fwd.launches = fused_infonce_dq.launches = fused_infonce_dp.launches = 0


class _FusedInfoNCEStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, p, labels, col_valid, inv_tau):
        lse, pos, amax = fused_infonce_fwd(q, p, labels, col_valid, inv_tau)
        ctx.save_for_backward(q, p, labels, col_valid, lse)
        ctx.inv_tau = inv_tau
        ctx.mark_non_differentiable(amax)
        ctx.set_materialize_grads(False)
        return lse, pos, amax

    @staticmethod
    def backward(ctx, g_lse, g_pos, _g_amax):  # amax is metrics-only
        q, p, labels, col_valid, lse = ctx.saved_tensors
        if g_lse is None and g_pos is None:
            return None, None, None, None, None
        g_lse = torch.zeros_like(lse) if g_lse is None else g_lse.to(STATS_DTYPE).contiguous()
        g_pos = torch.zeros_like(lse) if g_pos is None else g_pos.to(STATS_DTYPE).contiguous()
        args = (q, p, labels, col_valid, lse, g_lse, g_pos, ctx.inv_tau)
        dq = fused_infonce_dq(*args) if ctx.needs_input_grad[0] else None
        dp = fused_infonce_dp(*args) if ctx.needs_input_grad[1] else None
        return dq, dp, None, None, None


def fused_infonce_stats(
    q: torch.Tensor,
    p: torch.Tensor,
    labels: torch.Tensor,
    col_valid: Optional[torch.Tensor] = None,
    inv_tau: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lse, pos, amax) per row, fp32; differentiable w.r.t. q and p.
    ``col_valid`` ((N,) bool or None) masks columns out of the softmax and
    the gradients; a label outside [0, N) gives pos = 0 and no gradient."""
    return _FusedInfoNCEStats.apply(q, p, labels, col_valid, float(inv_tau))


def merge_row_stats(lse_chunks, pos_chunks, owns_chunks, amax_chunks):
    """Compose per-chunk row statistics over a partition of the column set,
    all stacked (C, M), into the statistics of the full set:
    ``lse = logsumexp_k lse_k``, pos from the owning chunk, amax the max.
    Exact; differentiable in lse/pos; chunks with no valid column weigh
    ``exp(-1e30 - lse) = 0``."""
    lse = torch.logsumexp(lse_chunks, dim=0)
    pos = torch.where(owns_chunks, pos_chunks, torch.zeros_like(pos_chunks)).sum(dim=0)
    amax = amax_chunks.max(dim=0).values
    return lse, pos, amax


def fused_infonce_rows(q, p, labels, inv_tau: float = 1.0):
    """(lse, pos) per row, all columns valid. Differentiable w.r.t. q and p."""
    lse, pos, _ = fused_infonce_stats(q, p, labels, None, inv_tau)
    return lse, pos


def fused_infonce_loss(
    q: torch.Tensor,
    p: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    *,
    col_valid: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Mean InfoNCE over rows (labels default to the diagonal)."""
    if labels is None:
        labels = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)
    lse, pos, _ = fused_infonce_stats(q, p, labels, col_valid, 1.0 / temperature)
    return torch.mean(lse - pos)
