"""Wrapper of the fused top-k CUDA kernel (csrc/fused_topk.cu).

``fused_topk(q, index, k)`` returns (scores (Q, k) fp32, ids (Q, k) int32),
ids -1 for empty slots, for any k from 1 up to ``K_MAX`` (k may exceed N, as
in the Pallas kernel). On CPU tensors it is the plain version (ref.py); on
CUDA tensors it launches the kernel or raises. ``fused_topk.launches`` counts
the kernel launches. The kernel is built from source at its first launch.

k <= ``SMEM_K`` keeps each row's running top-k in shared memory; a larger k
keeps it in a global scratch buffer allocated here, and sorts a full offer
buffer in shared memory up to k = 1024, in the global buffer itself past it
(csrc/fused_topk.cu).

Memory past ``SMEM_K``: beside the (Q, k) outputs, a (Q, splits, k)
candidate buffer and the row states, 2 kp (score, id) pairs of 8 bytes for
each padded query row and split (kp the next power of two >= k), so about
Q (splits k + 2 kp) 8 bytes in all; the splits are cut so that the states
stay under ``STATE_BYTES``, down to one. ``K_MAX`` bounds the kernel's
32-bit indexing, not memory: at Q = 2048 a k of 2^20 already asks for about
34 GB of states, and torch raises its out-of-memory error where the card
cannot hold them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_topk.ref import topk_scores_ref

NAME = "fused_topk"
#: the largest k whose per-row state lives in shared memory
SMEM_K = 128
#: the largest k the op takes: a row state of 2 * next_pow2(k) pairs is
#: indexed with 32-bit ints inside the kernel
K_MAX = 1 << 24
BLOCK_Q = 64
BLOCK_N = 128
#: global row-state bytes (k > SMEM_K) above which fewer column splits are
#: used (each split holds BLOCK_Q row states per query tile)
STATE_BYTES = 1 << 30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(NAME)
    lib.fused_topk_launch.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    lib.fused_topk_launch.restype = ctypes.c_int
    lib.fused_topk_error_string.argtypes = [ctypes.c_int]
    lib.fused_topk_error_string.restype = ctypes.c_char_p
    for fn in ("fused_topk_kpad", "fused_topk_block_q", "fused_topk_block_n"):
        getattr(lib, fn).restype = ctypes.c_int
    if (lib.fused_topk_kpad(), lib.fused_topk_block_q(), lib.fused_topk_block_n()) != (
        SMEM_K, BLOCK_Q, BLOCK_N
    ):
        raise RuntimeError("fused_topk.cu and ops.py disagree on k_pad or tile sizes")
    return lib


def state_pairs(k: int) -> int:
    """kp, the sorted-best length of a row state (2 * kp pairs with its
    offer buffer): SMEM_K up to SMEM_K, else the next power of two >= k."""
    return SMEM_K if k <= SMEM_K else 1 << (k - 1).bit_length()


def split_plan(n_q: int, n: int, sm_count: int, max_splits: Optional[int] = None
               ) -> Tuple[int, int]:
    """(splits, cols_per_split): the index is cut into column ranges, whole
    tiles each, so that query tiles x splits fills the SMs once (one block
    fits per SM), and at most ``max_splits`` ranges. On an H100, more splits
    ran slower at both the serve and the eval shape: each split pays its own
    warm-up of the per-row top-k, and the merge pass grows with the
    splits."""
    q_tiles = -(-n_q // BLOCK_Q)
    n_tiles = -(-n // BLOCK_N)
    want = max(1, min(n_tiles, sm_count // q_tiles))
    if max_splits is not None:
        want = max(1, min(want, max_splits))
    tiles_per_split = -(-n_tiles // want)
    return -(-n_tiles // tiles_per_split), tiles_per_split * BLOCK_N


def _check(q, p, k, col_valid):
    if q.dim() != 2 or p.dim() != 2 or q.shape[1] != p.shape[1]:
        raise ValueError(f"need q (Q, d) and index (N, d); got {tuple(q.shape)}, {tuple(p.shape)}")
    if q.shape[0] < 1 or p.shape[0] < 1 or q.shape[1] < 1:
        raise ValueError(f"empty operand: q {tuple(q.shape)}, index {tuple(p.shape)}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"fused_topk takes 1 <= k <= {K_MAX}; got k={k}")
    if q.device != p.device:
        raise ValueError(f"q on {q.device}, index on {p.device}")
    for name, t in (("q", q), ("index", p)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16; got {t.dtype}")
    if col_valid is not None:
        if col_valid.dtype != torch.bool or col_valid.shape != (p.shape[0],):
            raise ValueError(
                f"col_valid must be bool ({p.shape[0]},); got {col_valid.dtype} "
                f"{tuple(col_valid.shape)}"
            )
        if col_valid.device != p.device:
            raise ValueError(f"col_valid on {col_valid.device}, index on {p.device}")
    for name, t in (("q", q), ("index", p), ("col_valid", col_valid)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (row-major)")


def fused_topk(
    q: torch.Tensor,                       # (Q, d)
    index: torch.Tensor,                   # (N, d)
    k: int,
    *,
    col_valid: Optional[torch.Tensor] = None,   # (N,) bool
    inv_tau: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (Q, k) fp32, ids (Q, k) int32); -1 ids mark empty slots.

    q and index are scored in their common type: bf16 with bf16, else fp32
    (the smaller operand is cast, as the reference's ``result_type``)."""
    _check(q, index, k, col_valid)
    if q.device.type == "cpu":
        return topk_scores_ref(q, index, k, col_valid=col_valid, inv_tau=inv_tau)
    if q.device.type != "cuda":
        raise ValueError(f"fused_topk runs on cuda or cpu tensors, not {q.device}")
    ct = torch.promote_types(q.dtype, index.dtype)
    q, index = q.to(ct), index.to(ct)
    lib = _library()

    n_q, d = q.shape
    n = index.shape[0]
    dev = q.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kp = state_pairs(k)
    q_tiles = -(-n_q // BLOCK_Q)
    # k > SMEM_K: each split block's BLOCK_Q row states of 2 * kp (score, id)
    # pairs live in global scratch, 8 bytes a pair
    per_split = q_tiles * BLOCK_Q * 2 * kp * 8
    max_splits = None if kp == SMEM_K else max(1, STATE_BYTES // per_split)
    splits, cols_per_split = split_plan(n_q, n, sms, max_splits)
    cand_s = torch.empty((n_q, splits, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((n_q, splits, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=dev)
    state_s = state_i = None
    if kp != SMEM_K:
        n_state = q_tiles * splits * BLOCK_Q * 2 * kp
        state_s = torch.empty((n_state,), dtype=torch.float32, device=dev)
        state_i = torch.empty((n_state,), dtype=torch.int32, device=dev)
    # 16-byte vector loads need whole 16-byte rows and aligned bases
    vec = int(
        (d * q.element_size()) % 16 == 0
        and q.data_ptr() % 16 == 0
        and index.data_ptr() % 16 == 0
    )
    with torch.cuda.device(dev):
        err = lib.fused_topk_launch(
            q.data_ptr(), index.data_ptr(),
            None if col_valid is None else col_valid.data_ptr(),
            cand_s.data_ptr(), cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            None if state_s is None else state_s.data_ptr(),
            None if state_i is None else state_i.data_ptr(),
            n_q, n, d, k, kp, splits, cols_per_split, float(inv_tau),
            _DTYPE_CODES[ct], vec, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_topk launch failed: {lib.fused_topk_error_string(err).decode()}"
        )
    fused_topk.launches += 1
    return out_s, out_i


fused_topk.launches = 0
