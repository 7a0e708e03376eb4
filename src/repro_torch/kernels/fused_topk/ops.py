"""Wrapper of the fused top-k CUDA kernel (csrc/fused_topk.cu).

``fused_topk(q, index, k)`` returns (scores (Q, k) fp32, ids (Q, k) int32),
ids -1 for empty slots, for any k from 1 up to ``K_MAX`` (k may exceed N, as
in the Pallas kernel). On CPU tensors it is the plain version (ref.py); on
CUDA tensors it launches the kernel or raises. ``fused_topk.launches``
counts the launches and ``fused_topk.paths`` which path each took:

- ``"hopper"``: bf16 rows up to ``HOPPER_D_MAX``, the Hopper scan (TMA
  ring, ``wgmma`` scores, selection from registers), then the select pass:
  ``topk_scan_kernel`` with the query tile resident where it fits (every
  plan up to d = 1216), else ``topk_stream_kernel``, which streams the
  query chunks through the rings beside the index chunks (``scan_plan``);
- ``"fp32"``: fp32 inputs, the CUDA-core kernel (no TF32);
- ``"fp32_widened"``: bf16 inputs wider than ``HOPPER_D_MAX``, widened to
  fp32 (an exact copy: the products and their fp32 sums are the same) and
  run there.

The kernel is built from source at its first launch. TMA needs rows of a
multiple of 16 bytes and 16-byte aligned bases: a bf16 operand that breaks
either is copied first (``_tma_ready``: d padded with zero columns, which
add nothing to a product).

Memory: beside the (Q, k) outputs, a (Q, splits, k) candidate buffer (8
bytes a slot) and the row states (bf16: each row's pool of 2 kp keys; fp32
past ``SMEM_K``: 2 kp (score, id) pairs), 8 bytes a slot for each padded
query row and split (kp the next power of two >= k, at least ``SMEM_K``),
so about Q (splits k + 2 kp) 8 bytes in all; the splits are cut so that the
states stay under ``STATE_BYTES``, down to one. ``K_MAX`` bounds the
kernel's 32-bit indexing, not memory: at Q = 2048 a k of 2^20 already asks
for about 34 GB of pools, and torch raises its out-of-memory error where
the card cannot hold them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.fused_topk.ref import topk_scores_ref

NAME = "fused_topk"
#: the fp32 path keeps each row's state in shared memory up to this k; the
#: smallest kp of either path
SMEM_K = 128
#: the largest k the op takes: a row state of 2 * next_pow2(k) pairs is
#: indexed with 32-bit ints inside the kernel
K_MAX = 1 << 24
BLOCK_Q = 64
BLOCK_N = 128
#: global row-state bytes above which fewer column splits are used (each
#: split holds BLOCK_Q row states per query tile)
STATE_BYTES = 1 << 30

def state_pairs(k: int) -> int:
    """kp: SMEM_K up to SMEM_K, else the next power of two >= k (the fp32
    path's row state holds 2 kp pairs; the Hopper path's pools 2 kp keys,
    and its select pass sorts kp)."""
    return SMEM_K if k <= SMEM_K else 1 << (k - 1).bit_length()


# The Hopper scan's shared-memory plan (csrc/fused_topk.cu, scan_layout):
#: dynamic shared memory a block may use on sm_90 (227 KB)
SMEM_LIMIT = 232_448
#: bytes of one 64-column chunk of the 64-row query tile, and of an index
#: chunk (128 index rows x 64 columns): a ring stage, with a query chunk
#: beside it in the streamed layout
CHUNK_Q, CHUNK_P = BLOCK_Q * 128, BLOCK_N * 128
#: the query tile's layouts: resident (loaded once), spread (resident, at
#: most 32 rows, 8 to a warp, in half the bytes) and streamed (no tile: each
#: ring stage carries its query chunk); False and True are resident and
#: spread
RESIDENT, SPREAD, STREAMED = 0, 1, 2
#: the widest rows the streamed layout is planned for: its plan does not
#: depend on d, and the CUDA tests hold it to ref.py up to here (every
#: width of the repo's configs, 768, 2048 and 2560, is below)
STREAM_D_MAX = 8192
#: consumer warpgroups of a scan block, each with its own ring of at most
#: MAX_STAGES stages, its own pools and its own candidate list
CONSUMERS, MAX_STAGES = 2, 4
#: the largest pool (2 kp keys) a warp cuts in its shared staging area
STAGE_KEYS_MAX = 512
#: 8 warps x 256 radix-select bins; each consumer's pool counts of its 64
#: rows; the barriers; the base's alignment slack
HIST_BYTES, COUNT_BYTES = 4 * CONSUMERS * 256 * 4, CONSUMERS * BLOCK_Q * 4
BARRIER_BYTES, ALIGN_SLACK = 8 * (1 + 2 * CONSUMERS * MAX_STAGES), 1024
#: the largest kp the select pass sorts in shared memory
SORT_SMEM_KEYS = 4096
#: every kernel of the library, in fused_topk_kernel_attributes' order
KERNELS = ("topk_scan_kernel", "topk_select_kernel", "topk_split_kernel<128>",
           "topk_split_kernel<0>", "topk_merge_kernel<128>", "topk_merge_kernel<0>",
           "topk_stream_kernel")
#: the kernels of bf16 inputs (the Hopper path)
BF16_KERNELS = ("topk_scan_kernel", "topk_select_kernel", "topk_stream_kernel")
PATHS = ("hopper", "fp32", "fp32_widened")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _stage_bytes(layout: int) -> int:
    """A ring stage: an index chunk, and its query chunk when streamed."""
    return CHUNK_P + (CHUNK_Q if layout == STREAMED else 0)


def scan_smem_bytes(d: int, layout: int, stages: int, stage_keys: int) -> int:
    """Dynamic shared memory of one scan block: the query tile (ceil(d/64)
    chunks of 8 KB, two to a block of 8 KB when spread, none when
    streamed), two rings of ``stages`` stages (an index chunk of 16 KB, and
    a query chunk of 8 KB beside it when streamed), 8 warps' staging areas
    of ``stage_keys`` keys, the histograms, the pool counts, the barriers
    and 1 KB to align the base. The CPU tests hold the plan to it; a CUDA
    test holds it to the library's ``fused_topk_scan_smem_bytes``."""
    nc = -(-d // 64)
    q_bytes = {RESIDENT: nc, SPREAD: -(-nc // 2), STREAMED: 0}[layout] * CHUNK_Q
    return (q_bytes + CONSUMERS * stages * _stage_bytes(layout) + 4 * CONSUMERS * stage_keys * 8
            + HIST_BYTES + COUNT_BYTES + BARRIER_BYTES + ALIGN_SLACK)


def layout_plan(d: int, layout: int, k: int) -> Optional[Tuple[int, int, int]]:
    """(layout, stages, stage_keys) of the Hopper scan in this layout for
    rows of d bf16 and this k, or None where it does not fit SMEM_LIMIT.
    stage_keys: a row's pool (2 kp keys) when it is at most STAGE_KEYS_MAX
    and the staging still leaves two stages a ring, else 0 (pools cut in
    global memory). stages: of each ring, as many as the rest holds, up to
    MAX_STAGES, at least 2."""
    cap = 2 * state_pairs(k)
    for stage_keys in ((cap, 0) if cap <= STAGE_KEYS_MAX else (0,)):
        stages = min(MAX_STAGES, (SMEM_LIMIT - scan_smem_bytes(d, layout, 0, stage_keys))
                     // (CONSUMERS * _stage_bytes(layout)))
        if stages >= 2:
            return layout, stages, stage_keys
    return None


def scan_plan(d: int, k: int, n_q: int) -> Optional[Tuple[int, int, int]]:
    """(layout, stages, stage_keys) of the Hopper scan for rows of d bf16 (a
    multiple of 8), this k and n_q query rows (``layout_plan``), or None
    past STREAM_D_MAX: the query tile resident (RESIDENT; SPREAD for at most
    32 query rows, 8 to each warp, in half the tile) wherever that plan
    fits, else STREAMED."""
    if d > STREAM_D_MAX:
        return None
    resident = SPREAD if n_q <= BLOCK_Q // 2 else RESIDENT
    return layout_plan(d, resident, k) or layout_plan(d, STREAMED, k)


def path_of(dtype: torch.dtype, d: int, k: int) -> str:
    """The path (``PATHS``) a CUDA call with operands of this common dtype,
    rows of d and this k takes (any number of query rows)."""
    if dtype != torch.bfloat16:
        return "fp32"
    return "hopper" if scan_plan(-(-d // 8) * 8, k, BLOCK_Q) is not None else "fp32_widened"


#: the widest bf16 row the Hopper scan takes (a multiple of 64), and the
#: widest whose query tile stays resident at 64 query rows
HOPPER_D_MAX = max(d for d in range(64, 2 * STREAM_D_MAX + 1, 64)
                   if scan_plan(d, K_MAX, BLOCK_Q) is not None)
RESIDENT_D_MAX = max(d for d in range(64, HOPPER_D_MAX + 1, 64)
                     if scan_plan(d, K_MAX, BLOCK_Q)[0] == RESIDENT)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_topk_bf16_launch.argtypes = [ptr] * 8 + [i32] * 7 + [f32, i32, i32, i32, ptr]
    lib.fused_topk_bf16_launch.restype = i32
    lib.fused_topk_fp32_launch.argtypes = [ptr] * 9 + [i32] * 7 + [f32, i32, ptr]
    lib.fused_topk_fp32_launch.restype = i32
    lib.fused_topk_scan_smem_bytes.argtypes = [i32] * 4
    lib.fused_topk_scan_smem_bytes.restype = i32
    lib.fused_topk_kernel_attributes.argtypes = [i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.fused_topk_kernel_attributes.restype = i32
    lib.fused_topk_error_string.argtypes = [i32]
    lib.fused_topk_error_string.restype = ctypes.c_char_p
    for fn in ("fused_topk_kpad", "fused_topk_block_q", "fused_topk_block_n"):
        getattr(lib, fn).restype = i32
    if (lib.fused_topk_kpad(), lib.fused_topk_block_q(), lib.fused_topk_block_n()) != (
        SMEM_K, BLOCK_Q, BLOCK_N
    ):
        raise RuntimeError("fused_topk.cu and ops.py disagree on k_pad or tile sizes")
    return lib


def kernel_attributes(name: str) -> dict:
    """Registers a thread and local memory a thread (stack frame and spills:
    0 when ptxas spilled nothing) of one of ``KERNELS``, as the card reports
    them for the built library."""
    lib, regs, local = _library(), ctypes.c_int(), ctypes.c_int()
    err = lib.fused_topk_kernel_attributes(KERNELS.index(name), ctypes.byref(regs),
                                           ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"no attributes of {name}: {lib.fused_topk_error_string(err).decode()}")
    return {"registers": regs.value, "local_bytes": local.value}


def split_plan(n_q: int, n: int, sm_count: int, max_splits: Optional[int] = None
               ) -> Tuple[int, int]:
    """(splits, cols_per_split): the index is cut into column ranges, whole
    tiles each, so that query tiles x splits fills the SMs once (one block
    fits per SM on either path), and at most ``max_splits`` ranges. On an
    H100, more splits ran slower at both the serve and the eval shape with
    the fp32 path's design: each split pays its own warm-up of the per-row
    top-k, and the merge pass grows with the splits."""
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


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """t itself when TMA can read its rows in place (d a multiple of 8 bf16,
    a 16-byte aligned base), else a copy: d padded with zero columns to a
    multiple of 8, or a plain copy of an unaligned view."""
    if t.shape[1] % 8:
        return F.pad(t, (0, 8 - t.shape[1] % 8))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _raise(lib, err):
    if err != 0:
        raise RuntimeError(
            f"fused_topk launch failed: {lib.fused_topk_error_string(err).decode()}"
        )


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
    path = path_of(ct, d, k)
    if path == "fp32_widened":
        q, index = q.float(), index.float()
    # row states in global memory: 2 * kp slots of 8 bytes for each split
    # block's BLOCK_Q rows (bf16: for each of its consumer warpgroups)
    global_state = kp != SMEM_K or path == "hopper"
    lists = CONSUMERS if path == "hopper" else 1
    per_split = q_tiles * BLOCK_Q * 2 * kp * 8 * lists
    max_splits = max(1, STATE_BYTES // per_split) if global_state else None
    splits, cols_per_split = split_plan(n_q, n, sms, max_splits)
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=dev)
    mask = None if col_valid is None else col_valid.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_state = q_tiles * splits * lists * BLOCK_Q * 2 * kp
    with torch.cuda.device(dev):
        if path == "hopper":
            layout, stages, stage_keys = scan_plan(-(-d // 8) * 8, k, n_q)
            q, index = _tma_ready(q), _tma_ready(index)
            cand = torch.empty((n_q, splits, k), dtype=torch.int64, device=dev)
            pools = torch.empty((n_state,), dtype=torch.int64, device=dev)
            scratch = (torch.empty((n_q, kp), dtype=torch.int64, device=dev)
                       if kp > SORT_SMEM_KEYS else None)
            err = lib.fused_topk_bf16_launch(
                q.data_ptr(), index.data_ptr(), mask, cand.data_ptr(), out_s.data_ptr(),
                out_i.data_ptr(), pools.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                n_q, n, q.shape[1], k, kp, splits, cols_per_split, float(inv_tau),
                stages, stage_keys, layout, stream,
            )
        else:
            cand_s = torch.empty((n_q, splits, k), dtype=torch.float32, device=dev)
            cand_i = torch.empty((n_q, splits, k), dtype=torch.int32, device=dev)
            state_s = state_i = None
            if global_state:
                state_s = torch.empty((n_state,), dtype=torch.float32, device=dev)
                state_i = torch.empty((n_state,), dtype=torch.int32, device=dev)
            # 16-byte vector loads need whole 16-byte rows and aligned bases
            vec = int(d % 4 == 0 and q.data_ptr() % 16 == 0 and index.data_ptr() % 16 == 0)
            err = lib.fused_topk_fp32_launch(
                q.data_ptr(), index.data_ptr(), mask,
                cand_s.data_ptr(), cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                None if state_s is None else state_s.data_ptr(),
                None if state_i is None else state_i.data_ptr(),
                n_q, n, d, k, kp, splits, cols_per_split, float(inv_tau), vec, stream,
            )
    _raise(lib, err)
    fused_topk.launches += 1
    fused_topk.paths[path] += 1
    return out_s, out_i


def reset_launches() -> None:
    """Set the launch count and every path's count to 0."""
    fused_topk.launches = 0
    fused_topk.paths = dict.fromkeys(PATHS, 0)


fused_topk.launches = 0
fused_topk.paths = dict.fromkeys(PATHS, 0)
