"""Wrappers of the fused InfoNCE CUDA kernels (csrc/fused_infonce.cu).

``fused_infonce_stats(q, p, labels, col_valid, inv_tau)`` returns per-row
``(lse, pos, amax)``, fp32, and is differentiable w.r.t. q and p (a
``torch.autograd.Function``): its backward launches the dQ kernel only when
q needs a gradient and the dP kernel only when p does. ``amax`` is
metrics-only (marked non-differentiable; its cotangent is dropped, as the
JAX ``_stats_bwd`` drops it). The (M, N) score matrix never reaches device
memory in either direction.

Three entry points, one per TPU kernel, each with a launch count:
``fused_infonce_fwd.launches``, ``fused_infonce_dq.launches``,
``fused_infonce_dp.launches``. On CPU tensors they are the plain version
(ref.py); on CUDA tensors they launch their kernel or raise. Each kernel is
built from source at its first launch.

The three count the path of each call in ``fused_infonce_fwd.paths``,
``fused_infonce_dq.paths`` and ``fused_infonce_dp.paths`` (``path_of``):

- ``"hopper"``: bf16 operands with d a multiple of 8 up to ``HOPPER_D_MAX``
  (TMA reads rows of a multiple of 16 bytes; a base that is not 16-byte
  aligned is copied first). The forward, at any M: each block takes one
  tile of 64 passages and writes each of its query rows' partial (max,
  sum-exp, pos) over that tile, taken from the score registers; a second
  kernel merges each row's partials (launched as a programmatic dependent,
  so its launch overlaps the first). Up to ``SMALL_M`` rows one block per
  tile reads its P tile once by TMA, the scores on ``wgmma`` with the
  queries as its N side; above, ``fwd_plan`` splits the rows into groups
  so that (passage tiles x groups) blocks fill the card once (4 groups of
  512 at the 2048 query-bank rows: 132 blocks), each streaming P and Q
  chunks through a ring to two ``wgmma`` warpgroups. dQ and dP at up to
  ``SMALL_M`` query rows (a contaccum chunk's 8 local queries) take one
  block per 64 passages: the block's P tile is read once by TMA, every
  d-chunk in flight, scores and both products on ``wgmma`` with the queries
  as its N side; dQ's 33 fp32 partials are summed in block order by a
  second, small kernel. dP at more rows (the 2048 query-bank rows) takes
  clusters of ``dp_plan(m)[0]`` blocks on one tile of 64 passages: each rank
  turns the scores of its query rows into bf16 coefficients in registers
  and keeps them in shared memory, then computes its share of d for every
  query row, reading the other ranks' coefficients through distributed
  shared memory; one launch, no fp32 partial in device memory. Past
  ``SMALL_D_MAX`` (one block of the small kernels: 16 d-chunks of 64; the
  LM retriever's d = 2048): the many-row forward and the cluster dP as
  they are (nothing in their plans depends on d); at up to ``SMALL_M``
  rows the forward, dQ and dP take clusters of ``small_ranks(d)`` blocks
  on each tile of 64 passages, each rank on its share of the d-chunks (at
  most 16), the partial scores summed through distributed shared memory in
  rank order; each rank then writes its columns of dP or of dQ's partial,
  and rank 0 the forward's partials. On an H100 the bounds are the bytes of
  P at the local rows (1-2 us at d = 768) and the tensor cores at the bank
  rows (6.6 us forward, 13 us dP); the local-row kernels are held back by
  latency (33 or 66 blocks), the bank-row kernels by each block's stream of
  Q and P from L2 (PERF.md).
- ``"wmma"``: other bf16 shapes (d not a multiple of 8 or above
  ``HOPPER_D_MAX``, dQ above ``SMALL_M`` rows, dP above ``MAX_RANKS *
  RANK_ROWS`` rows): the first kernels (``wmma`` tiles, synchronous loads,
  fp32 partials and a merge or reduce kernel when the long axis is split).
  ``stats_on_path`` runs the forward and ``grad_on_path`` a gradient on a
  path named by the caller, to time one route beside another.
- ``"tf32x3"``: fp32 operands (or bf16 with fp32) with d a multiple of 4
  (TMA's 16-byte rows), the forward up to ``TF32X3_FWD_D_MAX``, dQ and dP
  up to ``TF32X3_D_MAX``: every product on ``wgmma`` in 3xTF32 (q and p
  split once a call into tf32 hi and lo planes, each product hi hi + hi lo
  + lo hi summed in fp32: fp32-grade products on the tensor cores). The
  forward: a block per tile of ``TF32X3_FWD_ROWS`` query rows x
  ``TF32X3_FWD_PASSAGES`` passages (no cluster: its output is three floats
  a row) streams d through a ring of 32-column chunks, each 16 columns into
  a fresh accumulator added to the score in fp32, and writes its rows'
  partial (max, sum-exp, pos) from the score registers, merged as the bf16
  forward's (blocks in groups of ``TF32X3_FWD_GROUP`` query tiles, each
  walking every passage tile, for L2 reuse). dQ and dP: a cluster of
  ``tf32x3_ranks(d)`` blocks
  (4 at d = 768) owns a tile of ``TF32X3_TILE`` output rows, rank r on 192
  columns of d, its accumulators in registers over every contraction row;
  the ranks sum their partial scores through distributed shared memory a
  step of ``TF32X3_STEP`` contraction rows; coefficients from the score
  registers. The contraction axis is split (``tf32x3_split_plan``: fp32
  partials summed in split order by the reduce kernel) only where the
  output tiles cannot fill the card.
- ``"fp32"``: the fp32 forward, dQ and dP at other d: CUDA-core FMAs, no
  TF32 (the first kernels; ``stats_on_path("fp32", ...)`` and
  ``grad_on_path(..., "fp32", ...)`` run them at any d, to time them beside
  ``"tf32x3"``).

A block whose 64 passages are all masked computes nothing: dQ and dP write
zeros (what the coefficient gives there); the forward writes the partial
that computing the tile would give (max -1e30, sum-exp the count of its
in-range columns, pos -1e30 where the label lies in it), so a fully masked
row keeps the finite lse ~ -1e30.

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

# The Hopper kernels' plan (csrc/fused_infonce.cu, namespace hp):
#: query rows up to which dQ and dP take the small kernel (wgmma's N side)
SMALL_M = 16
#: passages a Hopper block takes (wgmma's 64-row side)
PASSAGE_TILE = 64
#: the cluster kernel's pass-1 query tile (its two consumer warpgroups x
#: 128), and the most query rows one rank of a cluster keeps coefficients for
PASS1_TILE, RANK_ROWS = 256, 768
#: the portable cluster size
MAX_RANKS = 8
#: the widest bf16 row one block of the small kernels (forward, dQ, dP at up
#: to SMALL_M rows) holds: 16 d-chunks of 64
SMALL_D_MAX = 1024
#: the widest bf16 row the Hopper forward, dQ and dP take: at up to SMALL_M
#: rows a cluster of at most MAX_RANKS blocks, each on at most 16 d-chunks
#: (the many-row forward and the cluster dP take any d)
HOPPER_D_MAX = MAX_RANKS * SMALL_D_MAX
PATHS = ("hopper", "wmma", "fp32", "tf32x3")
# The 3xTF32 kernels' plan (csrc/fused_infonce.cu, namespace tx):
#: output rows a cluster takes (the scores' wgmma M), and contraction rows a
#: step (the scores' N)
TF32X3_TILE, TF32X3_STEP = 64, 32
#: columns of d one rank of a cluster holds: 3 M-tiles of 64
TF32X3_RANK_COLS = 192
#: the widest fp32 row the 3xTF32 dQ and dP take: a cluster of MAX_RANKS
TF32X3_D_MAX = MAX_RANKS * TF32X3_RANK_COLS
# The 3xTF32 forward's plan (csrc tx::infonce_tf32x3_fwd_kernel):
#: query rows and passages a block takes (two warpgroups of wgmma's 64 rows;
#: wgmma's N)
TF32X3_FWD_ROWS, TF32X3_FWD_PASSAGES = 128, 128
#: query tiles a group of blocks takes, each group walking every passage tile
TF32X3_FWD_GROUP = 8
#: the widest fp32 row the 3xTF32 forward takes (it streams d; as the bf16 forward)
TF32X3_FWD_D_MAX = HOPPER_D_MAX
#: every kernel of the library, in fused_infonce_kernel_attributes' order
KERNELS = ("infonce_fwd_kernel<bf16>", "infonce_fwd_kernel<fp32>", "infonce_stats_merge_kernel",
           "infonce_dq_kernel<bf16>", "infonce_dq_kernel<fp32>", "infonce_dp_kernel<bf16>",
           "infonce_dp_kernel<fp32>", "infonce_grad_reduce_kernel<bf16>",
           "infonce_grad_reduce_kernel<fp32>", "infonce_dp_cluster_kernel",
           "infonce_small_kernel<dq>", "infonce_small_kernel<dp>", "infonce_fwd_small_kernel",
           "infonce_fwd_rows_kernel", "infonce_tf32x3_kernel<dq>", "infonce_tf32x3_kernel<dp>",
           "infonce_tf32_split_kernel", "infonce_tf32x3_fwd_kernel", "infonce_dp_split_kernel",
           "infonce_fwd_split_kernel", "infonce_dq_split_kernel")
#: the kernels of the "tf32x3" path (the xdev path's fp32 forward, dQ and
#: dP): the hi/lo split of q and p, the forward's tiles and their merge, the
#: products, the reduce where the contraction axis is split
TF32X3_KERNELS = ("infonce_tf32_split_kernel", "infonce_tf32x3_fwd_kernel",
                  "infonce_stats_merge_kernel", "infonce_tf32x3_kernel<dq>",
                  "infonce_tf32x3_kernel<dp>", "infonce_grad_reduce_kernel<fp32>")
#: the kernels the train paths' forward, dQ and dP run (bf16, Hopper path;
#: the split kernels at the LM retriever's local rows)
HOPPER_KERNELS = ("infonce_fwd_small_kernel", "infonce_fwd_rows_kernel",
                  "infonce_stats_merge_kernel", "infonce_dp_cluster_kernel",
                  "infonce_small_kernel<dq>", "infonce_small_kernel<dp>",
                  "infonce_grad_reduce_kernel<bf16>", "infonce_dp_split_kernel",
                  "infonce_fwd_split_kernel", "infonce_dq_split_kernel")
#: SMs of an H100 SXM: the card the forward's default row plan fills
H100_SMS = 132

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
    lib.fused_infonce_dp_hopper_launch.argtypes = [ptr] * 8 + [i32] * 5 + [ctypes.c_float, ptr]
    lib.fused_infonce_dq_hopper_launch.argtypes = [ptr] * 9 + [i32] * 4 + [ctypes.c_float, ptr]
    lib.fused_infonce_fwd_hopper_launch.argtypes = [ptr] * 8 + [i32] * 5 + [ctypes.c_float, ptr]
    for fn in (lib.fused_infonce_fwd_launch, lib.fused_infonce_dq_launch,
               lib.fused_infonce_dp_launch, lib.fused_infonce_dp_hopper_launch,
               lib.fused_infonce_dq_hopper_launch, lib.fused_infonce_fwd_hopper_launch):
        fn.restype = ctypes.c_int
    lib.fused_infonce_tf32x3_launch.argtypes = [i32] + [ptr] * 11 + [i32] * 6 + [ctypes.c_float, ptr]
    lib.fused_infonce_fwd_tf32x3_launch.argtypes = [ptr] * 10 + [i32] * 3 + [ctypes.c_float, ptr]
    for fn in (lib.fused_infonce_tf32x3_launch, lib.fused_infonce_fwd_tf32x3_launch):
        fn.restype = ctypes.c_int
    lib.fused_infonce_tf32x3_max_clusters.argtypes = [i32, i32]
    lib.fused_infonce_tf32x3_max_clusters.restype = ctypes.c_int
    for fn in ("fused_infonce_tf32x3_tile", "fused_infonce_tf32x3_step",
               "fused_infonce_tf32x3_rank_cols", "fused_infonce_tf32x3_smem"):
        getattr(lib, fn).restype = ctypes.c_int
    if (lib.fused_infonce_tf32x3_tile(), lib.fused_infonce_tf32x3_step(),
            lib.fused_infonce_tf32x3_rank_cols(), lib.fused_infonce_tf32x3_smem()) != (
            TF32X3_TILE, TF32X3_STEP, TF32X3_RANK_COLS, tf32x3_smem()):
        raise RuntimeError("fused_infonce.cu and ops.py disagree on the 3xTF32 plan")
    plan = ("rows", "passages", "group", "smem", "d_max")
    for fn in plan:
        getattr(lib, f"fused_infonce_tf32x3_fwd_{fn}").restype = ctypes.c_int
    if tuple(getattr(lib, f"fused_infonce_tf32x3_fwd_{fn}")() for fn in plan) != (
            TF32X3_FWD_ROWS, TF32X3_FWD_PASSAGES, TF32X3_FWD_GROUP, tf32x3_fwd_smem(),
            TF32X3_FWD_D_MAX):
        raise RuntimeError("fused_infonce.cu and ops.py disagree on the 3xTF32 forward's plan")
    lib.fused_infonce_dp_max_clusters.argtypes = [i32]
    lib.fused_infonce_kernel_attributes.argtypes = [i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    for fn in (lib.fused_infonce_dp_max_clusters, lib.fused_infonce_kernel_attributes):
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


def dp_plan(m: int) -> Tuple[int, int]:
    """(ranks, rq) of the cluster kernel at m query rows: clusters of
    ``ranks`` blocks, rank r holding the coefficients of rows [r rq,
    (r + 1) rq), rq a multiple of PASS1_TILE up to RANK_ROWS, every rank
    with at least one row. At m = 2048: 3 ranks of 768 rows, so the 33
    passage tiles of a contaccum_bf16 chunk give 33 clusters of 3 blocks:
    an H100 SXM runs 39 such clusters at once, but only 30 of 4
    (cudaOccupancyMaxActiveClusters; ``dp_max_clusters``), so 4 ranks of
    512 rows would take two waves."""
    if not SMALL_M < m <= MAX_RANKS * RANK_ROWS:
        raise ValueError(f"the cluster dP kernel takes {SMALL_M} < M <= {MAX_RANKS * RANK_ROWS}")
    ranks = -(-m // RANK_ROWS)
    rq = -(-(-(-m // ranks)) // PASS1_TILE) * PASS1_TILE
    return -(-m // rq), rq


def small_ranks(d: int) -> int:
    """Blocks a passage tile of the Hopper forward, dQ and dP at up to
    SMALL_M query rows: 1 (the small kernels) up to SMALL_D_MAX, else a
    cluster of the split kernels of as many as keep each rank's share of
    the d-chunks at 16 or fewer (2 at d = 2048, 3 at 2560)."""
    if d > HOPPER_D_MAX:
        raise ValueError(f"the Hopper kernels take d <= {HOPPER_D_MAX}")
    return max(1, -(-d // SMALL_D_MAX))


def fwd_plan(m: int, n: int, sm_count: int = H100_SMS) -> int:
    """Query rows a block of the forward's many-row kernel takes (m >
    SMALL_M): a multiple of PASS1_TILE, the rows split into as many groups
    as let (passage tiles x groups) blocks fill the SMs once, and no more
    groups than tiles of PASS1_TILE rows. At a contaccum_bf16 chunk's bank
    rows (m = 2048, 33 passage tiles): 4 groups of 512 rows, 132 blocks."""
    if m <= SMALL_M:
        raise ValueError(f"the many-row forward takes M > {SMALL_M}")
    q_tiles = -(-m // PASS1_TILE)
    groups = max(1, min(q_tiles, sm_count // -(-n // PASSAGE_TILE)))
    return -(-q_tiles // groups) * PASS1_TILE


def hopper_blocks(kind: str, m: int, n: int, sm_count: int = H100_SMS, d: int = 0) -> int:
    """Blocks of the Hopper kernel that a forward (kind "fwd"), dQ ("dq")
    or dP ("dp") call of m query rows and n passages of d columns launches
    (the merge and reduce kernels aside); the forward's row groups as on a
    card of ``sm_count`` SMs."""
    tiles = -(-n // PASSAGE_TILE)
    if m <= SMALL_M:
        return tiles * small_ranks(d)
    if kind == "dq":
        return tiles
    if kind == "fwd":
        return tiles * -(-m // fwd_plan(m, n, sm_count))
    return tiles * dp_plan(m)[0]


def tf32x3_ranks(d: int) -> int:
    """Blocks of a 3xTF32 cluster at rows of d: as many as give each rank
    at most TF32X3_RANK_COLS columns (4 at d = 768, 1 up to 192)."""
    if d % 4 or not 0 < d <= TF32X3_D_MAX:
        raise ValueError(f"the 3xTF32 kernels take d a multiple of 4 up to {TF32X3_D_MAX}")
    return -(-d // TF32X3_RANK_COLS)


def tf32x3_split_plan(x_tiles: int, y_steps: int, max_clusters: int) -> Tuple[int, int]:
    """(splits, steps_per_split) of the contraction axis (y_steps steps of
    TF32X3_STEP rows) for x_tiles output tiles, on a card that runs
    max_clusters clusters at once: 1 split unless the output tiles leave
    half the clusters idle, else as many as fill them (the 32 local queries'
    dQ: 1 output tile, 258 passage steps on 30 clusters of 4: 29 splits of
    9 steps, the last of 6)."""
    want = max(1, min(y_steps, max_clusters // x_tiles))
    per = -(-y_steps // want)
    return -(-y_steps // per), per


def tf32x3_smem() -> int:
    """Dynamic shared memory of a 3xTF32 block (csrc tx::SMEM): X's hi and
    lo boxes (2 x 6 of 64 rows x 32 fp32, 8 KB each), two stages of a step's
    Y (2 x 6 boxes of 32 rows, 4 KB each), C as hi and lo (2 boxes of 64
    rows), two exchange buffers of 64 x 32 partial scores (8 KB), two
    stages of the step's 32 queries' values, 3 mbarriers and 1 KB of slack
    to align the base."""
    x_boxes, y_boxes = 2 * 6, 2 * 2 * 6
    return (x_boxes * TF32X3_TILE * 128 + y_boxes * TF32X3_STEP * 128 + 2 * TF32X3_TILE * 128
            + 2 * TF32X3_TILE * TF32X3_STEP * 4 + 2 * 4 * TF32X3_STEP * 4 + 8 * 3 + 1024)


def tf32x3_fwd_smem() -> int:
    """Dynamic shared memory of a 3xTF32 forward block (csrc tx::FSMEM):
    3 stages of a 32-column chunk's q hi, q lo, p hi and p lo boxes (128
    rows x 128 bytes, 16 KB each), a full and an empty barrier a stage, and
    1 KB of slack to align the base."""
    stages, boxes = 3, 4
    return stages * boxes * TF32X3_FWD_ROWS * 128 + 8 * 2 * stages + 1024


def tf32x3_fwd_tiles(m: int, n: int, d: int) -> Tuple[int, int]:
    """(query tiles, passage tiles) of the 3xTF32 forward at m query rows,
    n passages and rows of d: a block each pair; raises where it does not
    take d (a multiple of 4 up to TF32X3_FWD_D_MAX)."""
    if d % 4 or not 0 < d <= TF32X3_FWD_D_MAX:
        raise ValueError(f"the 3xTF32 forward takes d a multiple of 4 up to {TF32X3_FWD_D_MAX}")
    return -(-m // TF32X3_FWD_ROWS), -(-n // TF32X3_FWD_PASSAGES)


@functools.cache
def _tf32x3_max_clusters(device_index: int, which: str, ranks: int) -> int:
    lib = _library()
    with torch.cuda.device(device_index):
        n = lib.fused_infonce_tf32x3_max_clusters(int(which == "dq"), ranks)
    if n <= 0:
        _raise_on(-n if n < 0 else 1, "cudaOccupancyMaxActiveClusters (3xTF32)", lib)
    return n


def tf32x3_max_clusters(which: str, ranks: int, device=None) -> int:
    """The most clusters of ``ranks`` blocks of the 3xTF32 dQ (``which``
    "dq") or dP kernel the device runs at once."""
    return _tf32x3_max_clusters(torch.device(device or "cuda").index or 0, which, ranks)


def path_of(kind: str, dtype: torch.dtype, m: int, d: int) -> str:
    """The path (``PATHS``) a CUDA forward (kind "fwd"), dQ ("dq") or dP
    ("dp") call takes with operands of this common dtype, m query rows and
    rows of d. The fp32 forward takes "tf32x3" at every such shape, also
    where one side fits a tile and the CUDA-core kernel is a little faster
    (PERF.md): the scores of a (row, passage) pair then come from one
    arithmetic whatever the call's other rows and columns, so the ring's
    column chunks give the all-gather program's scores."""
    if dtype != torch.bfloat16:
        d_max = TF32X3_FWD_D_MAX if kind == "fwd" else TF32X3_D_MAX
        return "tf32x3" if d % 4 == 0 and d <= d_max else "fp32"
    if d % 8 or d > HOPPER_D_MAX:
        return "wmma"
    if kind == "fwd":
        return "hopper"
    if kind == "dq":
        return "hopper" if m <= SMALL_M else "wmma"
    return "hopper" if m <= MAX_RANKS * RANK_ROWS else "wmma"


def kernel_attributes(name: str) -> dict:
    """Registers a thread and local memory a thread (stack frame and spills:
    0 when ptxas spilled nothing) of one of ``KERNELS``, as the card reports
    them for the built library."""
    lib, regs, local = _library(), ctypes.c_int(), ctypes.c_int()
    err = lib.fused_infonce_kernel_attributes(KERNELS.index(name), ctypes.byref(regs),
                                              ctypes.byref(local))
    _raise_on(err, f"attributes of {name}", lib)
    return {"registers": regs.value, "local_bytes": local.value}


def dp_max_clusters(ranks: int) -> int:
    """The most clusters of ``ranks`` cluster-kernel blocks the current device
    runs at once (cudaOccupancyMaxActiveClusters)."""
    lib = _library()
    n = lib.fused_infonce_dp_max_clusters(ranks)
    if n < 0:
        _raise_on(-n, "cudaOccupancyMaxActiveClusters", lib)
    return n


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """t itself when TMA can read it in place (a 16-byte aligned base; the
    Hopper path takes only rows of a multiple of 16 bytes), else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
        raise RuntimeError(
            f"{what} launch failed: {lib.fused_infonce_error_string(err).decode()} ({err})")


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
    stats, path = _fwd(q, p, labels, col_valid, inv_tau)
    fused_infonce_fwd.launches += 1
    fused_infonce_fwd.paths[path] += 1
    return stats


def _fwd(q, p, labels, col_valid, inv_tau, path=None):
    """((lse, pos, amax), the path it took): ``path_of``'s, or ``path`` where
    given."""
    lib = _library()
    q, p, ct, vec = _operands(q, p)
    m, d = q.shape
    n = p.shape[0]
    dev = q.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    path = path or path_of("fwd", ct, m, d)
    mask = None if col_valid is None else col_valid.data_ptr()
    lse, pos, amax = (torch.empty((m,), dtype=STATS_DTYPE, device=dev) for _ in range(3))
    if path == "tf32x3":
        q, p = _tma_ready(q), _tma_ready(p)
        part = torch.empty((3, m, tf32x3_fwd_tiles(m, n, d)[1]), dtype=STATS_DTYPE, device=dev)
        # q and p as their tf32 hi and lo planes, written by the launch
        q_planes = torch.empty((2, m, d), dtype=STATS_DTYPE, device=dev)
        p_planes = torch.empty((2, n, d), dtype=STATS_DTYPE, device=dev)
        with torch.cuda.device(dev):
            err = lib.fused_infonce_fwd_tf32x3_launch(
                q.data_ptr(), p.data_ptr(), labels.data_ptr(), mask,
                lse.data_ptr(), pos.data_ptr(), amax.data_ptr(), part.data_ptr(),
                q_planes.data_ptr(), p_planes.data_ptr(), m, n, d, float(inv_tau), _stream(dev),
            )
    elif path == "hopper":
        q, p = _tma_ready(q), _tma_ready(p)
        part = torch.empty((3, m, -(-n // PASSAGE_TILE)), dtype=STATS_DTYPE, device=dev)
        rq, ranks = (fwd_plan(m, n, sms), 0) if m > SMALL_M else (0, small_ranks(d))
        with torch.cuda.device(dev):
            err = lib.fused_infonce_fwd_hopper_launch(
                q.data_ptr(), p.data_ptr(), labels.data_ptr(), mask,
                lse.data_ptr(), pos.data_ptr(), amax.data_ptr(), part.data_ptr(),
                m, n, d, rq, ranks, float(inv_tau), _stream(dev),
            )
    else:
        splits, per = split_plan(-(-n // BLOCK_N), -(-m // BLOCK_M), sms)
        part = torch.empty((3, m, splits) if splits > 1 else (1,), dtype=STATS_DTYPE, device=dev)
        with torch.cuda.device(dev):
            err = lib.fused_infonce_fwd_launch(
                q.data_ptr(), p.data_ptr(), labels.data_ptr(), mask,
                lse.data_ptr(), pos.data_ptr(), amax.data_ptr(), part.data_ptr(),
                m, n, d, splits, per, float(inv_tau), _DTYPE_CODES[ct], vec, _stream(dev),
            )
    _raise_on(err, f"fused_infonce forward ({path})", lib)
    return (lse, pos, amax), path


def stats_on_path(path, q, p, labels, col_valid=None, inv_tau=1.0):
    """The forward's (lse, pos, amax) of CUDA operands through the kernels
    of ``path`` ("hopper" or "wmma" for bf16, "tf32x3" or "fp32" for fp32),
    whatever ``path_of`` picks: a route timed beside another in one run
    (``bench.py``, ``chip_smoke.py``); not counted in the launch counts.
    Raises where that path's kernel does not take the shape."""
    _check(q, p, labels, col_valid)
    bf16 = torch.promote_types(q.dtype, p.dtype) == torch.bfloat16
    routes = ("hopper", "wmma") if bf16 else ("tf32x3", "fp32")
    if q.device.type != "cuda" or path not in routes:
        raise ValueError(f"stats_on_path runs CUDA operands of this type on one of {routes}")
    if path == "tf32x3":
        tf32x3_fwd_tiles(q.shape[0], p.shape[0], q.shape[1])
    return _fwd(q, p, labels, col_valid, inv_tau, path)[0]


def _grad(which, q, p, labels, col_valid, lse, g_lse, g_pos, inv_tau, path=None):
    """(gradient in the operand type, the path it took): ``path_of``'s, or
    ``path`` where given."""
    lib = _library()
    q, p, ct, vec = _operands(q, p)
    m, d = q.shape
    n = p.shape[0]
    dev = q.device
    rows = m if which == "dq" else n
    out = torch.empty((rows, d), dtype=ct, device=dev)
    path = path or path_of(which, ct, m, d)
    mask = None if col_valid is None else col_valid.data_ptr()
    stats = (lse.data_ptr(), g_lse.data_ptr(), g_pos.data_ptr())
    if path == "hopper":
        q, p = _tma_ready(q), _tma_ready(p)
        with torch.cuda.device(dev):
            if which == "dq":
                partial = torch.empty((-(-n // PASSAGE_TILE), m, d), dtype=STATS_DTYPE, device=dev)
                err = lib.fused_infonce_dq_hopper_launch(
                    q.data_ptr(), p.data_ptr(), labels.data_ptr(), mask, *stats,
                    out.data_ptr(), partial.data_ptr(), m, n, d, small_ranks(d), float(inv_tau),
                    _stream(dev),
                )
            else:
                ranks, rq = dp_plan(m) if m > SMALL_M else (small_ranks(d), 0)
                err = lib.fused_infonce_dp_hopper_launch(
                    q.data_ptr(), p.data_ptr(), labels.data_ptr(), mask, *stats,
                    out.data_ptr(), m, n, d, ranks, rq, float(inv_tau), _stream(dev),
                )
        _raise_on(err, f"fused_infonce {which} (Hopper)", lib)
        return out, path
    if path == "tf32x3":
        q, p = _tma_ready(q), _tma_ready(p)
        ranks = tf32x3_ranks(d)
        x_rows, y_rows = (m, n) if which == "dq" else (n, m)
        splits, per = tf32x3_split_plan(-(-x_rows // TF32X3_TILE), -(-y_rows // TF32X3_STEP),
                                        tf32x3_max_clusters(which, ranks, dev))
        partial = torch.empty((splits, x_rows, d) if splits > 1 else (1,), dtype=STATS_DTYPE,
                              device=dev)
        # q and p as their tf32 hi and lo planes, written by the launch
        q_planes = torch.empty((2, m, d), dtype=STATS_DTYPE, device=dev)
        p_planes = torch.empty((2, n, d), dtype=STATS_DTYPE, device=dev)
        with torch.cuda.device(dev):
            err = lib.fused_infonce_tf32x3_launch(
                int(which == "dq"), q.data_ptr(), p.data_ptr(), labels.data_ptr(), mask, *stats,
                out.data_ptr(), partial.data_ptr(), q_planes.data_ptr(), p_planes.data_ptr(),
                m, n, d, ranks, splits, per, float(inv_tau), _stream(dev),
            )
        _raise_on(err, f"fused_infonce {which} (3xTF32)", lib)
        return out, path
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    m_tiles, n_tiles = -(-m // BLOCK_M), -(-n // BLOCK_N)
    if which == "dq":
        splits, per = split_plan(n_tiles, m_tiles, sms)
        launch = lib.fused_infonce_dq_launch
    else:
        splits, per = split_plan(m_tiles, n_tiles, sms)
        launch = lib.fused_infonce_dp_launch
    partial = torch.empty(
        (splits, rows, d) if splits > 1 else (1,), dtype=STATS_DTYPE, device=dev
    )
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(), p.data_ptr(), labels.data_ptr(), mask, *stats,
            out.data_ptr(), partial.data_ptr(),
            m, n, d, splits, per, float(inv_tau), _DTYPE_CODES[ct], vec, _stream(dev),
        )
    _raise_on(err, f"fused_infonce {which}", lib)
    return out, path


def grad_on_path(which, path, q, p, labels, col_valid, lse, g_lse, g_pos, inv_tau=1.0):
    """dQ (``which`` "dq") or dP ("dp") of CUDA operands through the kernels
    of ``path`` ("hopper" or "wmma" for bf16, "tf32x3" or "fp32" for fp32),
    whatever ``path_of`` picks,
    in the operand type: a route timed beside another in one run
    (``bench.py``, ``chip_smoke.py``); not counted in the launch counts.
    Raises where that path's kernel does not take the shape."""
    _check(q, p, labels, col_valid)
    _check_rows(q, lse=lse, g_lse=g_lse, g_pos=g_pos)
    if q.device.type != "cuda" or path not in PATHS:
        raise ValueError(f"grad_on_path runs CUDA operands on one of {PATHS}")
    return _grad(which, q, p, labels, col_valid, lse, g_lse, g_pos, inv_tau, path)[0]


def fused_infonce_dq(q, p, labels, col_valid, lse, g_lse, g_pos, inv_tau=1.0) -> torch.Tensor:
    """dQ (M, d) in q's type for the row cotangents (g_lse, g_pos) of the
    forward whose lse is given."""
    _check(q, p, labels, col_valid)
    _check_rows(q, lse=lse, g_lse=g_lse, g_pos=g_pos)
    if q.device.type == "cpu":
        return infonce_stats_vjp_ref(q, p, labels, col_valid, g_lse, g_pos, inv_tau=inv_tau)[0]
    out, path = _grad("dq", q, p, labels, col_valid, lse, g_lse, g_pos, inv_tau)
    fused_infonce_dq.launches += 1
    fused_infonce_dq.paths[path] += 1
    return out.to(q.dtype)


def fused_infonce_dp(q, p, labels, col_valid, lse, g_lse, g_pos, inv_tau=1.0) -> torch.Tensor:
    """dP (N, d) in p's type for the row cotangents (g_lse, g_pos)."""
    _check(q, p, labels, col_valid)
    _check_rows(q, lse=lse, g_lse=g_lse, g_pos=g_pos)
    if q.device.type == "cpu":
        return infonce_stats_vjp_ref(q, p, labels, col_valid, g_lse, g_pos, inv_tau=inv_tau)[1]
    out, path = _grad("dp", q, p, labels, col_valid, lse, g_lse, g_pos, inv_tau)
    fused_infonce_dp.launches += 1
    fused_infonce_dp.paths[path] += 1
    return out.to(p.dtype)


fused_infonce_fwd.launches = 0
fused_infonce_dq.launches = 0
fused_infonce_dp.launches = 0
fused_infonce_fwd.paths = dict.fromkeys(PATHS, 0)
fused_infonce_dq.paths = dict.fromkeys(PATHS, 0)
fused_infonce_dp.paths = dict.fromkeys(PATHS, 0)


def reset_launches() -> None:
    """Set the three launch counts and their path counts to 0."""
    fused_infonce_fwd.launches = fused_infonce_dq.launches = fused_infonce_dp.launches = 0
    fused_infonce_fwd.paths = dict.fromkeys(PATHS, 0)
    fused_infonce_dq.paths = dict.fromkeys(PATHS, 0)
    fused_infonce_dp.paths = dict.fromkeys(PATHS, 0)


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
