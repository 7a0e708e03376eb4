"""Wrapper of the embedding-bag CUDA kernel (csrc/embedding_bag.cu), as
``repro.kernels.embedding_bag.ops``.

``embedding_bag(table, indices, bag_ids, n_bags)`` is a
``torch.autograd.Function``: (n_bags, D) bag sums in the table's dtype, 0
for bags with no lookups. Its forward is the kernel for CUDA tensors (built
from source at its first launch; it launches or raises) and the plain
version (ref.py) for CPU tensors. Its backward, as the JAX package's, is not
a kernel: ``g[bag_ids]`` scattered into a zero (V, D) gradient with
``index_add_``, which adds with atomics on the card, so the order of each
row's sums varies from run to run. Indices and bag ids take no gradient;
int32 and int64 are taken and cast to int32, as JAX casts them, and a
strided view of ids is copied to a dense one (the kernel reads dense
arrays). The JAX op's ``interpret`` argument has no meaning here and is not
taken.

``bag_ids`` must be sorted non-decreasing: the caller's contract, as in JAX.
The card path does not check it (a check would cost a host sync); unsorted
ids give wrong sums there, never a read out of bounds. Indices must lie in
[0, V): on the card a row outside adds nothing, the plain version raises.

``embedding_bag.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

NAME = "embedding_bag"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INDEX_DTYPES = (torch.int32, torch.int64)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.embedding_bag_launch.argtypes = [ptr] * 5 + [i64] + [i32] * 5 + [ptr]
    lib.embedding_bag_launch.restype = ctypes.c_int
    lib.embedding_bag_error_string.argtypes = [ctypes.c_int]
    lib.embedding_bag_error_string.restype = ctypes.c_char_p
    return lib


def _check(table, indices, bag_ids, n_bags) -> None:
    if table.dim() != 2 or min(table.shape) < 1:
        raise ValueError(f"need a (V, D) table; got {tuple(table.shape)}")
    if table.dtype not in _DTYPE_CODES:
        raise TypeError(f"table must be float32 or bfloat16; got {table.dtype}")
    if indices.dim() != 1 or bag_ids.shape != indices.shape:
        raise ValueError(
            f"need indices and bag_ids of one shape (L,); got {tuple(indices.shape)}, "
            f"{tuple(bag_ids.shape)}"
        )
    for name, t in (("indices", indices), ("bag_ids", bag_ids)):
        if t.dtype not in _INDEX_DTYPES:
            raise TypeError(f"{name} must be int32 or int64; got {t.dtype}")
        if t.device != table.device:
            raise ValueError(f"{name} on {t.device}, table on {table.device}")
    if n_bags < 0:
        raise ValueError(f"n_bags must be >= 0; got {n_bags}")
    if indices.numel() >= 2**31:
        raise ValueError(f"at most 2^31 - 1 lookups; got {indices.numel()}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous (row-major)")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"embedding_bag runs on cuda or cpu tensors, not {table.device}")


def word_bytes(d: int, itemsize: int, *ptrs: int) -> int:
    """The widest load (16, 8, 4 or 2 bytes, at least one element) that
    divides a row's bytes and every base address."""
    for w in (16, 8, 4, 2):
        if w >= itemsize and (d * itemsize) % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    raise ValueError(f"no load width fits rows of {d} x {itemsize} bytes")


def _launch(table, indices, bag_ids, n_bags: int) -> torch.Tensor:
    """One launch of the kernel: (n_bags, D) in the table's dtype."""
    lib = _library()
    v, d = table.shape
    dev = table.device
    out = torch.empty((n_bags, d), dtype=table.dtype, device=dev)
    offsets = torch.empty((n_bags + 1,), dtype=torch.int32, device=dev)
    width = word_bytes(d, table.element_size(), table.data_ptr(), out.data_ptr())
    with torch.cuda.device(dev):
        err = lib.embedding_bag_launch(
            table.data_ptr(), indices.data_ptr(), bag_ids.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), indices.numel(), n_bags, v, d, _DTYPE_CODES[table.dtype],
            width, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"embedding_bag launch failed: {lib.embedding_bag_error_string(err).decode()}"
        )
    embedding_bag.launches += 1
    return out


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, indices, bag_ids, n_bags):
        if table.device.type == "cpu":
            out = embedding_bag_ref(table, indices, bag_ids, n_bags)
        else:
            out = _launch(table, indices, bag_ids, n_bags)
        ctx.save_for_backward(indices, bag_ids)
        ctx.table_shape = table.shape
        return out

    @staticmethod
    def backward(ctx, g):
        # d table[r] = sum of g[bag_ids[i]] over the lookups i with indices[i] == r
        indices, bag_ids = ctx.saved_tensors
        dtable = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        dtable.index_add_(0, indices, g[bag_ids])
        return dtable, None, None, None


def embedding_bag(
    table: torch.Tensor,     # (V, D) float32 | bfloat16
    indices: torch.Tensor,   # (L,) int32 | int64 rows to gather
    bag_ids: torch.Tensor,   # (L,) int32 | int64, sorted non-decreasing
    n_bags: int,
) -> torch.Tensor:
    """(n_bags, D) bag sums; differentiable w.r.t. the table."""
    _check(table, indices, bag_ids, n_bags)
    indices = indices.to(torch.int32).contiguous()
    bag_ids = bag_ids.to(torch.int32).contiguous()
    return _EmbeddingBag.apply(table, indices, bag_ids, int(n_bags))


embedding_bag.launches = 0
