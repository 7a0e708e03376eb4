"""Search backends: how queries are scored against the index (the port of
``repro.retrieval.search``).

  * ``dense`` — blocked fp32 matmul + running top-k merge in plain PyTorch:
    never materialises the (Q, N) score matrix; the peak transient is the
    (Q, block) tile plus the running best.
  * ``fused`` — the hand-written CUDA kernel (kernels/fused_topk): QK^T tiles
    and the top-k in one kernel. On CPU tensors its wrapper runs the plain
    version.

Shared contract: scores fp32 whatever the input types, ids int32 local
column indices with ties to the lowest id, ``col_valid`` masks exactly, and
slots with no valid candidate are (``NEG_INF``, -1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Tuple, Union

import torch

from repro_torch.core.precision import NEG_INF, SCORE_DTYPE
from repro_torch.kernels.fused_topk.ops import fused_topk


class SearchBackend(Protocol):
    """Exact top-k of a query block against an index block."""

    name: str

    def topk(
        self,
        q_reps: torch.Tensor,     # (Q, d)
        index: torch.Tensor,      # (N, d)
        k: int,
        *,
        col_valid: Optional[torch.Tensor] = None,  # (N,) bool
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (scores (Q, k) fp32, ids (Q, k) int32, -1 = empty)."""
        ...


@dataclasses.dataclass(frozen=True)
class DenseSearchBackend:
    """Blocked exact top-k: one (Q, block) fp32 score tile at a time."""

    block: int = 65536

    name = "dense"

    def topk(self, q_reps, index, k, *, col_valid=None):
        n_q, n = q_reps.shape[0], index.shape[0]
        dev = q_reps.device
        best_s = torch.full((n_q, k), NEG_INF, dtype=SCORE_DTYPE, device=dev)
        best_i = torch.full((n_q, k), -1, dtype=torch.int32, device=dev)
        qf = q_reps.to(SCORE_DTYPE)
        for lo in range(0, n, self.block):
            blk = index[lo : lo + self.block].to(SCORE_DTYPE)
            s = qf @ blk.T
            ids = torch.arange(lo, lo + blk.shape[0], dtype=torch.int32, device=dev)
            if col_valid is not None:
                vld = col_valid[lo : lo + blk.shape[0]]
                s = s.masked_fill(~vld[None, :], NEG_INF)
                ids = torch.where(vld, ids, -1)
            # the running best comes first and holds only lower ids, so the
            # stable sort breaks ties toward the lowest id
            cat_s = torch.cat([best_s, s], dim=1)
            cat_i = torch.cat([best_i, ids[None, :].expand(n_q, -1)], dim=1)
            top_s, pos = torch.sort(cat_s, dim=1, descending=True, stable=True)
            best_s = top_s[:, :k]
            best_i = torch.gather(cat_i, 1, pos[:, :k])
        return best_s, best_i


@dataclasses.dataclass(frozen=True)
class FusedSearchBackend:
    """The CUDA QK^T + top-k kernel (kernels/fused_topk). ``block_q`` and
    ``block_n`` are the JAX kernel's Pallas tile sizes, taken so that one
    config drives both packages; the CUDA kernel keeps its own tiling
    (``fused_topk.ops.BLOCK_Q``/``BLOCK_N``) and ignores them."""

    block_q: int = 128
    block_n: int = 128

    name = "fused"

    def topk(self, q_reps, index, k, *, col_valid=None):
        return fused_topk(q_reps, index, k, col_valid=col_valid)


SEARCH_BACKENDS = {"dense": DenseSearchBackend, "fused": FusedSearchBackend}


def resolve_search_backend(
    spec: Union[None, str, SearchBackend] = None, **kwargs
) -> SearchBackend:
    """None -> dense; a registered name -> fresh instance (kwargs forwarded);
    an instance -> as is. Raises ValueError for unknown names."""
    if spec is None:
        return DenseSearchBackend(**kwargs)
    if isinstance(spec, str):
        if spec not in SEARCH_BACKENDS:
            raise ValueError(
                f"unknown search_impl {spec!r}; one of {sorted(SEARCH_BACKENDS)}"
            )
        return SEARCH_BACKENDS[spec](**kwargs)
    return spec
