"""Retriever: the inference surface of the port (``repro.retrieval.retriever``).

A ``Retriever`` composes the query and passage towers of a ``DualEncoder``
(the training params), an ``IndexStore`` (the corpus encoded in the policy's
index dtype) and a ``SearchBackend`` (dense blocked matmul + top-k, or the
fused CUDA kernel). Queries are encoded, cast to the compute dtype and scored
against the index; scores are fp32.

Sharded layout: the ranks of the default ``torch.distributed`` process group
(one a device) each hold a contiguous ``rows/D`` block of the index
(index.py) and score the queries against it alone; the index never moves.
Each rank's (Q, k) candidates, ids made global by its block's offset, are
all-gathered shard-major (``DistCtx.gather``) and ``merge_shard_candidates``
keeps the best k with a stable sort, so ties go to the lowest global id and
the ids and scores equal the replicated layout's bit for bit. The queries
are replicated: every rank encodes the whole batch. Under this layout
``build_index``, ``search``, ``search_reps`` and ``search_reps_tensors`` are
collective: every rank calls them in the same order with the same queries.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.compat import params_to_torch
from repro_torch.core.device import resolve_device
from repro_torch.core.dist import DistCtx
from repro_torch.core.precision import NEG_INF, PrecisionPolicy, resolve_precision
from repro_torch.core.types import DualEncoder
from repro_torch.retrieval.index import IndexStore, build_index_store
from repro_torch.retrieval.search import SearchBackend, resolve_search_backend


@dataclasses.dataclass(frozen=True)
class RetrieverConfig:
    """top_k: results per query. search_impl: 'dense' | 'fused'.
    index_layout: 'replicated' (every row on the device) or 'sharded' (a
    rows/D block on each rank of the default process group).
    precision: PrecisionPolicy or preset name: queries scored in
    ``compute_dtype``, index stored in ``bank_dtype``, scores fp32.
    index_dtype: a torch dtype that overrides the index's; None defers to
    the policy's ``bank_dtype``. score_block: dense backend column block.
    block_q/block_n: the JAX kernel's tile sizes, passed to the fused
    backend, which keeps its own tiling. encode_batch: corpus encode batch.
    dp_axis: the name of the axis the sharded layout shards over (the
    ``DistCtx`` axis over the default process group)."""

    top_k: int = 20
    search_impl: str = "dense"
    index_layout: str = "replicated"
    precision: Any = "fp32"
    index_dtype: Any = None
    score_block: int = 65536
    block_q: int = 128
    block_n: int = 128
    encode_batch: int = 256
    dp_axis: str = "data"

    def resolved_precision(self) -> PrecisionPolicy:
        return resolve_precision(self.precision)

    def resolved_index_dtype(self) -> torch.dtype:
        if self.index_dtype is not None:
            return self.index_dtype
        return self.resolved_precision().bank_dtype

    def resolve_backend(self) -> SearchBackend:
        if self.search_impl == "dense":
            return resolve_search_backend("dense", block=self.score_block)
        if self.search_impl == "fused":
            return resolve_search_backend(
                "fused", block_q=self.block_q, block_n=self.block_n
            )
        return resolve_search_backend(self.search_impl)


def make_dp_mesh(dp: int, axis: str = "data") -> DistCtx:
    """The serving counterpart of ``launch/train.py``'s --dp group: a
    ``DistCtx`` over the default process group, which must be initialized
    and hold ``dp`` ranks (JAX's ``make_dp_mesh`` returns a 1-D mesh of
    ``dp`` devices)."""
    ctx = DistCtx(axis)
    if ctx.device_count() != dp:
        raise ValueError(
            f"sharded index over {dp} ranks, but the process group has "
            f"{ctx.device_count()}"
        )
    return ctx


def merge_shard_candidates(
    scores: torch.Tensor, ids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best k of every shard's candidates: scores and ids (D, Q, k'),
    ids global, laid out (Q, D * k') shard-major and sorted stably, so ties
    go to the lower shard and, within a shard, to the lower id, as
    ``lax.top_k`` does in ``repro.retrieval.Retriever._merge_shards``
    (``torch.topk`` promises no order among ties). Slots whose score is
    ``NEG_INF`` get id -1."""
    d, q, kk = scores.shape
    cat_s = scores.permute(1, 0, 2).reshape(q, d * kk)
    cat_i = ids.permute(1, 0, 2).reshape(q, d * kk)
    top_s, pos = torch.sort(cat_s, dim=1, descending=True, stable=True)
    top_s = top_s[:, :k]
    top_i = torch.gather(cat_i, 1, pos[:, :k])
    return top_s, torch.where(top_s > NEG_INF / 2, top_i, -1)


def _rows_held(layout: Optional[Tuple[int, int]]) -> str:
    """(shards, shard), or None for every row, in words."""
    return "every row" if layout is None else f"block {layout[1]} of {layout[0]}"


class Retriever:
    """Built from a DualEncoder, its params (nested dicts of tensors or of
    numpy arrays, as ``serving.load_trained_params`` returns them; None to
    set later, as the miner does) and a RetrieverConfig. Runs on ``device``:
    CUDA unless ``device="cpu"`` (under the sharded layout, this rank's
    device). Token rows may be numpy arrays or tensors already on the
    device. Every call runs on the caller's current CUDA stream, and
    ``search`` syncs only that stream (its copy to the host). The sharded
    layout shards over ``mesh`` (``make_dp_mesh(D)``), by default a
    ``DistCtx(cfg.dp_axis)`` over the whole default process group; without
    an initialized group it raises."""

    def __init__(
        self,
        encoder: DualEncoder,
        params: Any,
        cfg: RetrieverConfig = RetrieverConfig(),
        *,
        device: Union[None, str, torch.device] = "cuda",
        mesh: Optional[DistCtx] = None,
        index: Optional[IndexStore] = None,
    ):
        if cfg.index_layout not in ("replicated", "sharded"):
            raise ValueError(
                f"unknown index_layout {cfg.index_layout!r}; one of ['replicated', 'sharded']"
            )
        self.ctx: Optional[DistCtx] = None
        if cfg.index_layout == "sharded":
            self.ctx = mesh if mesh is not None else DistCtx(cfg.dp_axis)
        self.shards = self.ctx.device_count() if self.ctx is not None else 1
        self.device = resolve_device(device)
        self.encoder = encoder
        self.params = None if params is None else params_to_torch(params, self.device)
        self.cfg = cfg
        self.backend = cfg.resolve_backend()
        self.policy = cfg.resolved_precision()
        self.index = index

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device).long()
        return torch.as_tensor(np.asarray(tokens), device=self.device).long()

    @torch.inference_mode()
    def build_index(self, passages: Union[np.ndarray, torch.Tensor]) -> IndexStore:
        """Encode the corpus with the passage tower into the index dtype
        (``cfg.resolved_index_dtype()``); under the sharded layout this
        rank encodes and keeps its own block only.
        Rebuilding with the current ``self.params`` is the periodic re-encode."""
        self.index = build_index_store(
            lambda toks: self.encoder.encode_passage(self.params, self._tokens(toks)),
            passages,
            batch=self.cfg.encode_batch,
            dtype=self.cfg.resolved_index_dtype(),
            shards=self.shards,
            shard=None if self.ctx is None else self.ctx.shard_index(),
        )
        return self.index

    def _require_index(self) -> IndexStore:
        """The index, held to this Retriever's layout: every row when
        replicated, this rank's block of a ``shards``-way layout when sharded
        (a store set through ``index=`` may be either)."""
        store = self.index
        if store is None:
            raise ValueError("no index built yet: call build_index(passages)")
        want = None if self.ctx is None else (self.shards, self.ctx.shard_index())
        have = None if store.shard is None else (store.shards, store.shard)
        if have != want:
            raise ValueError(f"the index holds {_rows_held(have)}, but this "
                             f"{self.cfg.index_layout} Retriever searches {_rows_held(want)}")
        return store

    @torch.inference_mode()
    def encode_queries(self, query_tokens) -> torch.Tensor:
        """(Q, d) query representations in the compute dtype."""
        reps = self.encoder.encode_query(self.params, self._tokens(query_tokens))
        return self.policy.cast_compute(reps).contiguous()

    def _local_topk(
        self, q_reps: torch.Tensor, store: IndexStore
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The exact top-k of compute-dtype queries over the rows ``store``
        holds, ids made global (the block's offset added to every id >= 0)."""
        scores, ids = self.backend.topk(
            q_reps, store.reps, self.cfg.top_k, col_valid=store.row_valid
        )
        if store.row_offset:
            ids = torch.where(ids >= 0, ids + store.row_offset, -1)
        return scores, ids

    @torch.inference_mode()
    def search_reps_tensors(self, q_reps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores (Q, k) fp32, ids (Q, k) int32) on the device."""
        store = self._require_index()
        q_reps = self.policy.cast_compute(q_reps.to(self.device)).contiguous()
        scores, ids = self._local_topk(q_reps, store)
        if self.ctx is None:
            return scores, ids
        shape = (self.shards,) + tuple(scores.shape)
        return merge_shard_candidates(self.ctx.gather(scores).view(shape),
                                      self.ctx.gather(ids).view(shape), self.cfg.top_k)

    def search_reps(self, q_reps: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """Search query representations (Q, d): (ids, scores) on the host."""
        scores, ids = self.search_reps_tensors(q_reps)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def search(self, query_tokens) -> Tuple[np.ndarray, np.ndarray]:
        """Encode query tokens with the query tower and return
        (ids (Q, k) int32, scores (Q, k) fp32) on the host; ids -1 = empty."""
        return self.search_reps(self.encode_queries(query_tokens))
