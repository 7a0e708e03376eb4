"""Retriever: the inference surface of the port (``repro.retrieval.retriever``).

A ``Retriever`` composes the query and passage towers of a ``DualEncoder``
(the training params), an ``IndexStore`` (the corpus encoded in the policy's
index dtype) and a ``SearchBackend`` (dense blocked matmul + top-k, or the
fused CUDA kernel). Queries are encoded, cast to the compute dtype and scored
against the index; scores are fp32.

This slice has the replicated layout only; ``index_layout="sharded"`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.compat import params_to_torch
from repro_torch.core.device import resolve_device
from repro_torch.core.precision import PrecisionPolicy, resolve_precision
from repro_torch.core.types import DualEncoder
from repro_torch.retrieval.index import IndexStore, build_index_store
from repro_torch.retrieval.search import SearchBackend, resolve_search_backend


@dataclasses.dataclass(frozen=True)
class RetrieverConfig:
    """top_k: results per query. search_impl: 'dense' | 'fused'.
    index_layout: 'replicated' (the only layout of this slice).
    precision: PrecisionPolicy or preset name: queries scored in
    ``compute_dtype``, index stored in ``bank_dtype``, scores fp32.
    index_dtype: a torch dtype that overrides the index's; None defers to
    the policy's ``bank_dtype``. score_block: dense backend column block.
    block_q/block_n: the JAX kernel's tile sizes, passed to the fused
    backend, which keeps its own tiling. encode_batch: corpus encode batch.
    dp_axis: the axis the sharded layout shards over (stored; the sharded
    layout is not yet ported)."""

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


class Retriever:
    """Built from a DualEncoder, its params (nested dicts of tensors or of
    numpy arrays, as ``serving.load_trained_params`` returns them; None to
    set later, as the miner does) and a RetrieverConfig. Runs on ``device``:
    CUDA unless ``device="cpu"``. Token rows may be numpy arrays or tensors
    already on the device. Every call runs on the caller's current CUDA
    stream, and ``search`` syncs only that stream (its copy to the host)."""

    def __init__(
        self,
        encoder: DualEncoder,
        params: Any,
        cfg: RetrieverConfig = RetrieverConfig(),
        *,
        device: Union[None, str, torch.device] = "cuda",
        index: Optional[IndexStore] = None,
    ):
        if cfg.index_layout == "sharded":
            raise NotImplementedError(
                "index_layout='sharded' is not yet ported to repro_torch (ROADMAP A8)"
            )
        if cfg.index_layout != "replicated":
            raise ValueError(
                f"unknown index_layout {cfg.index_layout!r}; one of ['replicated', 'sharded']"
            )
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
        (``cfg.resolved_index_dtype()``).
        Rebuilding with the current ``self.params`` is the periodic re-encode."""
        self.index = build_index_store(
            lambda toks: self.encoder.encode_passage(self.params, self._tokens(toks)),
            passages,
            batch=self.cfg.encode_batch,
            dtype=self.cfg.resolved_index_dtype(),
        )
        return self.index

    def _require_index(self) -> IndexStore:
        if self.index is None:
            raise ValueError("no index built yet: call build_index(passages)")
        return self.index

    @torch.inference_mode()
    def encode_queries(self, query_tokens) -> torch.Tensor:
        """(Q, d) query representations in the compute dtype."""
        reps = self.encoder.encode_query(self.params, self._tokens(query_tokens))
        return self.policy.cast_compute(reps).contiguous()

    @torch.inference_mode()
    def search_reps_tensors(self, q_reps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores (Q, k) fp32, ids (Q, k) int32) on the device."""
        store = self._require_index()
        q_reps = self.policy.cast_compute(q_reps.to(self.device)).contiguous()
        return self.backend.topk(
            q_reps, store.reps, self.cfg.top_k, col_valid=store.row_valid
        )

    def search(self, query_tokens) -> Tuple[np.ndarray, np.ndarray]:
        """Encode query tokens with the query tower and return
        (ids (Q, k) int32, scores (Q, k) fp32) on the host; ids -1 = empty."""
        scores, ids = self.search_reps_tensors(self.encode_queries(query_tokens))
        return ids.cpu().numpy(), scores.cpu().numpy()
