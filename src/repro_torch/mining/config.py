"""MinerConfig: every knob of the mining subsystem in one frozen dataclass,
the port of ``repro.mining.config`` (the same fields, defaults and checks).

The config is validated when a miner is built; the serving-stack axes
(search backend, index layout, precision, encode batch) pass straight
through to the ``RetrieverConfig`` the miner builds, so mining runs on the
same dense/fused search programs as serving.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.retrieval.retriever import RetrieverConfig


@dataclasses.dataclass(frozen=True)
class MinerConfig:
    """Hard-negative mining knobs.

    refresh_every: trainer steps between table refreshes (the cadence the
        trainer's PeriodicHook fires the miner at).
    top_k: mining search depth per query: how far down the ranked list the
        teleportation band may reach (must cover ``depth_hi``).
    n_negatives: mined ids published per query (the extra ``passage_hard``
        columns each batch gains).
    staleness_budget: max steps the served table may lag the refresh that
        built it before the refresh hook reports ``stale=1`` (0 disables the
        check). Advisory: async mining serves slightly stale negatives by
        design; the budget makes "too stale" observable.
    depth_lo/depth_hi: the teleportation band (Sun et al. 2022): negatives
        are taken from gold-excluded ranks ``[depth_lo, depth_hi)`` of the
        retrieved list, inside a trust region that skips the very top ranks
        (under a fresh model those are disproportionately unlabeled
        positives).
    margin: score-margin filter on top of the band: candidates scoring
        within ``margin`` of the gold passage (or of the top score when gold
        was not retrieved) are dropped as likely false negatives. 0.0 still
        drops candidates that *outscore* gold.
    sync: the caller waits for each refresh (deterministic tests, or
        measuring the blocking cost). Default False: refreshes run on a
        worker thread, and on CUDA on the miner's own stream, against a
        snapshot of the params while training steps continue.
    query_batch: mining-search query batch (one shape; the tail chunk is
        padded).
    search_impl/index_layout/precision/index_dtype/encode_batch/dp_axis:
        passthrough to the miner's ``RetrieverConfig``, with the same
        meaning as in serving (retrieval/retriever.py).
    """

    refresh_every: int = 100
    top_k: int = 32
    n_negatives: int = 4
    staleness_budget: int = 0
    depth_lo: int = 1
    depth_hi: int = 32
    margin: float = 0.0
    sync: bool = False
    query_batch: int = 256
    # RetrieverConfig passthrough ------------------------------------------
    search_impl: str = "dense"
    index_layout: str = "replicated"
    precision: Any = "fp32"
    index_dtype: Any = None
    encode_batch: int = 256
    dp_axis: str = "data"

    def validate(self) -> None:
        if self.refresh_every < 1:
            raise ValueError(f"refresh_every must be >= 1 (got {self.refresh_every})")
        if not 0 <= self.depth_lo < self.depth_hi:
            raise ValueError(
                f"teleportation band needs 0 <= depth_lo < depth_hi "
                f"(got [{self.depth_lo}, {self.depth_hi}))"
            )
        if self.top_k < self.depth_hi:
            raise ValueError(
                f"top_k={self.top_k} cannot cover the teleportation band "
                f"[{self.depth_lo}, {self.depth_hi}) — mine at least depth_hi deep"
            )
        if not 1 <= self.n_negatives <= self.depth_hi - self.depth_lo:
            raise ValueError(
                f"n_negatives={self.n_negatives} must fit the band "
                f"[{self.depth_lo}, {self.depth_hi}) "
                f"(width {self.depth_hi - self.depth_lo})"
            )
        if self.margin < 0:
            raise ValueError(f"margin must be >= 0 (got {self.margin})")
        if self.staleness_budget < 0:
            raise ValueError(
                f"staleness_budget must be >= 0 (got {self.staleness_budget})"
            )
        if self.query_batch < 1:
            raise ValueError(f"query_batch must be >= 1 (got {self.query_batch})")

    def retriever_config(self) -> RetrieverConfig:
        """The serving config mining runs on (validated by the Retriever)."""
        return RetrieverConfig(
            top_k=self.top_k,
            search_impl=self.search_impl,
            index_layout=self.index_layout,
            precision=self.precision,
            index_dtype=self.index_dtype,
            encode_batch=self.encode_batch,
            dp_axis=self.dp_axis,
        )
