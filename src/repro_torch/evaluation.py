"""Retrieval evaluation: exact Top@k over a corpus (the paper's metric), the
port of ``repro.evaluation``: a thin wrapper over the Retriever.

The corpus is encoded into an IndexStore and each eval query's top-max(ks)
ids come from one search (the fused CUDA kernel with
``search_impl="fused"``); the same call serves the trainer's periodic eval
hook, re-encoding the corpus with the current training-time params.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.types import DualEncoder
from repro_torch.retrieval.retriever import Retriever, RetrieverConfig


def recall_at(ids: np.ndarray, gold: np.ndarray, ks: Sequence[int]) -> Dict[str, float]:
    """Recall at every cutoff in ``ks`` from one ranked id list
    (Q, >= max(ks)); -1 ids (empty slots) never match. Each cutoff is
    reported as ``recall@{k}`` and as the historical ``top@{k}``."""
    gold = np.asarray(gold)
    out: Dict[str, float] = {}
    for k in ks:
        hit = float(np.mean((ids[:, :k] == gold[:, None]).any(axis=1)))
        out[f"top@{k}"] = hit
        out[f"recall@{k}"] = hit
    return out


def evaluate_topk(
    enc: DualEncoder,
    params,
    corpus,
    ks: Sequence[int] = (1, 5, 20),
    *,
    retriever: Optional[Retriever] = None,
    cfg: Optional[RetrieverConfig] = None,
    device: Union[None, str, torch.device] = "cuda",
) -> Dict[str, float]:
    """Exact retrieval eval over the whole corpus (paper's Top@k): the
    corpus exposes ``eval_split() -> (queries, passages, gold_idx)``. Every
    cutoff comes from one search at k = max(ks). Pass ``retriever`` to reuse
    one (its params are refreshed to ``params`` and the corpus re-encoded),
    or ``cfg`` to configure a new one on ``device``. A sharded Retriever's
    eval is collective: every rank calls it with the same arguments, and
    each gets the replicated layout's numbers."""
    queries, passages, gold = corpus.eval_split(n=min(256, corpus.n_passages // 4))
    k_max = max(ks)
    if retriever is None:
        cfg = cfg or RetrieverConfig()
        if cfg.top_k < k_max:
            cfg = dataclasses.replace(cfg, top_k=k_max)
        retriever = Retriever(enc, params, cfg, device=device)
        retriever.build_index(passages)
    else:
        if cfg is not None:
            raise ValueError(
                "pass either retriever= (its own RetrieverConfig is used) or cfg=, not both"
            )
        if retriever.cfg.top_k < k_max:
            raise ValueError(f"retriever.top_k={retriever.cfg.top_k} < max(ks)={k_max}")
        # refresh to the current params and re-encode: a stale index would
        # score against an old encoder
        retriever.params = params
        retriever.build_index(passages)
    ids, _ = retriever.search(queries)
    return recall_at(ids, gold, ks)
