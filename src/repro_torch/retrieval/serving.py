"""Serving: trainer checkpoints -> Retriever -> dynamic batching.

``load_trained_params`` reads the params subtree of a JAX trainer checkpoint
(its path-keyed ``state/params/...`` ``.npy`` leaves) as nested dicts of numpy
arrays, which the Retriever places on its device. ``make_server`` puts a
``BatchingServer`` in front of ``Retriever.search``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.checkpoint import latest_step, read_manifest, step_dir
from repro_torch.retrieval.retriever import Retriever
from repro_torch.runtime.server import BatchingServer

PARAMS_PREFIX = "state/params/"


def load_trained_params(
    ckpt_dir: str, step: Optional[int] = None
) -> Tuple[Any, int]:
    """(params, step) from a trainer checkpoint directory (default: the latest
    complete step). Only the ``state/params/...`` leaves are read; dtypes and
    shapes are as trained."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")
    manifest = read_manifest(ckpt_dir, step)
    path = step_dir(ckpt_dir, step)
    params: Dict[str, Any] = {}
    for meta in manifest["leaves"]:
        key = meta["key"]
        if not key.startswith(PARAMS_PREFIX):
            continue
        node = params
        parts = key[len(PARAMS_PREFIX):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.load(os.path.join(path, meta["file"]))
    if not params:
        raise ValueError(
            f"checkpoint {path} has no {PARAMS_PREFIX!r} leaves: not a "
            "trainer-produced checkpoint?"
        )
    return params, step


def make_server(
    retriever: Retriever,
    *,
    max_batch: int = 32,
    max_wait_s: float = 0.01,
) -> BatchingServer:
    """Dynamic-batching server over ``Retriever.search``: requests are single
    tokenized queries; each coalesced batch runs encode + top-k once."""
    retriever._require_index()
    return BatchingServer(retriever.search, max_batch=max_batch, max_wait_s=max_wait_s)
