"""Serving: trainer checkpoints -> Retriever -> dynamic batching.

``load_trained_params`` reads the params subtree of a JAX trainer checkpoint
(its path-keyed ``state/params/...`` ``.npy`` leaves) as nested dicts of numpy
arrays, which the Retriever places on its device. ``make_server`` puts a
``BatchingServer`` in front of ``Retriever.search``.

A sharded Retriever serves from one process a rank: rank 0 runs the
``BatchingServer``, the other ranks run ``serve_followers``. Each coalesced
batch, padded to (max_batch, q_len), goes from rank 0 to every rank in one
broadcast headed by a control word (run or stop), and every rank then runs
the same collective search. ``BatchingServer.stop()`` on rank 0 broadcasts
the stop word, which ends every follower. Only the server thread issues
collectives on rank 0 while the server runs. A follower waits for the next
batch inside the broadcast, which the process group's timeout bounds, so a
server that has broadcast nothing for ``KEEPALIVE_S`` (a tenth of
``core.dist.GROUP_TIMEOUT``) sends the keep-alive word, which the
followers skip: an idle server outlives the timeout.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import latest_step, read_manifest, step_dir
from repro_torch.core.dist import GROUP_TIMEOUT
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


#: the control word that heads each broadcast batch
RUN, STOP, KEEP = 1, 0, 2
#: the longest rank 0's server goes without a broadcast (keep it under the
#: group's timeout)
KEEPALIVE_S = GROUP_TIMEOUT.total_seconds() / 10


class _BatchWire:
    """Rank 0's padded (max_batch, q_len) token batches to every rank: one
    int64 broadcast of the control word followed by the tokens."""

    def __init__(self, retriever: Retriever, max_batch: int, q_len: int, *, lead: bool):
        if (retriever.ctx.shard_index() == 0) != lead:
            raise ValueError("rank 0 of a sharded Retriever runs the server (make_server); "
                             "every other rank runs serve_followers")
        self.ctx = retriever.ctx
        self.device = retriever.device
        self.shape = (max_batch, q_len)
        self.last = time.monotonic()

    def _broadcast(self, word: int, tokens=None) -> torch.Tensor:
        if self.device.type == "cuda":      # the calling thread's device
            torch.cuda.set_device(self.device)
        buf = torch.zeros((1 + self.shape[0] * self.shape[1],), dtype=torch.int64,
                          device=self.device)
        buf[0] = word
        if tokens is not None:
            buf[1:] = torch.as_tensor(tokens, device=self.device).reshape(-1)
        out = self.ctx.broadcast(buf, src=0)
        self.last = time.monotonic()
        return out

    def send(self, tokens) -> torch.Tensor:
        """Rank 0: broadcast a batch; returns it on this rank's device."""
        if tuple(np.shape(tokens)) != self.shape:
            raise ValueError(f"a batch of shape {tuple(np.shape(tokens))}; the ranks "
                             f"take {self.shape}")
        return self._broadcast(RUN, tokens)[1:].view(self.shape)

    def idle(self) -> None:
        """Rank 0, with no request: the keep-alive word once ``KEEPALIVE_S``
        has passed since the last broadcast."""
        if time.monotonic() - self.last >= KEEPALIVE_S:
            self._broadcast(KEEP)

    def stop(self) -> None:
        """Rank 0: broadcast the stop word."""
        self._broadcast(STOP)

    def receive(self) -> Optional[torch.Tensor]:
        """Every other rank: the next batch (keep-alive words skipped), or
        None at the stop word."""
        while True:
            buf = self._broadcast(STOP)
            word = buf[0].item()
            if word != KEEP:
                return None if word == STOP else buf[1:].view(self.shape)


def make_server(
    retriever: Retriever,
    *,
    max_batch: int = 32,
    max_wait_s: float = 0.01,
    q_len: Optional[int] = None,
) -> BatchingServer:
    """Dynamic-batching server over ``Retriever.search``: requests are single
    tokenized queries; each coalesced batch runs encode + top-k once. For a
    sharded Retriever (rank 0 of the group) each batch is first broadcast
    to the ranks that run ``serve_followers``, which needs the queries'
    token count ``q_len``; an idle server broadcasts the keep-alive word
    every ``KEEPALIVE_S``, and its stop broadcasts the stop word."""
    retriever._require_index()
    if retriever.ctx is None:
        return BatchingServer(retriever.search, max_batch=max_batch, max_wait_s=max_wait_s)
    if q_len is None:
        raise ValueError("a sharded Retriever's server needs q_len: every rank "
                         "receives (max_batch, q_len) token batches")
    wire = _BatchWire(retriever, max_batch, q_len, lead=True)
    return BatchingServer(lambda tokens: retriever.search(wire.send(tokens)),
                          max_batch=max_batch, max_wait_s=max_wait_s, on_idle=wire.idle,
                          on_exit=wire.stop)


def serve_followers(retriever: Retriever, max_batch: int, q_len: int) -> int:
    """Every rank of a sharded Retriever but 0: run the search of each batch
    that rank 0's server broadcasts, until its stop word. Returns the
    batches served."""
    retriever._require_index()
    wire = _BatchWire(retriever, max_batch, q_len, lead=False)
    served = 0
    while (tokens := wire.receive()) is not None:
        retriever.search(tokens)
        served += 1
    return served
