"""Deterministic sharded data loader with checkpointable state: the port's
own copy of ``repro.data.loader`` (numpy only, the same index stream).

Index stream: a per-epoch permutation keyed by (seed, epoch); each host
takes a strided slice (host_id :: n_hosts) of every global batch, so the
union over hosts is the global batch. State = (epoch, step) plus the mined
table's staleness stamps, four ints saved with the checkpoint.
``PrefetchIterator`` runs batch assembly a few batches ahead on a thread;
``MinedNegativeInjector`` joins the miner's published table into each
batch.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, Optional

import numpy as np


@dataclasses.dataclass
class LoaderState:
    epoch: int = 0
    step: int = 0  # step within epoch
    # staleness stamps of the last mined negative table (-1 = none yet)
    mined_step: int = -1
    mined_version: int = 0

    def to_dict(self):
        return {
            "epoch": self.epoch,
            "step": self.step,
            "mined_step": self.mined_step,
            "mined_version": self.mined_version,
        }

    @staticmethod
    def from_dict(d):
        return LoaderState(
            epoch=int(d["epoch"]),
            step=int(d["step"]),
            mined_step=int(d.get("mined_step", -1)),
            mined_version=int(d.get("mined_version", 0)),
        )


class ShardedLoader:
    def __init__(
        self,
        dataset_size: int,
        global_batch: int,
        *,
        seed: int = 0,
        host_id: int = 0,
        n_hosts: int = 1,
        drop_last: bool = True,
        state: Optional[LoaderState] = None,
    ):
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} not divisible by {n_hosts} hosts")
        self.dataset_size = dataset_size
        self.global_batch = global_batch
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.steps_per_epoch = dataset_size // global_batch
        if self.steps_per_epoch <= 0:
            raise ValueError("dataset smaller than one global batch")
        self.state = state or LoaderState()

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.dataset_size)

    def next_indices(self) -> np.ndarray:
        """Local (this host's) index slice of the next global batch."""
        st = self.state
        perm = self._epoch_perm(st.epoch)
        lo = st.step * self.global_batch
        batch = perm[lo : lo + self.global_batch]
        local = batch[self.host_id :: self.n_hosts]
        st.step += 1
        if st.step >= self.steps_per_epoch:
            st.step = 0
            st.epoch += 1
        return local

    def global_indices_for(self, epoch: int, step: int) -> np.ndarray:
        perm = self._epoch_perm(epoch)
        lo = step * self.global_batch
        return perm[lo : lo + self.global_batch]


class PrefetchIterator:
    """Wrap a () -> batch callable with a depth-k background prefetch thread."""

    def __init__(self, fn: Callable[[], Dict[str, np.ndarray]], depth: int = 2):
        self._fn = fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._exc_delivered = False
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            while not self._stop.is_set():
                item = self._fn()
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on next __next__
            self._exc = e

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._exc is not None:
                self._exc_delivered = True
                raise self._exc
            try:
                return self._q.get(timeout=0.5)
            except queue.Empty:
                continue

    def close(self):
        """Stop the worker — and surface a worker failure the consumer never
        saw: a crash after the consumer's last __next__ would otherwise be
        silently swallowed by the shutdown path."""
        self._stop.set()
        self._thread.join(timeout=2.0)
        if self._exc is not None and not self._exc_delivered:
            self._exc_delivered = True
            raise self._exc


class MinedNegativeInjector:
    """Join the miner's published ``NegativeTable`` into batch assembly.

    ``read_table`` is the buffer read (``miner.buffer.read``) — called once
    per batch, so the whole batch sees one consistent snapshot even if the
    background refresh swaps mid-assembly. Empty slots (-1: pre-first-
    refresh, or an under-filled teleportation band) fall back to seeded
    uniform non-gold corpus ids keyed by (seed, step) — deterministic, so
    the synchronous-mode trajectory is bit-reproducible and shapes stay
    static.

    When handed the loader's ``state``, each call stamps the staleness
    fields (``mined_step``/``mined_version``) so they ride the checkpoint;
    ``on_step`` (``miner.note_step``) tells the miner how far training has
    advanced — the refresh-overlap metric.
    """

    def __init__(
        self,
        read_table: Callable[[], "object"],
        n_passages: int,
        *,
        n_negatives: Optional[int] = None,
        seed: int = 0,
        state: Optional[LoaderState] = None,
        on_step: Optional[Callable[[int], None]] = None,
    ):
        self._read = read_table
        self.n_passages = n_passages
        self.n_negatives = n_negatives
        self.seed = seed
        self.state = state
        self.on_step = on_step

    def mined_ids(
        self, query_idx: np.ndarray, gold: np.ndarray, step: int
    ) -> np.ndarray:
        """(B, n_negatives) int32 passage ids for this batch's queries."""
        if self.on_step is not None:
            self.on_step(step)
        table = self._read()  # one atomic read per batch
        query_idx = np.asarray(query_idx)
        gold = np.asarray(gold)
        width = (
            table.ids.shape[1] if self.n_negatives is None else self.n_negatives
        )
        rows = np.full((len(query_idx), width), -1, np.int32)
        take = min(width, table.ids.shape[1])
        rows[:, :take] = table.ids[query_idx][:, :take]
        # deterministic non-gold fallback: sample [0, n-1) and shift past the
        # gold id — uniform over the other n-1 passages
        rng = np.random.default_rng((self.seed, int(step)))
        draw = rng.integers(0, self.n_passages - 1, size=rows.shape)
        draw = draw + (draw >= gold[:, None])
        rows = np.where(rows >= 0, rows, draw).astype(np.int32)
        if self.state is not None:
            self.state.mined_step = int(table.step)
            self.state.mined_version = int(table.version)
        return rows
