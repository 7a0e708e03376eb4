"""HardNegativeMiner: periodic ANCE-style refresh through the serving stack,
the port of ``repro.mining.miner``.

One refresh = snapshot the training params, re-encode the corpus into an
``IndexStore`` with the passage tower, mine top-k per training query with
the dense/fused ``SearchBackend``, drop gold passages, apply the
teleportation trust region (band + score margin), and publish the resulting
``NegativeTable`` with an atomic buffer swap.

Two execution modes (cfg.sync), one code path:

  * **async** (default): the refresh runs on a worker thread against the
    param *snapshot*; training steps keep running and the loader keeps
    serving the previous table until the swap. A worker exception is kept
    and re-raised on the consumer side at the next miner call. A refresh
    request arriving while one is in flight is skipped (counted), never
    queued.
  * **sync**: the same refresh on the same worker, and the caller waits for
    it. Same params, same corpus, same config => the same table, bit for
    bit, in either mode (tests/test_torch_mining.py and, on the card,
    tests/test_torch_mining_cuda.py).

On CUDA the refresh runs on the miner's own stream (``self.stream``), so
the training loop's kernels, and its one sync a step, never queue behind
the re-encode: the snapshot is a copy on the device taken on the caller's
current stream at the hook's step (an event orders the miner's stream
after it), into buffers the optimizer never writes; the refresh syncs only
the miner's stream (one copy of the results to the host at its end). Each
tower's encode at the miner's two token shapes (``encode_batch`` passages,
``query_batch`` queries) is a CUDA graph captured once on that stream, so
the worker takes the interpreter lock once a batch instead of once an op;
the CPU runs the same functions eagerly. The training loop
should run on a higher-priority stream (``runtime.trainer.priority_stream``):
the two streams share the SMs, and the block scheduler then serves the
step's small kernels ahead of the encode's wide grids. One stall remains:
the first launch in the process of a kernel (a cuBLAS GEMM of a new dtype,
an op compiled at its first call) returns only once the device has drained
the refresh's queued work, so the first refresh should start after the
loop has run a step (the trainer's hook fires after ``refresh_every``).

The whole pipeline is host-side control (numpy tables, a thread, an index
rebuild); the device work is the towers, the search kernel and the copies.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.common.treemath import tree_leaves, tree_map
from repro_torch.core.device import resolve_device
from repro_torch.core.types import DualEncoder
from repro_torch.mining.config import MinerConfig
from repro_torch.mining.table import NegativeTable, NegativeTableBuffer, empty_table
from repro_torch.retrieval.index import pad_batch
from repro_torch.retrieval.retriever import Retriever


def teleport_filter(
    ids: np.ndarray,
    scores: np.ndarray,
    gold: np.ndarray,
    *,
    depth_lo: int,
    depth_hi: int,
    margin: float,
    n_out: int,
) -> np.ndarray:
    """Teleportation filtering of ranked candidates (Sun et al. 2022).

    ids/scores: (Q, K) ranked best-first (the SearchBackend contract);
    ids -1 = empty. gold: (Q,) gold passage id per query. Per row:

      1. drop empty slots and the gold passage;
      2. rank the survivors 0..; keep ranks in ``[depth_lo, depth_hi)``
         (the band: skipping the very top keeps negatives in the trust
         region);
      3. drop banded candidates scoring within ``margin`` of the reference
         score (gold's score when gold was retrieved, else the top score):
         likely unlabeled positives. margin=0.0 still drops candidates
         scoring >= the reference.

    Returns (Q, n_out) int32; rows with fewer survivors pad with -1.
    """
    ids = np.asarray(ids)
    scores = np.asarray(scores)
    gold = np.asarray(gold)
    q, _ = ids.shape
    out = np.full((q, n_out), -1, np.int32)
    is_gold = ids == gold[:, None]
    valid = (ids >= 0) & ~is_gold
    # reference score: gold's if retrieved, else the best retrieved score
    has_gold = is_gold.any(axis=1)
    gold_score = np.where(is_gold, scores, -np.inf).max(axis=1)
    ref = np.where(has_gold, gold_score, scores[:, 0])
    # gold-excluded rank of each retained candidate
    rank = np.cumsum(valid, axis=1) - 1
    keep = valid & (rank >= depth_lo) & (rank < depth_hi) & (scores < ref[:, None] - margin)
    for i in range(q):
        row = ids[i, keep[i]][:n_out]
        out[i, : len(row)] = row
    return out


def _clone(params: Any) -> Any:
    return tree_map(lambda t: t.detach().clone(), params)


class _StreamClock:
    """Marks on the miner's stream (CUDA events) or on the host clock (CPU);
    ``seconds(i, j)`` is valid once the stream has passed mark j."""

    def __init__(self, stream: Optional[torch.cuda.Stream]):
        self.stream = stream
        self.marks: List[Any] = []

    def mark(self) -> None:
        if self.stream is None:
            self.marks.append(time.perf_counter())
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        self.marks.append(ev)

    def seconds(self, i: int, j: int) -> float:
        a, b = self.marks[i], self.marks[j]
        return b - a if self.stream is None else a.elapsed_time(b) / 1e3


class _TowerGraphs:
    """The encoder's towers at fixed token shapes as CUDA graphs, captured
    once on the miner's stream against the snapshot buffers (their
    addresses never change) and a static token buffer each. ``run`` copies
    a batch in, replays, and returns a copy of the output. A shape or a
    param tree it was not captured for raises; so does a failed capture.
    Kernels that count their launches in a wrapper (the flash towers)
    count them at capture, not at replay."""

    def __init__(self, encoder: DualEncoder, stream: torch.cuda.Stream):
        self.encoder = encoder
        self.stream = stream
        self.params: Any = None
        self.graphs: Dict[tuple, tuple] = {}

    def capture(self, params: Any, batches: Dict[str, torch.Tensor]) -> None:
        """``batches``: tower name ('passage', 'query') -> one batch of
        tokens at the shape to capture."""
        self.params = params
        pool = torch.cuda.graph_pool_handle()
        with torch.inference_mode(), torch.cuda.stream(self.stream):
            for tower, tokens in batches.items():
                fn = getattr(self.encoder, f"encode_{tower}")
                static_in = tokens.clone()
                fn(params, static_in)  # first calls (workspaces, lazy set-up) outside capture
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    static_out = fn(params, static_in)
                finally:
                    graph.capture_end()
                self.graphs[(tower, tuple(static_in.shape))] = (graph, static_in, static_out)

    def run(self, tower: str, params: Any, tokens: torch.Tensor) -> torch.Tensor:
        if params is not self.params:
            raise ValueError("the encode graphs read the snapshot they were captured with")
        key = (tower, tuple(tokens.shape))
        if key not in self.graphs:
            raise ValueError(f"no {tower} graph for token shape {tuple(tokens.shape)}")
        graph, static_in, static_out = self.graphs[key]
        static_in.copy_(tokens)
        graph.replay()
        return static_out.clone()

    def as_encoder(self) -> DualEncoder:
        return self.encoder._replace(
            encode_query=lambda p, t: self.run("query", p, t),
            encode_passage=lambda p, t: self.run("passage", p, t),
        )


class HardNegativeMiner:
    """Owns the refresh pipeline + the published ``NegativeTableBuffer``.

    Built from the *training* DualEncoder and the mining corpus arrays:
    ``queries`` (Nq, q_len) token rows aligned with the loader's dataset
    indices, ``passages`` (Np, p_len), and ``gold`` (Nq,) gold passage id
    per query (defaults to ``arange``, the SyntheticRetrievalCorpus
    alignment). Runs on ``device``: CUDA unless ``device="cpu"``. The token
    arrays go to the device once, on the miner's stream; the internal
    Retriever is persistent and every refresh reuses it (and its graphs).
    ``refresh_log`` holds one dict per published refresh: its start step,
    version, the encode, search and filter seconds (device time on the
    miner's stream on CUDA), its wall seconds and the steps it overlapped.
    """

    def __init__(
        self,
        encoder: DualEncoder,
        cfg: MinerConfig,
        *,
        queries: np.ndarray,
        passages: np.ndarray,
        gold: Optional[np.ndarray] = None,
        device: Union[None, str, torch.device] = "cuda",
    ):
        cfg.validate()
        self.cfg = cfg
        self.encoder = encoder
        self.queries = np.asarray(queries)
        self.passages = np.asarray(passages)
        self.gold = (
            np.arange(len(self.queries), dtype=np.int64)
            if gold is None
            else np.asarray(gold)
        )
        if len(self.gold) != len(self.queries):
            raise ValueError(
                f"gold has {len(self.gold)} rows for {len(self.queries)} queries"
            )
        self.buffer = NegativeTableBuffer(
            empty_table(len(self.queries), cfg.n_negatives)
        )
        self.device = resolve_device(device)
        # a pool stream: it neither blocks nor waits on the default stream
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._graphs = _TowerGraphs(encoder, self.stream) if self.stream is not None else None
        self.retriever = Retriever(encoder, None, cfg.retriever_config(), device=self.device)
        # the query batch (one shape; the tail is padded with zero rows)
        self._qb = min(cfg.query_batch, len(self.queries))
        pad = -len(self.queries) % self._qb
        queries_padded = np.concatenate(
            [self.queries, np.zeros((pad,) + self.queries.shape[1:], self.queries.dtype)]
        )
        with self._on_stream():
            self._passage_tokens = torch.from_numpy(self.passages).to(self.device).long()
            self._query_tokens = torch.from_numpy(queries_padded).to(self.device).long()
        self._snap: Any = None
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._times: Dict[str, float] = {}
        self._observed_step = 0  # latest training step seen by note_step()
        self.refreshes = 0       # published refreshes
        self.skipped = 0         # requests dropped because one was in flight
        self.last_overlap = 0    # training steps observed during the last refresh
        self.refresh_log: List[Dict[str, float]] = []

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    # ------------------------------------------------------------ snapshot
    @torch.no_grad()
    def _snapshot(self, params: Any) -> Any:
        """Copy ``params`` into the miner's own buffers on the caller's
        current stream: the copy is ordered after the step that made the
        params and before the optimizer's next write, and the miner's
        stream waits for it (an event) before it reads. The buffers hold
        the encoder's ``compute_copy`` layout where it has one (a tower's
        weights in the compute dtype they are cast to anyway), else a plain
        copy; they are allocated once and refilled by every refresh."""
        if self._snap is None:
            self._snap = (self.encoder.compute_copy or _clone)(params)
            if self.stream is not None:
                for t in tree_leaves(self._snap):
                    t.record_stream(self.stream)
        else:
            tree_map(lambda dst, src: dst.copy_(src), self._snap, params)
        if self.stream is not None:
            ready = torch.cuda.Event()
            ready.record()
            self.stream.wait_event(ready)
        return self._snap

    # ------------------------------------------------------------- mining
    def _mine(self, params: Any, step: int) -> NegativeTable:
        """One complete refresh against a param snapshot (any thread; on
        CUDA inside the miner's stream)."""
        cfg = self.cfg
        r = self.retriever
        clock = _StreamClock(self.stream)
        t0 = time.perf_counter()
        clock.mark()
        r.params = params
        r.build_index(self._passage_tokens)  # the ANCE re-encode
        clock.mark()
        nq = len(self.queries)
        all_s, all_i = [], []
        for lo in range(0, len(self._query_tokens), self._qb):
            s, i = r.search_reps_tensors(
                r.encode_queries(self._query_tokens[lo : lo + self._qb])
            )
            all_s.append(s)
            all_i.append(i)
        clock.mark()
        # the refresh's one sync, of the miner's stream only
        ids = torch.cat(all_i)[:nq].cpu().numpy()
        scores = torch.cat(all_s)[:nq].cpu().numpy()
        t1 = time.perf_counter()
        mined = teleport_filter(
            ids,
            scores,
            self.gold,
            depth_lo=cfg.depth_lo,
            depth_hi=cfg.depth_hi,
            margin=cfg.margin,
            n_out=cfg.n_negatives,
        )
        t2 = time.perf_counter()
        self._times = {
            "encode_s": clock.seconds(0, 1),
            "search_s": clock.seconds(1, 2),
            "filter_s": t2 - t1,
            "wall_s": t2 - t0,
        }
        return NegativeTable(
            ids=mined, step=step, version=self.buffer.read().version + 1
        )

    def _publish(self, table: NegativeTable, start_step: int) -> None:
        self.buffer.swap(table)
        self.last_overlap = max(self._observed_step - start_step, 0)
        self.refreshes += 1
        self.refresh_log.append({
            "step": start_step, "version": table.version, **self._times,
            "steps_overlapped": self.last_overlap,
        })

    def _start(self, params: Any, step: int) -> None:
        """Snapshot on the caller's stream, capture the encode graphs at the
        first refresh (on this thread, before any worker runs), then start
        the worker."""
        snapshot = self._snapshot(params)
        if self._graphs is not None and not self._graphs.graphs:
            self._graphs.capture(snapshot, {
                "passage": pad_batch(self._passage_tokens[: self.cfg.encode_batch],
                                     self.cfg.encode_batch),
                "query": self._query_tokens[: self._qb],
            })
            self.retriever.encoder = self._graphs.as_encoder()

        def work():
            try:
                with self._on_stream():
                    table = self._mine(snapshot, step)
                self._publish(table, step)
            except BaseException as e:  # re-raised at the next consumer call
                self._exc = e

        self._thread = threading.Thread(
            target=work, name="hard-negative-miner", daemon=True
        )
        self._thread.start()

    # ---------------------------------------------------------- refresh API
    def refresh(self, params: Any, step: int) -> NegativeTable:
        """Synchronous refresh: blocks until the new table is published.
        Drains any in-flight async refresh first (one refresh at a time)."""
        self.wait()
        self._start(params, int(step))
        self.wait()
        return self.buffer.read()

    def refresh_async(self, params: Any, step: int) -> bool:
        """Kick off a background refresh against a snapshot of ``params``.
        Returns False (and counts a skip) if one is already in flight.
        Re-raises a previous worker failure on this (consumer) thread."""
        self._raise_pending()
        if self._thread is not None:
            if self._thread.is_alive():
                self.skipped += 1
                return False
            self._thread.join()
        self._start(params, int(step))
        return True

    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        """Barrier: join any in-flight refresh, then surface its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def note_step(self, step: int) -> None:
        """Stamp training progress (called per batch by the injector): the
        overlap metric is how many of these land during one refresh."""
        self._observed_step = max(self._observed_step, int(step))

    def staleness(self, step: int) -> int:
        """Optimizer updates the served table lags behind ``step`` (one huge
        sentinel before the first refresh lands)."""
        t = self.buffer.read()
        return int(step) - t.step if t.step >= 0 else int(step) + 1

    # --------------------------------------------------------- trainer hook
    def refresh_hook(self, state: Any, step: int) -> Dict[str, float]:
        """PeriodicHook-compatible entry point: the hook's ``every`` is the
        refresh cadence; metrics land in the history row under the hook
        prefix. ``state`` is the train state (``.params``) or a bare param
        tree."""
        params = getattr(state, "params", state)
        if self.cfg.sync:
            self.refresh(params, step)
        else:
            self.refresh_async(params, step)
        t = self.buffer.read()
        stale = self.staleness(step)
        out = {
            "table_version": float(t.version),
            "table_staleness": float(stale),
            "refreshes": float(self.refreshes),
            "skipped": float(self.skipped),
            "steps_overlapped": float(self.last_overlap),
        }
        if self.cfg.staleness_budget:
            out["stale"] = float(stale > self.cfg.staleness_budget)
        return out

    # ----------------------------------------------------- checkpoint state
    def state_to_save(self) -> Dict[str, np.ndarray]:
        """Fixed-structure numpy tree for the checkpoint payload: the
        *published* table only. An in-flight refresh is deliberately not
        captured: on restore it simply re-runs at the next cadence."""
        t = self.buffer.read()
        return {
            "ids": np.asarray(t.ids),
            "meta": np.asarray([t.step, t.version], np.int64),
        }

    def load_saved_state(self, tree: Dict[str, np.ndarray]) -> None:
        """Restore a saved table (drains any in-flight refresh first: it
        was mined for a timeline the restore just rewound)."""
        self.wait()
        meta = np.asarray(tree["meta"])
        self.buffer.swap(
            NegativeTable(
                ids=np.asarray(tree["ids"], np.int32),
                step=int(meta[0]),
                version=int(meta[1]),
            )
        )

    def close(self) -> None:
        """Join the worker without re-raising (shutdown path)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._exc = None
