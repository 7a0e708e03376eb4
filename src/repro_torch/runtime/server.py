"""Dynamic batching for retrieval serving.

``BatchingServer`` coalesces single-query requests up to ``max_batch``
(padding to a fixed batch shape) or flushes after ``max_wait_s``. The
coalescing window is measured from collect time, so a backed-up queue fills
whole batches. ``retrieval.serving.make_server`` wires a Retriever to it.
The server is stateless between batches; a worker exception is handed to
every caller of that batch, and ``query`` re-raises it. ``on_idle`` and
``on_exit``, if given, run on the server thread: ``on_idle`` each time a
collect window passes with no request, ``on_exit`` after the last batch
(the sharded Retriever's keep-alive and stop broadcasts: only that thread
issues collectives).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    payload: np.ndarray
    future: "queue.Queue"        # 1-slot: receives (ids, scores) or Exception
    t_enqueue: float = dataclasses.field(default_factory=time.monotonic)


class BatchingServer:
    """Dynamic batcher: coalesce requests to ``max_batch`` (padding to the
    fixed batch size) or flush after ``max_wait_s``."""

    def __init__(
        self,
        serve_fn: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
        *,
        max_batch: int = 32,
        max_wait_s: float = 0.01,
        on_idle: Optional[Callable[[], None]] = None,
        on_exit: Optional[Callable[[], None]] = None,
    ):
        self.serve_fn = serve_fn
        self.on_idle = on_idle
        self.on_exit = on_exit
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._q: "queue.Queue[Request]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.batch_sizes: List[int] = []   # observability: coalescing histogram

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def submit(self, payload: np.ndarray) -> "queue.Queue":
        fut: "queue.Queue" = queue.Queue(maxsize=1)
        self._q.put(Request(payload=payload, future=fut))
        return fut

    def query(self, payload: np.ndarray, timeout: float = 30.0):
        res = self.submit(payload).get(timeout=timeout)
        if isinstance(res, Exception):
            raise res
        return res

    # -- internals ---------------------------------------------------------
    def _collect(self) -> List[Request]:
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        # Drain whatever is already queued without waiting: under backlog the
        # batch fills at once. A window measured from submit time would have
        # expired for every queued request, and every batch would be size 1.
        while len(batch) < self.max_batch:
            try:
                batch.append(self._q.get_nowait())
            except queue.Empty:
                break
        # then wait out the remainder of the coalescing window, measured
        # from collect time, for stragglers
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        try:
            self._serve()
        finally:
            if self.on_exit is not None:
                self.on_exit()

    def _serve(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                if self.on_idle is not None:
                    self.on_idle()
                continue
            self.batch_sizes.append(len(batch))
            payloads = np.stack([r.payload for r in batch])
            n = len(batch)
            if n < self.max_batch:  # pad to the fixed batch shape
                payloads = np.concatenate(
                    [payloads, np.repeat(payloads[-1:], self.max_batch - n, axis=0)]
                )
            try:
                ids, scores = self.serve_fn(payloads)
                ids, scores = np.asarray(ids), np.asarray(scores)
                for i, r in enumerate(batch):
                    r.future.put((ids[i], scores[i]))
            except Exception as e:  # handed to each caller; query() re-raises
                for r in batch:
                    r.future.put(e)
