"""The double-buffered negative table: the port's own copy of
``repro.mining.table`` (numpy tables, the same contract).

The mining refresh and batch assembly run on different threads; the contract
between them is deliberately tiny:

  * a ``NegativeTable`` is an *immutable snapshot* — per-query id rows plus
    the staleness stamp (the training step whose params mined it) and a
    monotonic version. The miner builds a complete new table off to the
    side (the second buffer) and never mutates a published one.
  * ``NegativeTableBuffer`` publishes a finished table with one Python
    reference assignment — atomic under the GIL — so a reader either sees
    the whole old table or the whole new one, never a half-written row, and
    never blocks on an in-flight refresh.

Readers (the loader's ``MinedNegativeInjector``) grab the reference once per
batch and index it; the miner's worker thread swaps whenever a refresh
completes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NegativeTable:
    """One published mining result.

    ids: (n_queries, n_negatives) int32 global passage ids; -1 = empty slot
        (band under-filled, or the table predates the first refresh).
    step: training step whose param snapshot mined this table (-1 for the
        initial empty table) — the staleness stamp: ``current_step - step``
        is how many optimizer updates the negatives lag behind.
    version: monotonic refresh counter (0 = initial empty table).
    """

    ids: np.ndarray
    step: int = -1
    version: int = 0

    def __post_init__(self):
        ids = np.asarray(self.ids, np.int32)
        if ids.ndim != 2:
            raise ValueError(f"table ids must be (n_queries, n_negatives), got {ids.shape}")
        ids.setflags(write=False)  # published tables are immutable snapshots
        object.__setattr__(self, "ids", ids)

    @property
    def n_queries(self) -> int:
        return self.ids.shape[0]

    @property
    def n_negatives(self) -> int:
        return self.ids.shape[1]


def empty_table(n_queries: int, n_negatives: int) -> NegativeTable:
    """The pre-first-refresh table: every slot empty (-1), stamp -1."""
    return NegativeTable(
        ids=np.full((n_queries, n_negatives), -1, np.int32), step=-1, version=0
    )


class NegativeTableBuffer:
    """Atomic-swap publication point between the miner and the loader."""

    def __init__(self, table: NegativeTable):
        self._table = table

    def read(self) -> NegativeTable:
        """The current table — one reference read; index the result, don't
        re-read mid-batch (two reads may straddle a swap)."""
        return self._table

    def swap(self, table: NegativeTable) -> NegativeTable:
        """Publish ``table``; returns the table it replaced. Shape must be
        stable — readers bake the column count into batch shapes."""
        old = self._table
        if table.ids.shape != old.ids.shape:
            raise ValueError(
                f"table shape changed across swap: {old.ids.shape} -> "
                f"{table.ids.shape}; readers assume a stable layout"
            )
        self._table = table
        return old
