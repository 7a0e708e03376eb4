"""Deterministic sharded data loader with checkpointable state: the port's
own copy of ``repro.data.loader`` (numpy only, the same index stream).

Index stream: a per-epoch permutation keyed by (seed, epoch); each host
takes a strided slice (host_id :: n_hosts) of every global batch, so the
union over hosts is the global batch. State = (epoch, step) plus the mined
table's staleness stamps, four ints saved with the checkpoint. The
prefetch thread and the mined-negative injector wait for the slices that
need them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
