"""Criteo-like synthetic click logs with a planted logistic model: the
port's own copy of ``repro.data.recsys.ClickLogGenerator``, which gives the
same numpy arrays for the same seed and step (a test holds them equal).
Recsys training losses decrease on it, since the labels follow the planted
model."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.precision import HOST_FLOAT_DTYPE


@dataclasses.dataclass
class ClickLogGenerator:
    vocab_sizes: Tuple[int, ...]
    n_dense: int
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # planted model: per-field per-bucket logit contributions
        self._field_w = [rng.normal(scale=0.5, size=min(v, 1024)) for v in self.vocab_sizes]
        self._dense_w = rng.normal(scale=0.3, size=self.n_dense)
        self._zipf_a = 1.2

    def batch(self, batch_size: int, step: int) -> Dict[str, np.ndarray]:
        """dense (B, n_dense) float32, sparse (B, n_sparse) int32 per-field
        ids, labels (B,) float32 in {0, 1}."""
        rng = np.random.default_rng((self.seed, step))
        dense = rng.normal(size=(batch_size, self.n_dense)).astype(HOST_FLOAT_DTYPE)
        sparse = np.empty((batch_size, len(self.vocab_sizes)), np.int64)
        logit = dense @ self._dense_w
        for f, v in enumerate(self.vocab_sizes):
            # zipfian ids (hot rows dominate, like real CTR logs)
            ids = (rng.zipf(self._zipf_a, batch_size) - 1) % v
            sparse[:, f] = ids
            logit += self._field_w[f][ids % len(self._field_w[f])]
        prob = 1.0 / (1.0 + np.exp(-(logit - logit.mean())))
        labels = (rng.random(batch_size) < prob).astype(HOST_FLOAT_DTYPE)
        return {
            "dense": dense,
            "sparse": sparse.astype(np.int32),
            "labels": labels,
        }
