"""Retrieval data: the deterministic planted-relevance corpus.

The port's own copy of ``repro.data.retrieval.SyntheticRetrievalCorpus``:
each passage is a token sequence whose query is a noisy subsequence, and
hard negatives share a topic prefix with the positive. It gives the same
arrays as the original from the same seed (tests/test_torch_retrieval.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticRetrievalCorpus:
    n_passages: int = 2048
    vocab_size: int = 1000
    q_len: int = 16
    p_len: int = 32
    n_topics: int = 32
    n_hard: int = 1
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # topic prefix (first 4 tokens) + content
        self.topics = rng.integers(10, self.vocab_size, size=(self.n_topics, 4))
        topic_of = rng.integers(0, self.n_topics, size=self.n_passages)
        self.passages = np.zeros((self.n_passages, self.p_len), np.int32)
        self.passages[:, 0] = 1  # CLS
        self.passages[:, 1:5] = self.topics[topic_of]
        self.passages[:, 5:] = rng.integers(
            10, self.vocab_size, size=(self.n_passages, self.p_len - 5)
        )
        self.topic_of = topic_of
        # queries: noisy subsequences of their positive passage
        self.queries = np.zeros((self.n_passages, self.q_len), np.int32)
        self.queries[:, 0] = 1
        for i in range(self.n_passages):
            take = rng.choice(
                np.arange(1, self.p_len), size=self.q_len - 1, replace=False
            )
            q = self.passages[i, np.sort(take)].copy()
            flip = rng.random(self.q_len - 1) < 0.1
            q[flip] = rng.integers(10, self.vocab_size, size=int(flip.sum()))
            self.queries[i, 1:] = q
        # hard negatives: same topic, different passage
        self.hard = np.zeros((self.n_passages, self.n_hard), np.int32)
        for i in range(self.n_passages):
            same = np.flatnonzero(topic_of == topic_of[i])
            same = same[same != i]
            if len(same) == 0:
                same = np.array([(i + 1) % self.n_passages])
            self.hard[i] = rng.choice(same, size=self.n_hard, replace=True)

    def batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """Assemble a RetrievalBatch-shaped dict of numpy arrays."""
        return {
            "query": self.queries[idx],
            "passage_pos": self.passages[idx],
            "passage_hard": self.passages[self.hard[idx]].reshape(
                len(idx), self.n_hard, self.p_len
            ),
        }

    def eval_split(self, n: int = 256) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(queries, all_passages, gold_passage_index) for top@k eval."""
        idx = np.arange(self.n_passages - n, self.n_passages)
        return self.queries[idx], self.passages, idx
