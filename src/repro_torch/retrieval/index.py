"""IndexStore: the encoded corpus on the device, in the policy's index dtype.

The offline half of serving: ``build_index_store`` encodes the corpus with
the passage tower in fixed batches and stores the rows in the policy's
``bank_dtype`` (a bf16 index is half the bytes; scores stay fp32 at the
backend contract). This slice of the port has the replicated layout only:
one device holds every row.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Union

import numpy as np
import torch

#: token rows: a host array, or a tensor already on the encoder's device
Tokens = Union[np.ndarray, torch.Tensor]


class IndexStore(NamedTuple):
    """reps: (rows, d) on the device, in the index dtype. row_valid: (rows,)
    bool, False for rows that must never be returned."""

    reps: torch.Tensor
    row_valid: torch.Tensor

    def bytes_per_device(self) -> int:
        """Persistent index bytes on the device (replicated layout)."""
        return self.reps.numel() * self.reps.element_size()


def pad_batch(chunk: Tokens, batch: int) -> Tokens:
    """A chunk of fewer than ``batch`` rows padded by repeating its last row
    (numpy rows, or a tensor's on its device); a full chunk as it is."""
    short = batch - len(chunk)
    if short <= 0:
        return chunk
    if isinstance(chunk, torch.Tensor):
        return torch.cat([chunk, chunk[-1:].expand(short, *chunk.shape[1:])])
    return np.concatenate([chunk, np.repeat(chunk[-1:], short, axis=0)])


def encode_corpus(
    encode_passage: Callable[[Tokens], torch.Tensor],
    passages: Tokens,
    *,
    batch: int = 256,
) -> torch.Tensor:
    """Encode a corpus (numpy token rows, or a tensor of them already on the
    device) in fixed batches (the tail is padded by repeating its last row,
    so every call has one shape). Returns the (n, d) reps on the encoder's
    device."""
    n = len(passages)
    out: List[torch.Tensor] = []
    for lo in range(0, n, batch):
        out.append(encode_passage(pad_batch(passages[lo : lo + batch], batch)))
    return torch.cat(out)[:n].contiguous()


def build_index_store(
    encode_passage: Callable[[Tokens], torch.Tensor],
    passages: Tokens,
    *,
    batch: int = 256,
    dtype: Any = torch.float32,
) -> IndexStore:
    """Encode, cast to the index dtype, and keep the rows where the encoder
    put them (the Retriever's device)."""
    reps = encode_corpus(encode_passage, passages, batch=batch).to(dtype)
    valid = torch.ones((reps.shape[0],), dtype=torch.bool, device=reps.device)
    return IndexStore(reps=reps, row_valid=valid)
