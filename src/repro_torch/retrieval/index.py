"""IndexStore: the encoded corpus on the device, in the policy's index dtype.

The offline half of serving: ``build_index_store`` encodes the corpus with
the passage tower in fixed batches and stores the rows in the policy's
``bank_dtype`` (a bf16 index is half the bytes; scores stay fp32 at the
backend contract). Two layouts, as in ``repro.retrieval.index``:

  * **replicated** - the device holds every row;
  * **sharded** - the rows are padded to a multiple of the rank count D
    with zero rows whose ``row_valid`` is False, and rank r holds only its
    contiguous block of ``rows_per_shard`` rows, from r * rows_per_shard.
    The whole matrix never lands on one device: a rank encodes only the
    fixed batches that overlap its block (batches start at multiples of
    ``batch`` from row 0, as in the replicated build, so each row is the
    same bits in both layouts) and keeps its own rows.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Union

import numpy as np
import torch

#: token rows: a host array, or a tensor already on the encoder's device
Tokens = Union[np.ndarray, torch.Tensor]


class IndexStore(NamedTuple):
    """The encoded corpus in its layout.

    reps:      (rows, d) on the device, in the index dtype: every row
               (``shard`` None), or rank ``shard``'s block of
               ``rows_per_shard`` rows.
    row_valid: (rows,) bool, False for rows that must never be returned
               (the padding).
    n_total:   the corpus's real row count.
    shards:    the ranks the rows are laid out over (1 = replicated); the
               rows of the whole index are padded to a multiple of it.
    shard:     the rank whose block ``reps`` holds; None when it holds
               every row.
    """

    reps: torch.Tensor
    row_valid: torch.Tensor
    n_total: int
    shards: int = 1
    shard: Optional[int] = None

    @property
    def rows(self) -> int:
        """Rows of the whole index, padding included, over every shard."""
        return self.reps.shape[0] * (1 if self.shard is None else self.shards)

    @property
    def rows_per_shard(self) -> int:
        return self.rows // self.shards

    @property
    def row_offset(self) -> int:
        """The global id of ``reps``' first row."""
        return 0 if self.shard is None else self.shard * self.rows_per_shard

    def bytes_per_device(self) -> int:
        """Persistent index bytes on each device: the whole matrix's over
        ``shards``, as ``repro.retrieval.index.IndexStore`` reports them."""
        return self.rows * self.reps.shape[1] * self.reps.element_size() // self.shards

    def block(self, shard: int) -> "IndexStore":
        """Rank ``shard``'s rows of a store that holds every row: the store
        that rank holds under the sharded layout (views, no copy)."""
        if self.shard is not None:
            raise ValueError(f"the store holds shard {self.shard}'s block, not every row")
        if not 0 <= shard < self.shards:
            raise ValueError(f"shard {shard} outside [0, {self.shards})")
        lo, hi = shard * self.rows_per_shard, (shard + 1) * self.rows_per_shard
        return self._replace(reps=self.reps[lo:hi], row_valid=self.row_valid[lo:hi],
                             shard=shard)


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
    shards: int = 1,
    shard: Optional[int] = None,
) -> IndexStore:
    """Encode, cast to the index dtype, pad the rows to a multiple of
    ``shards`` (padding rows are zeros, masked by ``row_valid``) and keep
    them where the encoder put them (the Retriever's device). With
    ``shard`` only that rank's block is encoded and kept."""
    n = len(passages)
    rows = -(-n // shards) * shards
    lo, hi = 0, rows
    if shard is not None:
        if not 0 <= shard < shards:
            raise ValueError(f"shard {shard} outside [0, {shards})")
        lo, hi = shard * (rows // shards), (shard + 1) * (rows // shards)
    # the fixed batches that overlap [lo, min(hi, n)); a block of padding
    # only encodes the last batch, for the rows' width and type
    first = min(lo, n - 1) // batch * batch
    end = min(-(-min(hi, n) // batch) * batch, n)
    reps = encode_corpus(encode_passage, passages[first:end], batch=batch)
    reps = reps[lo - first : min(hi, n) - first].to(dtype)
    pad = hi - lo - reps.shape[0]
    if pad or shard is not None:        # a block keeps its own rows only
        reps = torch.cat([reps, reps.new_zeros((pad, reps.shape[1]))])
    valid = torch.arange(lo, hi, device=reps.device) < n
    return IndexStore(reps=reps, row_valid=valid, n_total=n, shards=shards, shard=shard)
