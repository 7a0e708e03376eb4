"""Dual FIFO memory banks for ContAccum (paper Sec. 3.2, Fig. 2), the port
of ``repro.core.memory_bank``.

Ring buffers of fixed shape with a ``valid`` mask, so the warm-up phase
(bank not yet full) is exact: unfilled slots are excluded from the softmax
and from the row mean. The *dual* structure (equal-size query and passage
banks, pushed in lockstep) is the paper's stability contribution.

Pushes are functional, as in the JAX package: ``push`` returns a new
``BankState`` and leaves the old one as it was (``index_copy``, not
``index_copy_``). That is a choice, not an accident: the query-bank buffer
is the ``q`` that ``fused_infonce_stats`` saves for its backward, so an
in-place write before that chunk's backward has run would trip autograd's
version check, and a caller's old state would change under it. The copy
costs one bank (2048 x 768 bf16 = 3 MiB) per push.

Buffers are stored in the PrecisionPolicy's ``bank_dtype``; pushes cast the
incoming rows to it here and the loss casts reads back to its compute dtype.

Two distribution modes (core/step_program.py, ``cfg.shard_banks``):
replicated, where every rank carries the full ring and pushes the gathered
global rows (``push``/``push_pair``), and sharded, where each rank owns a
``capacity/D`` contiguous block of ring slots, laid out shard-major so that
``DistCtx.gather`` over the shards gives the replicated ring
(``shard_push``/``shard_push_pair``). A rank's state holds its own block
only: JAX's ``bank_spec`` (a PartitionSpec over one global array) has no
counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.precision import resolve_precision


class BankState(NamedTuple):
    buf: torch.Tensor    # (capacity, d) stored representations
    valid: torch.Tensor  # (capacity,) bool: slot holds a real representation
    head: torch.Tensor   # () int32: next write position (ring)
    age: torch.Tensor    # (capacity,) int32: step counter at push time


def init_bank(
    capacity: int,
    dim: int,
    dtype: Optional[torch.dtype] = None,
    *,
    device: Union[str, torch.device],
) -> BankState:
    if dtype is None:
        dtype = resolve_precision(None).bank_dtype
    return BankState(
        buf=torch.zeros((capacity, dim), dtype=dtype, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        head=torch.zeros((), dtype=torch.int32, device=device),
        age=torch.zeros((capacity,), dtype=torch.int32, device=device),
    )


def push(bank: BankState, x: torch.Tensor, step: Union[torch.Tensor, int] = 0) -> BankState:
    """Enqueue rows of ``x`` (n, d), dequeueing the oldest when full.

    ``x`` is stored detached: bank entries never carry activations (paper
    Eq. 5-6, sg(.)). n may exceed capacity; the last ``capacity`` rows win.
    Oversized pushes are pre-sliced to those rows before the indexed write,
    which (with duplicate ring indices) is not last-write-wins in torch
    either."""
    x = x.detach()
    n = x.shape[0]
    cap = bank.buf.shape[0]
    if n == 0 or cap == 0:
        return bank
    start = bank.head
    if n > cap:
        x = x[n - cap :]
        start = bank.head + (n - cap)
        n = cap
    idx = (start + torch.arange(n, dtype=torch.int32, device=x.device)) % cap
    idx = idx.long()
    step = torch.as_tensor(step, dtype=torch.int32, device=x.device)
    return BankState(
        buf=bank.buf.index_copy(0, idx, x.to(bank.buf.dtype)),
        valid=bank.valid.index_fill(0, idx, True),
        head=((start + n) % cap).to(torch.int32),
        age=bank.age.index_copy(0, idx, step.expand(n)),
    )


def clear(bank: BankState) -> BankState:
    """Invalidate all slots (the 'w/o past encoder' ablation clears the
    banks at every optimizer-update boundary)."""
    return BankState(
        buf=bank.buf,
        valid=torch.zeros_like(bank.valid),
        head=torch.zeros_like(bank.head),
        age=torch.zeros_like(bank.age),
    )


def n_valid(bank: BankState) -> torch.Tensor:
    return bank.valid.sum()


def push_pair(
    bank_q: BankState,
    bank_p: BankState,
    q: torch.Tensor,
    p: torch.Tensor,
    step: Union[torch.Tensor, int] = 0,
) -> Tuple[BankState, BankState]:
    """Push query/passage representations in lockstep so ring positions
    align: bank row i of M_q is the query whose positive is row i of M_p."""
    if q.shape[0] != p.shape[0]:
        raise ValueError("dual banks must be pushed in lockstep")
    return push(bank_q, q, step), push(bank_p, p, step)


def shard_push(
    bank: BankState,
    x: torch.Tensor,
    step: Union[torch.Tensor, int] = 0,
    *,
    shard_index: int,
    num_shards: int,
) -> BankState:
    """Shard-local ``push``: write only this rank's slots of a globally
    ring-addressed enqueue.

    ``bank`` is this rank's ``capacity_global / num_shards`` block of a
    global ring laid out shard-major (shard i owns global slots
    ``[i*cap_local, (i+1)*cap_local)``). ``x`` is the full global row block
    (every rank holds the same gathered rows) and ``bank.head`` the
    replicated *global* head, which every shard advances alike. The union
    of the shards after a shard_push equals a replicated ``push`` of the
    same rows.

    JAX scatters every row and drops the other shards' with an out-of-range
    index; on the card an out-of-range index asserts. Here each local slot
    picks its row instead: slot j (global g) takes row ``(g - start) mod
    cap_global`` of x where that is below n, and keeps its value elsewhere
    (a mask; no data-dependent shape, so no wait for the device)."""
    x = x.detach()
    n = x.shape[0]
    cap_local = bank.buf.shape[0]
    cap_global = cap_local * num_shards
    if n == 0 or cap_local == 0:
        return bank
    start = bank.head.long()
    if n > cap_global:
        x = x[n - cap_global :]
        start = start + (n - cap_global)
        n = cap_global
    gslot = shard_index * cap_local + torch.arange(cap_local, device=x.device)
    row = (gslot - start) % cap_global
    own = row < n
    taken = x.index_select(0, row.clamp(max=n - 1)).to(bank.buf.dtype)
    step = torch.as_tensor(step, dtype=torch.int32, device=x.device)
    return BankState(
        buf=torch.where(own[:, None], taken, bank.buf),
        valid=bank.valid | own,
        head=((start + n) % cap_global).to(torch.int32),
        age=torch.where(own, step, bank.age),
    )


def shard_push_pair(
    bank_q: BankState,
    bank_p: BankState,
    q: torch.Tensor,
    p: torch.Tensor,
    step: Union[torch.Tensor, int] = 0,
    *,
    shard_index: int,
    num_shards: int,
) -> Tuple[BankState, BankState]:
    """Lockstep ``shard_push`` of both banks (see push_pair)."""
    if q.shape[0] != p.shape[0]:
        raise ValueError("dual banks must be pushed in lockstep")
    kw = dict(shard_index=shard_index, num_shards=num_shards)
    return shard_push(bank_q, q, step, **kw), shard_push(bank_p, p, step, **kw)


def capacity(bank: BankState) -> int:
    """Capacity of the ring (0 for a disabled bank); a shard's own slots
    for a sharded bank."""
    return bank.buf.shape[0]


def columns_view(bank: BankState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(reps, valid) of a bank used as extra similarity columns (order is
    irrelevant for columns, so no roll)."""
    return bank.buf, bank.valid


def aligned_valid(bank_q: BankState, bank_p: BankState) -> torch.Tensor:
    """(cq,) bool: slots where bank_q row i and bank_p row i hold an aligned
    (query, positive) pair. Unequal non-zero capacities are rejected (the
    rings stop being aligned as soon as either wraps); a disabled bank
    (capacity 0) yields no aligned rows."""
    cq, cp = bank_q.buf.shape[0], bank_p.buf.shape[0]
    if cq == 0 or cp == 0:
        return torch.zeros((cq,), dtype=torch.bool, device=bank_q.buf.device)
    if cq != cp:
        raise ValueError(
            f"dual banks must have equal capacities to stay ring-aligned "
            f"(got bank_q capacity {cq} != bank_p capacity {cp}); after a "
            f"ring wrap row i of M_q no longer pairs with row i of M_p"
        )
    return bank_q.valid & bank_p.valid


def ordered(bank: BankState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(buf, valid) rolled so index 0 is the oldest entry (diagnostics)."""
    cap = bank.buf.shape[0]
    perm = ((bank.head + torch.arange(cap, dtype=torch.int32, device=bank.buf.device)) % cap).long()
    return bank.buf[perm], bank.valid[perm]
