"""Plain PyTorch version of the embedding-bag kernel: the semantic contract
(``repro.kernels.embedding_bag``: ``embedding_bag_ref``, and ``ops`` for the
empty bags).

``out[b]`` is the sum of ``table[indices[i]]`` over the lookups i with
``bag_ids[i] == b``, taken in the table's dtype one lookup at a time in
lookup order (the TPU kernel's order: bf16 rounds after every add), and 0
for a bag with no lookups. Any bag order is taken, as ``segment_sum`` takes
it; bag ids outside [0, n_bags) are left out, as ``segment_sum`` leaves them.

Also ``embedding_bag_error``, the comparison the CUDA tests and
``chip_smoke.py`` make: whether the kernel's output equals this version's
(their contract: the same adds in the same order and dtype, so fp32 and
bf16 alike must be bit-equal), with the largest error and the worst share
used of a rounding allowance from the bag sums of |row|, reported as a
diagnostic: fp32 ``FP32_RTOL`` of them, bf16 2^-8 n_bag of them per element
(an upper bound of sequential rounding to bf16: each of the n_bag adds
rounds by at most 2^-8 of a partial sum, itself at most the sum of |row|).
"""

from __future__ import annotations

import torch

FP32_RTOL = 1e-6
BF16_STEP = 2.0 ** -8


def embedding_bag_ref(
    table: torch.Tensor,     # (V, D)
    indices: torch.Tensor,   # (L,) rows to gather
    bag_ids: torch.Tensor,   # (L,) the bag of each lookup
    n_bags: int,
) -> torch.Tensor:
    """(n_bags, D) bag sums in the table's dtype."""
    out = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype, device=table.device)
    bags = bag_ids.long()
    keep = (bags >= 0) & (bags < n_bags)
    bags, idx = bags[keep], indices.long()[keep]
    if bags.numel() == 0:
        return out
    order = torch.argsort(bags, stable=True)     # each bag's lookups keep their order
    bags, rows = bags[order], table[idx[order]]
    counts = torch.bincount(bags, minlength=n_bags)
    rank = torch.arange(bags.numel(), device=bags.device) - (torch.cumsum(counts, 0) - counts)[bags]
    # the j-th lookup of every bag that has one, for j = 0, 1, ...: one add a
    # bag per round, in the table's dtype
    by_rank = torch.argsort(rank, stable=True)
    lo = 0
    for n_j in torch.bincount(rank).tolist():
        sel = by_rank[lo : lo + n_j]
        out[bags[sel]] += rows[sel]              # bags are distinct within a round
        lo += n_j
    return out


def embedding_bag_error(
    out: torch.Tensor,
    table: torch.Tensor,
    indices: torch.Tensor,
    bag_ids: torch.Tensor,
    n_bags: int,
) -> dict:
    """``out`` against the plain version: the max abs error, whether they are
    equal, and the worst share of the rounding allowance used: fp32
    ``FP32_RTOL`` s, bf16 ``BF16_STEP`` n_bag s per element, s the bag's sum
    of |row| in fp32 and n_bag its lookups."""
    want = embedding_bag_ref(table, indices, bag_ids, n_bags)
    bags = bag_ids.long()
    keep = (bags >= 0) & (bags < n_bags)
    bags, idx = bags[keep], indices.long()[keep]
    s = torch.zeros((n_bags, table.shape[1]), dtype=torch.float32, device=table.device)
    s.index_add_(0, bags, table[idx].float().abs())
    if table.dtype == torch.float32:
        allowance = FP32_RTOL * s
    else:
        n_bag = torch.bincount(bags, minlength=n_bags).float()[:, None]
        allowance = BF16_STEP * n_bag * s
    err = (out.float() - want.float()).abs()
    # an element with no allowance (an empty bag, or only zero rows) must be exact
    share = torch.where(allowance > 0, err / allowance.clamp(min=1e-38),
                        torch.where(err > 0, float("inf"), 0.0))
    return {
        "max_abs_err": err.max().item() if err.numel() else 0.0,
        "equal": bool(torch.equal(out, want)),
        "worst": share.max().item() if share.numel() else 0.0,
    }
