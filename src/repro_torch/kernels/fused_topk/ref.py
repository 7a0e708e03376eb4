"""Plain PyTorch version of the fused top-k kernel: the semantic contract.

Materialises the (Q, N) score matrix, a chunk of query rows at a time, and
takes a stable descending sort of each row:

  * q and p are upcast to fp32 before the product, so the scores are the
    fp32-accumulated products the kernel computes (a bf16 ``torch.matmul``
    would round its output to bf16);
  * invalid columns (``col_valid`` False) score ``NEG_INF`` and never win;
  * ties go to the lowest column id (a stable sort; ``torch.topk`` does not
    promise an order among ties);
  * slots with no valid candidate (k > n_valid) are (``NEG_INF``, -1).

The CPU tests and ``chip_smoke.py`` hold the kernel against it; the main path
never calls it on a GPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.precision import NEG_INF, SCORE_DTYPE

#: (Q-chunk, N) fp32 score bytes the reference materialises at once.
CHUNK_BYTES = 1 << 30


def topk_scores_ref(
    q: torch.Tensor,                       # (Q, d)
    p: torch.Tensor,                       # (N, d)
    k: int,
    *,
    col_valid: Optional[torch.Tensor] = None,   # (N,) bool
    inv_tau: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (scores (Q, k) fp32, ids (Q, k) int32); ids -1 mark empty slots."""
    n_q, n = q.shape[0], p.shape[0]
    width = max(n, k)
    rows = max(1, CHUNK_BYTES // (4 * width))
    pf = p.to(SCORE_DTYPE)
    out_s, out_i = [], []
    for lo in range(0, n_q, rows):
        s = (q[lo : lo + rows].to(SCORE_DTYPE) @ pf.T) * inv_tau
        if col_valid is not None:
            s = s.masked_fill(~col_valid[None, :], NEG_INF)
        if k > n:
            s = torch.nn.functional.pad(s, (0, k - n), value=NEG_INF)
        scores, ids = torch.sort(s, dim=1, descending=True, stable=True)
        scores, ids = scores[:, :k], ids[:, :k].to(torch.int32)
        out_s.append(scores)
        out_i.append(torch.where(scores > NEG_INF / 2, ids, -1))
    return torch.cat(out_s), torch.cat(out_i)


def topk_mismatch(
    scores: torch.Tensor,
    ids: torch.Tensor,
    ref_scores: torch.Tensor,
    ref_ids: torch.Tensor,
    atol: float,
) -> Tuple[float, int, int]:
    """(max |score - ref score|, id mismatches at clear slots, clear slots).

    ``scores``/``ids`` hold k slots, the reference k + 1 (or k when k covers
    every column). A slot is clear when its reference score is more than
    ``2 * atol`` from both neighbours, the (k+1)-th included, or when it is
    empty (reference id -1): there, a result within ``atol`` of the
    reference must return the reference's id. Near ties may legitimately
    swap under another summation order; the count of clear slots says how
    much of the id check was not vacuous."""
    k = scores.shape[1]
    err = (scores.float() - ref_scores[:, :k].float()).abs().max().item()
    s = ref_scores.float()
    sep = (s[:, :-1] - s[:, 1:]) > 2 * atol      # slot j clear of slot j + 1
    clear = torch.ones_like(s, dtype=torch.bool)
    clear[:, 1:] &= sep
    clear[:, :-1] &= sep
    clear = clear[:, :k] | (ref_ids[:, :k] < 0)
    bad = (ids != ref_ids[:, :k]) & clear
    return err, int(bad.sum().item()), int(clear.sum().item())
