"""InfoNCE with in-batch negatives for dual-encoder retrieval (paper Eq. 1/4),
the plain functions of ``repro.core.infonce``.

``q`` (M, d) are the rows, ``p`` (N, d) the columns
(``[positives (B), hard negatives (B*h), extra negatives ...]``),
``labels[i]`` the positive column of row i (default ``arange(M)``).
Invalid columns get the finite ``NEG_INF``; invalid rows contribute zero
loss and the mean is over valid rows, so the bank warm-up is exact. Logits
are q . p / temperature; every reduction is in fp32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.precision import NEG_INF, STATS_DTYPE


class InfoNCEOutput(NamedTuple):
    loss: torch.Tensor          # scalar
    per_row_loss: torch.Tensor  # (M,)
    lse: torch.Tensor           # (M,) logsumexp over valid columns
    pos_logit: torch.Tensor     # (M,) logit of the positive column
    accuracy: torch.Tensor      # scalar: rows whose argmax is the label
    n_valid_rows: torch.Tensor  # scalar


def similarity_logits(
    q: torch.Tensor,
    p: torch.Tensor,
    *,
    temperature: float = 1.0,
    col_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(M, N) fp32 logits (products of the inputs accumulated in fp32),
    invalid columns at NEG_INF."""
    logits = q.to(STATS_DTYPE) @ p.to(STATS_DTYPE).T
    logits = logits / temperature
    if col_mask is not None:
        logits = torch.where(col_mask[None, :], logits, NEG_INF)
    return logits


def info_nce(
    q: torch.Tensor,
    p: torch.Tensor,
    *,
    labels: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    row_mask: Optional[torch.Tensor] = None,
    col_mask: Optional[torch.Tensor] = None,
) -> InfoNCEOutput:
    """Cross-entropy of each query row against its positive column."""
    m = q.shape[0]
    if labels is None:
        labels = torch.arange(m, device=q.device)
    labels = labels.long()
    logits = similarity_logits(q, p, temperature=temperature, col_mask=col_mask)
    lse = torch.logsumexp(logits, dim=-1)
    # clip: masked-out rows may carry out-of-range labels (bank rows with no
    # aligned passage), as the JAX gather's mode="clip"
    pos = logits.gather(1, labels.clamp(0, p.shape[0] - 1)[:, None])[:, 0]
    per_row = lse - pos
    if row_mask is None:
        row_mask = torch.ones((m,), dtype=torch.bool, device=q.device)
    row_mask_f = row_mask.to(STATS_DTYPE)
    n_valid = torch.clamp(row_mask_f.sum(), min=1.0)
    loss = torch.sum(per_row * row_mask_f) / n_valid
    preds = logits.argmax(dim=-1)
    acc = torch.sum((preds == labels) * row_mask_f) / n_valid
    return InfoNCEOutput(
        loss=loss,
        per_row_loss=per_row,
        lse=lse,
        pos_logit=pos,
        accuracy=acc,
        n_valid_rows=n_valid,
    )


def in_batch_loss(
    q: torch.Tensor,
    p_pos: torch.Tensor,
    p_hard: Optional[torch.Tensor] = None,
    *,
    temperature: float = 1.0,
) -> InfoNCEOutput:
    """DPR-style loss: positives on the diagonal, hard negatives appended as
    columns. q: (B, d); p_pos: (B, d); p_hard: (B*h, d) or None."""
    cols = p_pos if p_hard is None else torch.cat([p_pos, p_hard], dim=0)
    return info_nce(q, cols, temperature=temperature)


def extended_loss(
    q_local: torch.Tensor,
    p_pos: torch.Tensor,
    p_hard: Optional[torch.Tensor],
    bank_q_buf: Optional[torch.Tensor],
    bank_q_valid: Optional[torch.Tensor],
    bank_p_buf: Optional[torch.Tensor],
    bank_p_valid: Optional[torch.Tensor],
    *,
    temperature: float = 1.0,
) -> InfoNCEOutput:
    """ContAccum's extended similarity matrix (paper Eq. 5-7).

    Rows    = [local queries (B)] ++ [bank queries (Cq)]
    Columns = [local positives (B)] ++ [local hard negatives (B*h)] ++ [bank passages (Cp)]

    Bank query row i's positive is bank passage i (lockstep pushes). Rows of
    bank queries without an aligned valid passage, and invalid bank
    columns, are masked out exactly."""
    dev = q_local.device
    b = q_local.shape[0]
    row_parts = [q_local]
    row_mask_parts = [torch.ones((b,), dtype=torch.bool, device=dev)]
    col_parts = [p_pos]
    n_pos = p_pos.shape[0]
    col_mask_parts = [torch.ones((n_pos,), dtype=torch.bool, device=dev)]
    if p_hard is not None and p_hard.shape[0] > 0:
        col_parts.append(p_hard)
        col_mask_parts.append(torch.ones((p_hard.shape[0],), dtype=torch.bool, device=dev))
    n_hard = 0 if p_hard is None else p_hard.shape[0]

    cq = 0 if bank_q_buf is None else bank_q_buf.shape[0]
    cp = 0 if bank_p_buf is None else bank_p_buf.shape[0]

    if cp > 0:
        col_parts.append(bank_p_buf)
        col_mask_parts.append(bank_p_valid)
    if cq > 0:
        row_parts.append(bank_q_buf)
        aligned = torch.zeros((cq,), dtype=torch.bool, device=dev)
        if cp > 0:
            c_align = min(cq, cp)
            aligned[:c_align] = bank_q_valid[:c_align] & bank_p_valid[:c_align]
        row_mask_parts.append(aligned)

    labels = [torch.arange(b, device=dev)]
    if cq > 0:
        labels.append(n_pos + n_hard + torch.arange(cq, device=dev) % max(cp, 1))
    dt = torch.promote_types(q_local.dtype, p_pos.dtype)
    return info_nce(
        torch.cat([x.to(dt) for x in row_parts], dim=0),
        torch.cat([x.to(dt) for x in col_parts], dim=0),
        labels=torch.cat(labels),
        temperature=temperature,
        row_mask=torch.cat(row_mask_parts),
        col_mask=torch.cat(col_mask_parts),
    )
