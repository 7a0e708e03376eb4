"""Plain PyTorch version of the fused InfoNCE kernels: the semantic contract.

Materialises the (M, N) logits: q and p are upcast to fp32 before the
product (so the logits are the fp32-accumulated products the kernel takes),
scaled by ``inv_tau``, and invalid columns get the finite ``NEG_INF``. The
backward is this dense fp32 math differentiated by autograd.

One rule differs from the JAX package's ``infonce_stats_ref``: a label
outside [0, N) gives ``pos = 0`` and no one-hot term in the backward, as the
kernels (and ``DenseLossBackend.chunk_stats``) do; the JAX reference gathers
a clipped column instead. A label that points at a masked column gives
``pos = NEG_INF``, as both do. The CPU tests and ``chip_smoke.py`` hold the
kernels against this module; the main path never calls it on a GPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.precision import NEG_INF, STATS_DTYPE


def _logits(q, p, col_valid, inv_tau, dtype=STATS_DTYPE):
    logits = (q.to(dtype) @ p.to(dtype).T) * inv_tau
    if col_valid is not None:
        logits = torch.where(col_valid[None, :], logits, NEG_INF)
    return logits


def infonce_stats_ref(
    q: torch.Tensor,                             # (M, d)
    p: torch.Tensor,                             # (N, d)
    labels: torch.Tensor,                        # (M,) int
    col_valid: Optional[torch.Tensor] = None,    # (N,) bool
    *,
    inv_tau: float = 1.0,
    dtype: torch.dtype = STATS_DTYPE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lse, pos, amax) per row, fp32 (or ``dtype``, the type the logits
    are computed in: a wider one measures the fp32 kernels' own error); pos
    = 0 where the label is outside [0, N). Differentiable w.r.t. q and p
    (zero gradient through masked columns and through out-of-range
    labels)."""
    logits = _logits(q, p, col_valid, inv_tau, dtype)
    n = p.shape[0]
    labels = labels.long()
    owns = (labels >= 0) & (labels < n)
    pos = logits.gather(1, labels.clamp(0, n - 1)[:, None])[:, 0]
    pos = torch.where(owns, pos, torch.zeros((), dtype=dtype, device=pos.device))
    return torch.logsumexp(logits, dim=-1), pos, logits.max(dim=-1).values


def infonce_stats_vjp_ref(
    q: torch.Tensor,
    p: torch.Tensor,
    labels: torch.Tensor,
    col_valid: Optional[torch.Tensor],
    g_lse: torch.Tensor,                         # (M,) cotangent of lse
    g_pos: torch.Tensor,                         # (M,) cotangent of pos
    *,
    inv_tau: float = 1.0,
    dtype: Optional[torch.dtype] = None,
    lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dq, dp) of ``infonce_stats_ref`` for the given row cotangents, from
    autograd through the dense fp32 math, cast to q's and p's types; with
    ``dtype``, the math and the result in that type (float64: the reference
    that the fp32 kernels' and this function's own error are measured
    against). With ``lse`` (M,), the coefficients are taken against it, as
    the kernels' backward takes the forward's: exp(s - lse) g_lse +
    onehot(label) g_pos, zero on masked columns, times inv_tau."""
    ct = STATS_DTYPE if dtype is None else dtype
    if lse is not None:
        qc, pc = q.to(ct), p.to(ct)
        logits = _logits(qc, pc, col_valid, inv_tau, ct)
        coef = torch.exp(logits - lse.to(ct)[:, None]) * g_lse.to(ct)[:, None]
        n = p.shape[0]
        rows = torch.arange(q.shape[0], device=q.device)
        lab = labels.long()
        owns = (lab >= 0) & (lab < n)
        if col_valid is not None:
            owns &= col_valid[lab.clamp(0, n - 1)]
        coef[rows[owns], lab[owns]] += g_pos.to(ct)[owns]
        coef = coef * inv_tau
        dq, dp = coef @ pc, coef.T @ qc
        return (dq, dp) if dtype is not None else (dq.to(q.dtype), dp.to(p.dtype))
    with torch.enable_grad():
        qf = q.detach().to(ct).requires_grad_(True)
        pf = p.detach().to(ct).requires_grad_(True)
        lse, pos, _ = infonce_stats_ref(qf, pf, labels, col_valid, inv_tau=inv_tau, dtype=ct)
        dq, dp = torch.autograd.grad((lse, pos), (qf, pf), (g_lse.to(ct), g_pos.to(ct)))
    if dtype is not None:
        return dq, dp
    return dq.to(q.dtype), dp.to(p.dtype)


def infonce_rows_ref(q, p, labels, *, inv_tau: float = 1.0):
    """(lse, pos) per row, every column valid."""
    lse, pos, _ = infonce_stats_ref(q, p, labels, inv_tau=inv_tau)
    return lse, pos


def infonce_loss_ref(q, p, labels, *, inv_tau: float = 1.0):
    lse, pos = infonce_rows_ref(q, p, labels, inv_tau=inv_tau)
    return torch.mean(lse - pos)
