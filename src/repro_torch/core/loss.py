"""The contrastive step loss shared by every update method, the port of
``repro.core.loss`` (single device).

One loss assembly covers plain in-batch negatives (DPR / GradAccum /
GradCache), ContAccum's extended matrix (dual banks, paper Eq. 5-7) and the
pre-batch ablation (passage-only bank). A ``NegativeSource`` describes its
negatives with two blocks, ``ExtraColumns`` (extra similarity columns +
validity) and ``ExtraRows`` (extra query rows + their labels into the
extra-column block + row weights), and ``contrastive_loss`` assembles:

  rows    = [ queries (B) ] ++ [ extra rows (R) ]
  columns = [ positives (B) ] ++ [ hard negatives (B*H) ] ++ [ extra columns (C) ]

Query i's label is column i; extra row j's is B*(1+H) + labels[j].

The per-row softmax statistics come from a ``LossBackend``: ``dense``
materialises the (M, N) fp32 logits; ``fused`` streams them through the
hand-written CUDA kernels of kernels/fused_infonce (their plain version on
CPU tensors). Both return fp32 statistics whatever the input types.

Not yet ported (multi-device): the ring-streamed loss (``ExtraColumns`` with
``sharded=True``) and the sharded-bank blocks; they raise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Protocol, Tuple, Union

import torch

from repro_torch.core.dist import DistCtx
from repro_torch.core.memory_bank import BankState, aligned_valid, columns_view
from repro_torch.core.precision import NEG_INF, STATS_DTYPE, PrecisionPolicy, resolve_precision


class LossAux(NamedTuple):
    loss: torch.Tensor          # scalar loss (detached)
    accuracy: torch.Tensor      # accuracy over valid rows
    n_rows: torch.Tensor        # number of rows in the mean
    n_negatives: torch.Tensor   # valid columns - 1 (negatives per query)
    q_global: torch.Tensor      # query reps (for the bank push), detached
    p_global: torch.Tensor      # positive-passage reps (for the bank push), detached


class ExtraColumns(NamedTuple):
    """Extra similarity columns owned by a negative source (e.g. a passage
    bank); ``valid`` masks slots exactly. ``sharded=True`` (a bank shard
    streamed around a device ring) is not yet ported."""

    reps: torch.Tensor   # (C, d)
    valid: torch.Tensor  # (C,) bool
    sharded: bool = False


class ExtraRows(NamedTuple):
    """Extra query rows owned by a negative source (e.g. a query bank).
    ``labels`` index into the source's ExtraColumns block; ``weight`` in
    [0, 1] scales each row's contribution (0 masks it out)."""

    reps: torch.Tensor    # (R, d)
    labels: torch.Tensor  # (R,) int: positive's index within ExtraColumns
    weight: torch.Tensor  # (R,) fp32
    sharded: bool = False


class LossBackend(Protocol):
    """Per-row softmax statistics of one row block against the assembled
    columns. Inputs may be any float type; every statistic is fp32."""

    name: str

    def row_stats(self, q_rows, p_all, labels, col_mask, *, temperature
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(per_row_loss, correct): ``lse - pos`` per row (differentiable)
        and the detached argmax-accuracy indicator."""
        ...

    def chunk_stats(self, q_rows, p_chunk, labels, col_mask, *, temperature
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-chunk online-softmax state ``(lse, pos, amax)``; rows whose
        label lies outside the chunk get ``pos = 0`` with zero gradient.
        Stats of disjoint chunks compose with ``merge_row_stats``."""
        ...


def _dense_logits(q_rows, p, col_mask, temperature):
    logits = (q_rows.to(STATS_DTYPE) @ p.to(STATS_DTYPE).T) / temperature
    return torch.where(col_mask[None, :], logits, NEG_INF)


class DenseLossBackend:
    """One matmul materialises the (M, N) fp32 logits block: the reference
    path."""

    name = "dense"

    def row_stats(self, q_rows, p_all, labels, col_mask, *, temperature):
        logits = _dense_logits(q_rows, p_all, col_mask, temperature)
        labels = labels.long()
        lse = torch.logsumexp(logits, dim=-1)
        pos = logits.gather(1, labels[:, None])[:, 0]
        correct = (logits.detach().argmax(dim=-1) == labels).to(STATS_DTYPE)
        return lse - pos, correct

    def chunk_stats(self, q_rows, p_chunk, labels, col_mask, *, temperature):
        logits = _dense_logits(q_rows, p_chunk, col_mask, temperature)
        n = p_chunk.shape[0]
        labels = labels.long()
        owns = (labels >= 0) & (labels < n)
        pos = logits.gather(1, labels.clamp(0, n - 1)[:, None])[:, 0]
        pos = torch.where(owns, pos, torch.zeros((), dtype=STATS_DTYPE, device=pos.device))
        return torch.logsumexp(logits, dim=-1), pos, logits.max(dim=-1).values


@dataclasses.dataclass(frozen=True)
class FusedLossBackend:
    """The hand-written CUDA kernels of kernels/fused_infonce: the logits
    live tile by tile in shared memory, never in device memory. On CPU
    tensors their plain version (ref.py) runs."""

    name = "fused"

    def _stats(self, q_rows, p, labels, col_mask, temperature):
        from repro_torch.kernels.fused_infonce.ops import fused_infonce_stats

        return fused_infonce_stats(
            q_rows.contiguous(), p.contiguous(), labels.to(torch.int32).contiguous(),
            col_mask.contiguous(), 1.0 / float(temperature),
        )

    def row_stats(self, q_rows, p_all, labels, col_mask, *, temperature):
        lse, pos, amax = self._stats(q_rows, p_all, labels, col_mask, temperature)
        # amax is metrics-only; on exact logit ties a tied positive counts as
        # correct here, where dense argmax takes the lowest column
        correct = (pos >= amax).to(STATS_DTYPE).detach()
        return lse - pos, correct

    def chunk_stats(self, q_rows, p_chunk, labels, col_mask, *, temperature):
        # out-of-range labels give pos = 0 and no gradient in the kernels
        return self._stats(q_rows, p_chunk, labels, col_mask, temperature)


LOSS_BACKENDS = {"dense": DenseLossBackend, "fused": FusedLossBackend}

_DENSE_BACKEND = DenseLossBackend()


def resolve_loss_backend(spec: Union[None, str, LossBackend] = None) -> LossBackend:
    """None -> dense; a registered name -> a fresh instance; an instance ->
    as is. Raises ValueError for unknown names."""
    if spec is None:
        return _DENSE_BACKEND
    if isinstance(spec, str):
        if spec not in LOSS_BACKENDS:
            raise ValueError(f"unknown loss_impl {spec!r}; one of {sorted(LOSS_BACKENDS)}")
        return LOSS_BACKENDS[spec]()
    return spec


def contrastive_loss(
    q_local: torch.Tensor,
    p_pos_local: torch.Tensor,
    p_hard_local: Optional[torch.Tensor] = None,
    *,
    extra_cols: Optional[ExtraColumns] = None,
    extra_rows: Optional[ExtraRows] = None,
    temperature: float = 1.0,
    ctx: Optional[DistCtx] = None,
    backend: Union[None, str, LossBackend] = None,
    precision: Union[None, str, PrecisionPolicy] = None,
) -> Tuple[torch.Tensor, LossAux]:
    """(loss, aux). ``backend`` picks the softmax statistics (None -> dense).
    ``precision`` is the one place the loss casts: local reps to
    ``compute_dtype``, extra blocks (bank buffers in ``bank_dtype``) to
    match. Statistics and row reductions stay fp32."""
    ctx = ctx or DistCtx()
    be = resolve_loss_backend(backend)
    if extra_cols is not None and extra_cols.sharded:
        raise NotImplementedError(
            "ExtraColumns(sharded=True), the ring-streamed loss, is not yet ported to repro_torch"
        )
    if extra_rows is not None and extra_rows.sharded:
        raise NotImplementedError("sharded ExtraRows are not yet ported to repro_torch")
    if precision is not None:
        pol = resolve_precision(precision)
        q_local = pol.cast_compute(q_local)
        p_pos_local = pol.cast_compute(p_pos_local)
        p_hard_local = pol.cast_compute(p_hard_local)
    dev = q_local.device
    b_local = q_local.shape[0]

    p_pos = ctx.gather(p_pos_local)
    cols = [p_pos]
    if p_hard_local is not None and p_hard_local.shape[0] > 0:
        cols.append(ctx.gather(p_hard_local))
    b_g = p_pos.shape[0]
    n_hard = 0 if len(cols) == 1 else cols[1].shape[0]
    n_extra = 0 if extra_cols is None else extra_cols.reps.shape[0]
    if n_extra > 0:
        cols.append(extra_cols.reps.to(p_pos.dtype))
    p_all = torch.cat(cols, dim=0)
    col_mask = torch.ones((b_g + n_hard,), dtype=torch.bool, device=dev)
    if n_extra > 0:
        col_mask = torch.cat([col_mask, extra_cols.valid], dim=0)

    labels_local = ctx.shard_index() * b_local + torch.arange(b_local, device=dev)
    per_row, correct = be.row_stats(q_local, p_all, labels_local, col_mask,
                                    temperature=temperature)
    loss_sum = per_row.sum()
    correct_sum = correct.sum()
    n_rows_dev = torch.full((), float(b_local), dtype=STATS_DTYPE, device=dev)

    if extra_rows is not None and extra_rows.reps.shape[0] > 0 and n_extra > 0:
        labels_extra = (b_g + n_hard + extra_rows.labels.long()) % (b_g + n_hard + n_extra)
        w = extra_rows.weight.to(STATS_DTYPE)
        inv_d = 1.0 / ctx.device_count()
        per_row_x, correct_x = be.row_stats(
            extra_rows.reps.to(q_local.dtype), p_all, labels_extra, col_mask,
            temperature=temperature,
        )
        loss_sum = loss_sum + inv_d * torch.sum(per_row_x * w)
        correct_sum = correct_sum + inv_d * torch.sum(correct_x * w)
        n_rows_dev = n_rows_dev + inv_d * w.sum()
    n_cols_valid = col_mask.sum().to(STATS_DTYPE)

    n_rows_g = torch.clamp(ctx.psum(n_rows_dev).detach(), min=1.0)
    loss_dev = loss_sum / n_rows_g
    aux = LossAux(
        loss=ctx.psum(loss_dev).detach(),
        accuracy=(ctx.psum(correct_sum) / n_rows_g).detach(),
        n_rows=n_rows_g,
        n_negatives=n_cols_valid - 1.0,
        q_global=ctx.gather(q_local).detach(),
        p_global=p_pos.detach(),
    )
    return loss_dev, aux


def bank_extra_columns(bank_p: Optional[BankState]) -> Optional[ExtraColumns]:
    """Passage bank -> extra similarity columns (None when disabled)."""
    if bank_p is None or bank_p.buf.shape[0] == 0:
        return None
    reps, valid = columns_view(bank_p)
    return ExtraColumns(reps=reps, valid=valid)


def bank_extra_rows(
    bank_q: Optional[BankState], bank_p: Optional[BankState]
) -> Optional[ExtraRows]:
    """Dual banks -> extra query rows labeled with their lockstep-aligned
    positives in the passage bank (None unless both banks are enabled)."""
    if bank_q is None or bank_q.buf.shape[0] == 0:
        return None
    if bank_p is None or bank_p.buf.shape[0] == 0:
        return None
    cq = bank_q.buf.shape[0]
    return ExtraRows(
        reps=bank_q.buf,
        labels=torch.arange(cq, dtype=torch.int32, device=bank_q.buf.device),
        weight=aligned_valid(bank_q, bank_p).to(STATS_DTYPE),
    )


def contrastive_step_loss(
    q_local: torch.Tensor,
    p_pos_local: torch.Tensor,
    p_hard_local: Optional[torch.Tensor],
    bank_q: Optional[BankState],
    bank_p: Optional[BankState],
    *,
    temperature: float = 1.0,
    ctx: Optional[DistCtx] = None,
    backend: Union[None, str, LossBackend] = None,
    precision: Union[None, str, PrecisionPolicy] = None,
) -> Tuple[torch.Tensor, LossAux]:
    """Bank-taking entry point: dual banks -> extras -> loss."""
    return contrastive_loss(
        q_local,
        p_pos_local,
        p_hard_local,
        extra_cols=bank_extra_columns(bank_p),
        extra_rows=bank_extra_rows(bank_q, bank_p),
        temperature=temperature,
        ctx=ctx,
        backend=backend,
        precision=precision,
    )
