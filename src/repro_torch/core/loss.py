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

Across a data-parallel group (core/dist.py) the in-batch columns are
all-gathered and each rank reduces over its own rows; ``loss_dev`` is then
this rank's share, and the sum over the ranks is the global loss. Sharded
banks (``sharded_bank_extra_columns``/``_rows``) hand the loss this rank's
bank shard: its rows enter at full weight, and its columns are either
all-gathered into the global block or, with ``loss_comm='ring'``
(``ExtraColumns(sharded=True)``), streamed shard by shard around the ring
(``_ring_row_stats``): the same loss at one shard of transient memory.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Protocol, Tuple, Union

import torch

from repro_torch.core.dist import DistCtx
from repro_torch.core.memory_bank import BankState, aligned_valid, columns_view
from repro_torch.core.precision import NEG_INF, STATS_DTYPE, PrecisionPolicy, resolve_precision


class LossAux(NamedTuple):
    loss: torch.Tensor          # global scalar loss (summed over ranks, detached)
    accuracy: torch.Tensor      # global accuracy over valid rows
    n_rows: torch.Tensor        # global number of rows in the mean
    n_negatives: torch.Tensor   # valid columns - 1 (negatives per query)
    q_global: torch.Tensor      # gathered query reps (for the bank push), detached
    p_global: torch.Tensor      # gathered positive-passage reps (for the push), detached


class ExtraColumns(NamedTuple):
    """Extra similarity columns owned by a negative source (e.g. a passage
    bank); ``valid`` masks slots exactly. ``sharded=False``: ``reps`` is the
    whole (global) block. ``sharded=True``: ``reps`` is this rank's
    ``C_global / D`` shard of a block laid out shard-major over the ring
    (shard s owns global columns ``[s*C_local, (s+1)*C_local)``), and the
    loss streams the shards around the ring instead of gathering them."""

    reps: torch.Tensor   # (C, d)
    valid: torch.Tensor  # (C,) bool
    sharded: bool = False


class ExtraRows(NamedTuple):
    """Extra query rows owned by a negative source (e.g. a query bank).
    ``labels`` index into the source's ExtraColumns block in its global
    (gathered) layout; ``weight`` in [0, 1] scales each row's contribution
    (0 masks it out). ``sharded=False``: the rows are replicated on every
    rank, and each rank takes a 1/D share of them. ``sharded=True``: they
    are this rank's own partition of the global rows (a sharded query bank)
    and enter at full weight."""

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
    if precision is not None:
        pol = resolve_precision(precision)
        q_local = pol.cast_compute(q_local)
        p_pos_local = pol.cast_compute(p_pos_local)
        p_hard_local = pol.cast_compute(p_hard_local)
    dev = q_local.device
    b_local = q_local.shape[0]

    # columns, gathered over the ranks
    p_pos = ctx.gather(p_pos_local)
    cols = [p_pos]
    if p_hard_local is not None and p_hard_local.shape[0] > 0:
        cols.append(ctx.gather(p_hard_local))
    b_g = p_pos.shape[0]
    n_hard = 0 if len(cols) == 1 else cols[1].shape[0]

    # ring mode: extra_cols is this rank's bank shard; the global extra
    # block is the D shards streamed around the ring, never gathered
    ring = extra_cols is not None and extra_cols.sharded
    n_extra_local = 0 if extra_cols is None else extra_cols.reps.shape[0]
    n_extra = n_extra_local * ctx.device_count() if ring else n_extra_local
    if n_extra_local > 0 and not ring:
        cols.append(extra_cols.reps.to(p_pos.dtype))
    p_all = torch.cat(cols, dim=0)
    col_mask = torch.ones((b_g + n_hard,), dtype=torch.bool, device=dev)
    if n_extra_local > 0 and not ring:
        col_mask = torch.cat([col_mask, extra_cols.valid], dim=0)

    # local rows: this rank's queries
    labels_local = ctx.shard_index() * b_local + torch.arange(b_local, device=dev)
    have_extra_rows = extra_rows is not None and extra_rows.reps.shape[0] > 0 and n_extra > 0
    if have_extra_rows:
        labels_extra = (b_g + n_hard + extra_rows.labels.long()) % (b_g + n_hard + n_extra)
        w = extra_rows.weight.to(STATS_DTYPE)
        # replicated rows: each rank takes a 1/D share; sharded rows are
        # this rank's own partition, at full weight
        inv_d = 1.0 if extra_rows.sharded else 1.0 / ctx.device_count()
    n_rows_dev = torch.full((), float(b_local), dtype=STATS_DTYPE, device=dev)

    if ring:
        # the local queries and the bank rows in one pass of the ring
        rows, labels_all = [q_local], [labels_local]
        if have_extra_rows:
            rows.append(extra_rows.reps.to(q_local.dtype))
            labels_all.append(labels_extra)
        per_row, correct = _ring_row_stats(
            torch.cat(rows), torch.cat(labels_all), p_all, extra_cols, ctx, be,
            temperature=temperature,
        )
        loss_sum = per_row[:b_local].sum()
        correct_sum = correct[:b_local].sum()
        if have_extra_rows:
            loss_sum = loss_sum + inv_d * torch.sum(per_row[b_local:] * w)
            correct_sum = correct_sum + inv_d * torch.sum(correct[b_local:] * w)
            n_rows_dev = n_rows_dev + inv_d * w.sum()
        # the global column mask never exists: count the valid bank slots
        # with a sum over the shards
        n_cols_valid = float(b_g + n_hard) + ctx.psum(extra_cols.valid.sum().to(STATS_DTYPE))
    else:
        per_row, correct = be.row_stats(q_local, p_all, labels_local, col_mask,
                                        temperature=temperature)
        loss_sum = per_row.sum()
        correct_sum = correct.sum()
        if have_extra_rows:
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
        q_global=ctx.gather(q_local.detach()),
        p_global=p_pos.detach(),
    )
    return loss_dev, aux


def _ring_row_stats(q_rows, labels, p_inbatch, extra_cols: ExtraColumns, ctx: DistCtx,
                    be: LossBackend, *, temperature: float):
    """Ring-streamed (per_row_loss, correct) over the global columns
    [in-batch block] ++ [bank shard 0] ++ ... ++ [shard D-1], holding at
    most one bank shard at a time. ``labels`` are global column indices.

    Each of the 1 + D chunk evaluations gives the backend's online-softmax
    state ``(lse, pos, amax)``, and ``merge_row_stats`` composes them into
    the statistics over every column. The merge's chain rule scales each
    chunk's lse cotangent by ``exp(lse_k - lse)``, so each chunk's backward
    sees global softmax coefficients. Accuracy takes the fused kernel's tie
    rule (``pos >= amax``) on both backends."""
    from repro_torch.kernels.fused_infonce.ops import merge_row_stats

    n_a = p_inbatch.shape[0]
    lse_a, pos_a, amax_a = be.chunk_stats(
        q_rows, p_inbatch, labels, torch.ones((n_a,), dtype=torch.bool, device=q_rows.device),
        temperature=temperature,
    )
    owns_a = (labels >= 0) & (labels < n_a)
    lse_s, pos_s, owns_s, amax_s = _StreamBankChunks.apply(
        q_rows, labels, extra_cols.reps, extra_cols.valid, ctx, be, n_a, temperature,
    )
    lse, pos, amax = merge_row_stats(
        torch.cat([lse_a[None], lse_s]), torch.cat([pos_a[None], pos_s]),
        torch.cat([owns_a[None], owns_s]), torch.cat([amax_a[None], amax_s]),
    )
    correct = (pos >= amax).to(STATS_DTYPE).detach()
    return lse - pos, correct


def _chunk_eval(be, q_rows, labels, reps, valid, offset, temperature):
    """One bank chunk's (lse, pos, owns, amax), its columns starting at
    global column ``offset``."""
    local_labels = labels - offset
    lse, pos, amax = be.chunk_stats(q_rows, reps.to(q_rows.dtype), local_labels, valid,
                                    temperature=temperature)
    owns = (local_labels >= 0) & (local_labels < reps.shape[0])
    return lse, pos, owns, amax


class _StreamBankChunks(torch.autograd.Function):
    """Per-chunk stats ``(lse, pos, owns, amax)``, each stacked (D, M), of
    the D bank shards streamed around the ring, with a backward that
    streams the ring again.

    After k hops of the (i -> i+1) rotation rank i holds the shard of rank
    (i - k) mod D, global columns ``[n_a + owner*C_local, ...)``. Autograd
    through the hops would keep every visiting shard for the backward (all
    D at once, the whole bank again); the forward keeps only this rank's
    own shard instead, and the backward rotates the shards once more,
    recomputing each chunk's ``chunk_stats`` under ``enable_grad`` and
    taking its dq (and dp, where the shard needs a gradient) with
    ``torch.autograd.grad``. dq sums over the hops on this rank. Each
    shard's dP buffer travels with the shard: every rank adds its part as
    the pair passes, and the last hop delivers the sum to the owner (what
    ``ppermute``'s transpose does in JAX). Bank buffers are detached at
    push, so on the train path no dP is computed or carried."""

    @staticmethod
    def forward(fctx, q_rows, labels, reps, valid, ctx, be, n_a, temperature):
        d_ring, cap_local, sidx = ctx.device_count(), reps.shape[0], ctx.shard_index()
        shard = (reps, valid)
        out: List[Tuple[torch.Tensor, ...]] = []
        for k in range(d_ring):
            owner = (sidx - k) % d_ring
            out.append(_chunk_eval(be, q_rows, labels, *shard, n_a + owner * cap_local,
                                   temperature))
            if k < d_ring - 1:      # the saved own shard needs no trip home
                shard = ctx.ring_rotate(shard)
        fctx.save_for_backward(q_rows, labels, reps, valid)
        fctx.ring = (ctx, be, n_a, temperature)
        lse, pos, owns, amax = (torch.stack(t) for t in zip(*out))
        fctx.mark_non_differentiable(owns, amax)
        return lse, pos, owns, amax

    @staticmethod
    def backward(fctx, g_lse, g_pos, _g_owns, _g_amax):
        q_rows, labels, reps, valid = fctx.saved_tensors
        ctx, be, n_a, temperature = fctx.ring
        need_q, need_p = fctx.needs_input_grad[0], fctx.needs_input_grad[2]
        d_ring, cap_local, sidx = ctx.device_count(), reps.shape[0], ctx.shard_index()
        dq = torch.zeros(q_rows.shape, dtype=STATS_DTYPE, device=q_rows.device)
        shard, d_shard = (reps, valid), torch.zeros_like(reps) if need_p else None
        for k in range(d_ring):
            owner = (sidx - k) % d_ring
            with torch.enable_grad():
                qr = q_rows.detach().requires_grad_(need_q)
                pc = shard[0].detach().requires_grad_(need_p)
                lse, pos, _, _ = _chunk_eval(be, qr, labels, pc, shard[1],
                                             n_a + owner * cap_local, temperature)
                wrt = [t for t, need in ((qr, need_q), (pc, need_p)) if need]
                grads = iter(torch.autograd.grad((lse, pos), wrt, (g_lse[k], g_pos[k])))
            if need_q:
                dq += next(grads).to(STATS_DTYPE)
            if need_p:
                d_shard = d_shard + next(grads).to(d_shard.dtype)
                # the shard and its dP ride on together; the last hop
                # delivers the dP home
                shard, d_shard = ctx.ring_rotate((shard, d_shard))
            elif k < d_ring - 1:
                shard = ctx.ring_rotate(shard)
        return (dq.to(q_rows.dtype) if need_q else None, None, d_shard, None, None, None,
                None, None)


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


def sharded_bank_extra_columns(
    bank_p: Optional[BankState], ctx: DistCtx, comm: str = "all_gather"
) -> Optional[ExtraColumns]:
    """This rank's passage-bank shard -> extra columns, under
    ``ContrastiveConfig.loss_comm``: ``"all_gather"`` gathers the rows and
    validity into the global block (shard-major, the bank's global ring
    layout; O(N_mem*d) transient memory whatever D); ``"ring"`` keeps the
    shard local (``sharded=True``) and the loss streams the D shards
    around the ring (O(N_mem*d/D)). Without an axis the shard is the whole
    bank and the gather the identity."""
    if bank_p is None or bank_p.buf.shape[0] == 0:
        return None
    if comm == "ring" and ctx.is_distributed:
        return ExtraColumns(reps=bank_p.buf, valid=bank_p.valid, sharded=True)
    return ExtraColumns(reps=ctx.gather(bank_p.buf), valid=ctx.gather(bank_p.valid))


def sharded_bank_extra_rows(
    bank_q: Optional[BankState], bank_p: Optional[BankState], ctx: DistCtx
) -> Optional[ExtraRows]:
    """This rank's dual-bank shards -> its partition of the extra query
    rows. Nothing is gathered: each rank evaluates its own bank rows,
    labeled with their global slots, and the sum over the ranks counts
    every global row once."""
    if bank_q is None or bank_q.buf.shape[0] == 0:
        return None
    if bank_p is None or bank_p.buf.shape[0] == 0:
        return None
    cap_local = bank_q.buf.shape[0]
    return ExtraRows(
        reps=bank_q.buf,
        labels=ctx.shard_index() * cap_local
        + torch.arange(cap_local, dtype=torch.int32, device=bank_q.buf.device),
        weight=aligned_valid(bank_q, bank_p).to(STATS_DTYPE),
        sharded=True,
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
