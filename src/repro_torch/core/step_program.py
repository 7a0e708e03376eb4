"""Composable contrastive updates: the StepProgram API of
``repro.core.step_program``, on PyTorch.

An update is a *negative source* x a *backprop strategy*:

  * sources: ``in_batch`` (no extras), ``mined`` (in-batch math; mined
    negatives arrive as extra ``passage_hard`` columns), ``gathered``
    (cross-device in-batch negatives; needs ``dp_axis``), ``dual_bank``
    (the paper's dual FIFO banks) and ``passage_bank`` (pre-batch ablation);
  * strategies: ``direct`` (one forward/backward over the batch), ``scan``
    (a Python loop over K chunks, loss restricted to each chunk, paper Eq. 4;
    grads accumulate in fp32 and are scaled by 1/K; the bank carry threads
    through the chunks, so chunk k sees every earlier push) and
    ``rep_cache`` (GradCache: a ``no_grad`` forward of the representations,
    the loss differentiated w.r.t. them, then one chunk at a time
    ``torch.autograd.backward(reps, grad_tensors)`` through the encoders).

``build_step_program(encoder, tx, cfg)`` returns the update
``(state, batch) -> (state, StepMetrics)``. It differentiates detached
copies of the params (leaves whose ``.grad`` accumulates in the param type,
fp32), so the state it is given is left as it was. ``cfg.loss_impl`` picks
the loss backend, ``cfg.precision`` the PrecisionPolicy, orthogonally.

Across a data-parallel group (``cfg.dp_axis``: the initialized default
process group, core/dist.py) each rank runs the update on its own rows of
the global batch; the loss gathers the columns over the ranks, and the
update sums the gradients over the ranks (one ``psum_tree`` after the
strategy, where each of JAX's strategies ends with one) before the
optimizer. ``cfg.shard_banks`` gives each rank a ``bank_size / D`` block of
ring slots (``init_state`` allocates only that): pushes write only the
rank's own slots of the gathered rows, the loss evaluates only the rank's
query-bank rows, and ``cfg.loss_comm`` picks how the passage-bank columns
reach it: ``'all_gather'`` (the global block on every rank) or ``'ring'``
(the shards streamed around the ring, core/loss.py ``_ring_row_stats``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Protocol, Tuple, Union

import torch

from repro_torch.common.treemath import tree_global_norm, tree_leaves, tree_map
from repro_torch.core.dist import DistCtx
from repro_torch.core.loss import (
    LossAux,
    LossBackend,
    bank_extra_columns,
    bank_extra_rows,
    contrastive_loss,
    resolve_loss_backend,
    sharded_bank_extra_columns,
    sharded_bank_extra_rows,
)
from repro_torch.core.memory_bank import (
    BankState,
    clear,
    init_bank,
    push,
    push_pair,
    shard_push,
    shard_push_pair,
)
from repro_torch.core.precision import STATS_DTYPE, resolve_precision
from repro_torch.core.types import (
    ContrastiveConfig,
    ContrastiveState,
    DualEncoder,
    RetrievalBatch,
    StepMetrics,
    chunk_tree,
    flatten_hard,
    subtree_norm,
)
from repro_torch.optim.adamw import GradientTransformation, apply_updates

# Bank state threaded across chunks by every program: (bank_q, bank_p).
Carry = Tuple[BankState, BankState]

LOSS_COMMS = ("all_gather", "ring")


def _validate_loss_comm(cfg: ContrastiveConfig, *, uses_banks: bool) -> None:
    """The loss_comm checks, at program build."""
    if cfg.loss_comm not in LOSS_COMMS:
        raise ValueError(f"unknown loss_comm {cfg.loss_comm!r}; one of {sorted(LOSS_COMMS)}")
    if cfg.loss_comm == "ring":
        if not uses_banks:
            raise ValueError(
                "loss_comm='ring' streams sharded bank columns around the DP "
                "ring, but this negatives source has no bank columns — use a "
                "bank-consuming source (dual_bank / passage_bank) or leave "
                "loss_comm='all_gather'"
            )
        if not cfg.shard_banks:
            raise ValueError(
                "loss_comm='ring' needs shard_banks=True (each device must "
                "own one N_mem/D shard to stream); replicated banks already "
                "hold the full column block locally"
            )


# --------------------------------------------------------------------------
# NegativeSource protocol + implementations
# --------------------------------------------------------------------------
class NegativeSource(Protocol):
    """Where the negatives of one loss evaluation come from."""

    name: str
    uses_banks: bool
    needs_mesh: bool

    def bank_sizes(self, cfg: ContrastiveConfig) -> Tuple[int, int]: ...
    def validate(self, cfg: ContrastiveConfig) -> None: ...
    def begin(self, state: ContrastiveState, cfg: ContrastiveConfig) -> Carry: ...
    def loss(self, q, pp, ph, carry: Carry, *, cfg, ctx,
             backend: Optional[LossBackend] = None) -> Tuple[torch.Tensor, LossAux]: ...
    def push(self, carry: Carry, aux: LossAux, step, *, cfg, ctx) -> Carry: ...


class InBatchNegatives:
    """Plain in-batch negatives (DPR / GradAccum / GradCache). Banks in state
    are allocated per cfg for layout compatibility but never read or written."""

    name = "in_batch"
    uses_banks = False
    needs_mesh = False

    def bank_sizes(self, cfg):
        return cfg.resolved_bank_sizes()

    def validate(self, cfg):
        _validate_loss_comm(cfg, uses_banks=False)

    def begin(self, state, cfg):
        return (state.bank_q, state.bank_p)

    def loss(self, q, pp, ph, carry, *, cfg, ctx, backend=None):
        return contrastive_loss(
            q, pp, ph, temperature=cfg.temperature, ctx=ctx, backend=backend,
            precision=cfg.resolved_precision(),
        )

    def push(self, carry, aux, step, *, cfg, ctx):
        return carry


class MinedNegatives(InBatchNegatives):
    """ANCE-style mined hard negatives: batch assembly joins them in as extra
    ``passage_hard`` columns, so inside the update the math is in-batch."""

    name = "mined"


class GatheredInBatch(InBatchNegatives):
    """Cross-device in-batch negatives (``dpr_xdev``): the in-batch math
    (the loss gathers the columns whenever ``cfg.dp_axis`` is set), but it
    states the intent and refuses to build without a DP axis."""

    name = "gathered"
    needs_mesh = True

    def validate(self, cfg):
        super().validate(cfg)
        if cfg.dp_axis is None:
            raise ValueError(
                "negatives='gathered' needs cfg.dp_axis naming the mesh axes "
                "to all-gather representations over"
            )


class DualBankNegatives:
    """The paper's dual FIFO memory banks (Sec. 3.2): the passage bank
    extends the columns, the query bank adds extra rows labeled with their
    lockstep-aligned positives; both are pushed after every loss evaluation."""

    name = "dual_bank"
    uses_banks = True
    needs_mesh = False

    def bank_sizes(self, cfg):
        return cfg.resolved_bank_sizes()

    def validate(self, cfg):
        nq, np_ = self.bank_sizes(cfg)
        if nq and np_ and nq != np_:
            raise ValueError(
                f"dual banks need equal non-zero capacities to stay "
                f"ring-aligned (got bank_size_q={nq}, bank_size_p={np_}). Use "
                f"bank_size=, or disable one bank (capacity 0) for the "
                f"pre-batch ablation."
            )
        if cfg.shard_banks and cfg.dp_axis is None:
            raise ValueError(
                "shard_banks=True needs cfg.dp_axis naming the mesh axes the "
                "bank rows are sharded over (single-device banks are already "
                "'sharded' into one shard — just leave shard_banks off)"
            )
        _validate_loss_comm(cfg, uses_banks=True)

    def begin(self, state, cfg):
        if cfg.reset_banks_each_update:
            return (clear(state.bank_q), clear(state.bank_p))
        return (state.bank_q, state.bank_p)

    def _sharded(self, cfg, ctx) -> bool:
        return cfg.shard_banks and ctx.is_distributed

    def loss(self, q, pp, ph, carry, *, cfg, ctx, backend=None):
        bank_q, bank_p = carry
        if self._sharded(cfg, ctx):
            # this rank's bank shards: the columns reach the loss gathered
            # or streamed around the ring (loss_comm); the rows are this
            # rank's own partition either way
            extra_cols = sharded_bank_extra_columns(bank_p, ctx, cfg.loss_comm)
            extra_rows = sharded_bank_extra_rows(bank_q, bank_p, ctx)
        else:
            extra_cols = bank_extra_columns(bank_p)
            extra_rows = bank_extra_rows(bank_q, bank_p)
        return contrastive_loss(
            q, pp, ph, extra_cols=extra_cols, extra_rows=extra_rows,
            temperature=cfg.temperature, ctx=ctx, backend=backend,
            precision=cfg.resolved_precision(),
        )

    def push(self, carry, aux, step, *, cfg, ctx):
        bank_q, bank_p = carry
        if self._sharded(cfg, ctx):
            # each rank writes only its own slots of the gathered rows; the
            # global head advances alike on every rank
            return shard_push_pair(
                bank_q, bank_p, aux.q_global, aux.p_global, step,
                shard_index=ctx.shard_index(), num_shards=ctx.device_count(),
            )
        # the gathered rows, the same on every rank: replicated banks
        return push_pair(bank_q, bank_p, aux.q_global, aux.p_global, step)


class PassageBankNegatives(DualBankNegatives):
    """Passage-only bank, the 'pre-batch negatives' ablation (w/o M_q):
    columns are extended, no extra rows, only passages pushed."""

    name = "passage_bank"

    def bank_sizes(self, cfg):
        _, np_ = cfg.resolved_bank_sizes()
        return 0, np_

    def loss(self, q, pp, ph, carry, *, cfg, ctx, backend=None):
        _, bank_p = carry
        extra_cols = (
            sharded_bank_extra_columns(bank_p, ctx, cfg.loss_comm)
            if self._sharded(cfg, ctx)
            else bank_extra_columns(bank_p)
        )
        return contrastive_loss(
            q, pp, ph, extra_cols=extra_cols,
            temperature=cfg.temperature, ctx=ctx, backend=backend,
            precision=cfg.resolved_precision(),
        )

    def push(self, carry, aux, step, *, cfg, ctx):
        bank_q, bank_p = carry
        if self._sharded(cfg, ctx):
            return bank_q, shard_push(
                bank_p, aux.p_global, step,
                shard_index=ctx.shard_index(), num_shards=ctx.device_count(),
            )
        return bank_q, push(bank_p, aux.p_global, step)


# --------------------------------------------------------------------------
# BackpropStrategy protocol + implementations
# --------------------------------------------------------------------------
class BackpropStrategy(Protocol):
    """How encoder gradients are obtained from the source's loss."""

    name: str

    def validate(self, cfg: ContrastiveConfig) -> None: ...

    def compute(self, encoder, leaves, batch, source, carry, step, cfg, ctx
                ) -> Tuple[LossAux, Carry]:
        """Accumulates the update's gradient into the ``.grad`` of the param
        copies ``leaves``; returns (reduced aux, final carry)."""
        ...


def _encode_chunk(encoder: DualEncoder, params, chunk: RetrievalBatch):
    q = encoder.encode_query(params, chunk.query)
    pp = encoder.encode_passage(params, chunk.passage_pos)
    ph = None
    if chunk.passage_hard is not None:
        ph = encoder.encode_passage(params, flatten_hard(chunk.passage_hard))
    return q, pp, ph


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def _chunks(batch: RetrievalBatch, k: int):
    """The K chunks of a batch, each a RetrievalBatch of B/K rows."""
    q = chunk_tree(batch.query, k)
    pp = chunk_tree(batch.passage_pos, k)
    ph = None if batch.passage_hard is None else chunk_tree(batch.passage_hard, k)
    return [
        RetrievalBatch(
            query=_index_tree(q, i),
            passage_pos=_index_tree(pp, i),
            passage_hard=None if ph is None else _index_tree(ph, i),
        )
        for i in range(k)
    ]


def _reduce_scanned_aux(auxs) -> LossAux:
    """Per-chunk aux -> update-level metrics. Each chunk's loss/accuracy is
    a mean over that chunk's rows, and the row counts differ while the banks
    warm up, so chunks are recombined weighted by ``n_rows``: the exact mean
    over every row of the update, not a mean of chunk means."""
    n = torch.stack([a.n_rows for a in auxs])
    n_total = torch.clamp(n.sum(), min=1.0)
    return LossAux(
        loss=(torch.stack([a.loss for a in auxs]) * n).sum() / n_total,
        accuracy=(torch.stack([a.accuracy for a in auxs]) * n).sum() / n_total,
        n_rows=n.sum(),
        n_negatives=torch.stack([a.n_negatives for a in auxs]).mean(),
        q_global=torch.stack([a.q_global for a in auxs]),
        p_global=torch.stack([a.p_global for a in auxs]),
    )


class DirectBackprop:
    """One forward/backward over the whole batch (full activation memory)."""

    name = "direct"

    def validate(self, cfg):
        pass

    def compute(self, encoder, leaves, batch, source, carry, step, cfg, ctx):
        backend = resolve_loss_backend(cfg.loss_impl)
        q, pp, ph = _encode_chunk(encoder, leaves, batch)
        loss, aux = source.loss(q, pp, ph, carry, cfg=cfg, ctx=ctx, backend=backend)
        loss.backward()
        return aux, source.push(carry, aux, step, cfg=cfg, ctx=ctx)


class ScanAccumulate:
    """K chunks in a Python loop, the loss restricted to each chunk (paper
    Eq. 4). Chunk k's backward runs before its bank push, and each chunk's
    loss sees every earlier push."""

    name = "scan"

    def validate(self, cfg):
        if cfg.accumulation_steps < 1:
            raise ValueError("accumulation_steps must be >= 1")

    def compute(self, encoder, leaves, batch, source, carry, step, cfg, ctx):
        k = cfg.accumulation_steps
        backend = resolve_loss_backend(cfg.loss_impl)
        auxs = []
        for chunk in _chunks(batch, k):
            q, pp, ph = _encode_chunk(encoder, leaves, chunk)
            loss, aux = source.loss(q, pp, ph, carry, cfg=cfg, ctx=ctx, backend=backend)
            loss.backward()
            carry = source.push(carry, aux, step, cfg=cfg, ctx=ctx)
            auxs.append(aux)
        for leaf in tree_leaves(leaves):
            if leaf.grad is not None:
                leaf.grad.mul_(1.0 / k)
        return _reduce_scanned_aux(auxs), carry


class RepCacheVJP:
    """GradCache's decomposed backprop (Gao et al. 2021): representations
    are computed chunk by chunk under ``no_grad``, the source's loss is
    differentiated w.r.t. them only (the "gradient cache"), then each chunk
    is encoded again with grad and its cached cotangents are fed back. The
    gradients are the direct full-batch ones, at chunked activation memory."""

    name = "rep_cache"

    def validate(self, cfg):
        if cfg.accumulation_steps < 1:
            raise ValueError("accumulation_steps must be >= 1")

    def compute(self, encoder, leaves, batch, source, carry, step, cfg, ctx):
        k = cfg.accumulation_steps
        chunks = _chunks(batch, k)
        has_hard = batch.passage_hard is not None
        backend = resolve_loss_backend(cfg.loss_impl)
        pol = cfg.resolved_precision()

        # stage 1: representations only; the cache lives in the compute dtype
        with torch.no_grad():
            reps = [_encode_chunk(encoder, leaves, c) for c in chunks]
        qs = [pol.cast_compute(r[0]) for r in reps]
        pps = [pol.cast_compute(r[1]) for r in reps]
        phs = [pol.cast_compute(r[2]) for r in reps] if has_hard else None

        # stage 2: d loss / d representations, with the source's extras
        q_all = torch.cat(qs).requires_grad_(True)
        pp_all = torch.cat(pps).requires_grad_(True)
        ph_all = torch.cat(phs).requires_grad_(True) if has_hard else None
        loss, aux = source.loss(q_all, pp_all, ph_all, carry, cfg=cfg, ctx=ctx,
                                backend=backend)
        wrt = [q_all, pp_all] + ([ph_all] if has_hard else [])
        rep_grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        rep_grads = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, rep_grads)]
        gq = rep_grads[0].split([x.shape[0] for x in qs])
        gpp = rep_grads[1].split([x.shape[0] for x in pps])
        gph = rep_grads[2].split([x.shape[0] for x in phs]) if has_hard else None

        # stage 3: per-chunk backward through the encoders, seeded with the
        # cached cotangents (in the dtype the encoder emits)
        for i, c in enumerate(chunks):
            q, pp, ph = _encode_chunk(encoder, leaves, c)
            outs, seeds = [q, pp], [gq[i], gpp[i]]
            if has_hard:
                outs.append(ph)
                seeds.append(gph[i])
            torch.autograd.backward(outs, [g.to(o.dtype) for g, o in zip(seeds, outs)])
        return aux, source.push(carry, aux, step, cfg=cfg, ctx=ctx)


# --------------------------------------------------------------------------
# Registries + resolution
# --------------------------------------------------------------------------
SOURCES = {
    s.name: s
    for s in (
        InBatchNegatives(),
        MinedNegatives(),
        GatheredInBatch(),
        DualBankNegatives(),
        PassageBankNegatives(),
    )
}

STRATEGIES = {s.name: s for s in (DirectBackprop(), ScanAccumulate(), RepCacheVJP())}

# method name -> (negatives, backprop), the JAX package's registry
COMPOSITIONS = {
    "dpr": ("in_batch", "direct"),
    "grad_accum": ("in_batch", "scan"),
    "grad_cache": ("in_batch", "rep_cache"),
    "contaccum": ("dual_bank", "scan"),
    "contcache": ("dual_bank", "rep_cache"),
    "prebatch": ("passage_bank", "scan"),
    "prebatch_cache": ("passage_bank", "rep_cache"),
    "dpr_xdev": ("gathered", "direct"),
    "mined": ("mined", "direct"),
    "mined_accum": ("mined", "scan"),
    "mined_cache": ("mined", "rep_cache"),
}


def available_methods() -> list:
    """Registered method names."""
    return sorted(COMPOSITIONS)


def method_composition(method: str) -> Tuple[str, str]:
    """Method name -> (negatives, backprop)."""
    if method not in COMPOSITIONS:
        raise ValueError(f"unknown method {method!r}; one of {available_methods()}")
    return COMPOSITIONS[method]


def method_uses_banks(method: str) -> bool:
    return SOURCES[method_composition(method)[0]].uses_banks


def method_needs_mesh(method: str) -> bool:
    return SOURCES[method_composition(method)[0]].needs_mesh


def resolve_composition(cfg: ContrastiveConfig):
    """cfg -> (source, strategy); explicit axes win over ``method``."""
    neg, bp = cfg.resolved_composition_names()
    if neg not in SOURCES:
        raise ValueError(f"unknown negatives {neg!r}; one of {sorted(SOURCES)}")
    if bp not in STRATEGIES:
        raise ValueError(f"unknown backprop {bp!r}; one of {sorted(STRATEGIES)}")
    return SOURCES[neg], STRATEGIES[bp]


@dataclasses.dataclass(frozen=True)
class StepProgram:
    """A built contrastive update plus the composition it was built from."""

    update: Callable[[ContrastiveState, RetrievalBatch], Tuple[ContrastiveState, StepMetrics]]
    source: Any
    strategy: Any
    cfg: ContrastiveConfig


def _metrics(grads, aux: LossAux, bank_q: BankState, bank_p: BankState, *,
             ctx: Optional[DistCtx] = None, sharded_banks: bool = False) -> StepMetrics:
    gq = subtree_norm(grads, "query")
    gp = subtree_norm(grads, "passage")

    def fill(bank: BankState) -> torch.Tensor:
        f = bank.valid.sum().to(STATS_DTYPE)
        # a shard's fill differs from another's mid-warm-up (low ring slots
        # fill first): the sum over the ranks is the global fill
        return ctx.psum(f) if sharded_banks and ctx is not None else f

    return StepMetrics(
        loss=aux.loss,
        accuracy=aux.accuracy,
        grad_norm=tree_global_norm(grads),
        grad_norm_query=gq,
        grad_norm_passage=gp,
        grad_norm_ratio=gp / torch.clamp(gq, min=1e-12),
        n_negatives=aux.n_negatives,
        bank_fill_q=fill(bank_q),
        bank_fill_p=fill(bank_p),
    )


def build_step_program(
    encoder: DualEncoder, tx: GradientTransformation, cfg: ContrastiveConfig
) -> StepProgram:
    """Compose cfg's negative source and backprop strategy into one update.
    The program owns chunking, loss assembly, bank pushes, the optimizer
    step and the metrics."""
    source, strategy = resolve_composition(cfg)
    source.validate(cfg)
    strategy.validate(cfg)
    resolve_loss_backend(cfg.loss_impl)  # fail fast on unknown loss_impl
    resolve_precision(cfg.precision)     # fail fast on unknown precision
    ctx = DistCtx(cfg.dp_axis)

    def update(state: ContrastiveState, batch: RetrievalBatch):
        carry = source.begin(state, cfg)
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), state.params)
        with torch.enable_grad():
            aux, (bank_q, bank_p) = strategy.compute(
                encoder, leaves, batch, source, carry, state.step, cfg, ctx
            )
        grads = ctx.psum_tree(tree_map(
            lambda leaf: torch.zeros_like(leaf) if leaf.grad is None else leaf.grad, leaves
        ))
        with torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state, state.params)
            new_state = ContrastiveState(
                step=state.step + 1,
                params=apply_updates(state.params, updates),
                opt_state=opt_state,
                bank_q=bank_q,
                bank_p=bank_p,
            )
            metrics = _metrics(grads, aux, bank_q, bank_p, ctx=ctx,
                               sharded_banks=cfg.shard_banks and ctx.is_distributed)
        return new_state, metrics

    return StepProgram(update=update, source=source, strategy=strategy, cfg=cfg)


def init_state(
    generator: torch.Generator,
    encoder: DualEncoder,
    tx: GradientTransformation,
    cfg: ContrastiveConfig,
    params: Optional[Any] = None,
    bank_dim: Optional[int] = None,
    *,
    device: Union[str, torch.device],
) -> ContrastiveState:
    """Initial train state on ``device``, with the bank capacities the cfg's
    negative source asks for, in the policy's ``bank_dtype``. ``params``
    (nested dicts of tensors) are used as given (moved to ``device``), else
    drawn from ``generator``. With ``cfg.shard_banks`` and a ``dp_axis`` the
    state is this rank's: each bank holds its ``capacity / D`` slots (JAX
    keeps one global array and shards it with a spec)."""
    device = torch.device(device)
    if params is None:
        params = encoder.init(generator, device)
    else:
        params = tree_map(lambda t: t.to(device), params)
    source, _ = resolve_composition(cfg)
    nq, np_ = source.bank_sizes(cfg)
    if cfg.shard_banks and cfg.dp_axis is not None:
        n_shards = DistCtx(cfg.dp_axis).device_count()
        if nq % n_shards or np_ % n_shards:
            raise ValueError(f"bank sizes ({nq}, {np_}) are not divisible by the {n_shards} "
                             f"ranks they are sharded over")
        nq, np_ = nq // n_shards, np_ // n_shards
    d = bank_dim or encoder.rep_dim
    bank_dtype = cfg.resolved_bank_dtype()
    return ContrastiveState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        params=params,
        opt_state=tx.init(params),
        bank_q=init_bank(nq, d, bank_dtype, device=device),
        bank_p=init_bank(np_, d, bank_dtype, device=device),
    )
