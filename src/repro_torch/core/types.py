"""Shared types of the contrastive update builders (``repro.core.types``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.memory_bank import BankState
from repro_torch.core.precision import STATS_DTYPE


class DualEncoder(NamedTuple):
    """Abstract dual encoder. ``params`` is a dict with keys 'query' and
    'passage' (which may alias for shared towers); the encode functions take
    the full params dict. ``compute_copy`` (optional, not in the JAX type)
    copies params into the fewest bytes on which the encodes give the same
    reps: each leaf in the dtype the towers compute with it. The miner
    snapshots into it; None means a plain copy."""

    init: Callable[..., Any]                               # (generator, device) -> params
    encode_query: Callable[[Any, Any], torch.Tensor]       # (params, queries) -> (B, d)
    encode_passage: Callable[[Any, Any], torch.Tensor]     # (params, passages) -> (B, d)
    rep_dim: int
    compute_copy: Optional[Callable[[Any], Any]] = None    # params -> a copy


class RetrievalBatch(NamedTuple):
    """One global batch of training examples.

    query:        tensor or dict of tensors, leaves (B, ...)
    passage_pos:  the positive passage per query, leaves (B, ...)
    passage_hard: leaves (B, H, ...) or None: H hard negatives per query
    """

    query: Any
    passage_pos: Any
    passage_hard: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class ContrastiveConfig:
    """Configuration of the contrastive update (paper Secs. 3.1-3.2), with
    the fields and resolution of ``repro.core.types.ContrastiveConfig`` so
    one config value drives both packages.

    The update is a composition *negative source x backprop strategy*
    (core/step_program.py): name a registered composition with ``method=``
    or set ``negatives=`` / ``backprop=`` explicitly (an explicit axis wins
    over that half of ``method``). ``accumulation_steps`` is K (the global
    batch must divide by it). ``bank_size`` is N_memory for both banks;
    ``bank_size_q``/``bank_size_p`` override it (unequal non-zero sizes are
    rejected by the dual-bank source). ``use_query_bank=False`` is the
    pre-batch ablation (w/o M_q). ``loss_impl``: 'dense' (the (M, N) logits
    block) or 'fused' (the CUDA kernels of kernels/fused_infonce).
    ``precision``: a PrecisionPolicy or preset name. ``bank_dtype``
    overrides the policy's bank dtype. ``dp_axis``: None for one device,
    else the name(s) of the data-parallel axes, which in the port means the
    initialized default ``torch.distributed`` process group (core/dist.py).
    ``shard_banks``: each rank owns a ``bank_size / D`` block of ring slots
    instead of the whole ring (needs ``dp_axis``); the loss gathers the
    passage-bank columns and evaluates only the rank's query-bank rows.
    ``loss_comm``: how sharded bank columns reach the loss, ``'all_gather'``
    (the whole (N_mem, d) block on every rank) or ``'ring'`` (the D shards
    streamed around the ring, merging online-softmax statistics: the same
    loss at O(N_mem*d/D) transient memory; needs ``shard_banks`` and a
    bank-consuming source).
    """

    method: str = "contaccum"
    negatives: Optional[str] = None
    backprop: Optional[str] = None
    temperature: float = 1.0
    accumulation_steps: int = 1
    bank_size: int = 0
    bank_size_q: Optional[int] = None
    bank_size_p: Optional[int] = None
    use_query_bank: bool = True
    reset_banks_each_update: bool = False
    grad_clip_norm: float = 2.0
    bank_dtype: Any = None
    loss_impl: str = "dense"
    precision: Any = "fp32"
    dp_axis: Optional[Any] = None
    shard_banks: bool = False
    loss_comm: str = "all_gather"

    def resolved_precision(self):
        """The PrecisionPolicy this config runs under (presets resolved)."""
        from repro_torch.core.precision import resolve_precision

        return resolve_precision(self.precision)

    def resolved_bank_dtype(self):
        """Bank buffer dtype: explicit ``bank_dtype``, else the policy's."""
        if self.bank_dtype is not None:
            return self.bank_dtype
        return self.resolved_precision().bank_dtype

    def resolved_bank_sizes(self):
        nq = self.bank_size if self.bank_size_q is None else self.bank_size_q
        np_ = self.bank_size if self.bank_size_p is None else self.bank_size_p
        if not self.use_query_bank:
            nq = 0
        return nq, np_

    def resolved_composition_names(self):
        """(negatives, backprop) names after legacy-``method`` resolution."""
        from repro_torch.core.step_program import method_composition

        neg, bp = self.negatives, self.backprop
        if neg is None or bp is None:
            legacy = method_composition(self.method)
            neg = neg or legacy[0]
            bp = bp or legacy[1]
        return neg, bp


class ContrastiveState(NamedTuple):
    step: torch.Tensor     # () int32
    params: Any
    opt_state: Any
    bank_q: BankState
    bank_p: BankState


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    accuracy: torch.Tensor
    grad_norm: torch.Tensor
    grad_norm_query: torch.Tensor
    grad_norm_passage: torch.Tensor
    grad_norm_ratio: torch.Tensor  # ||grad_passage|| / ||grad_query|| (paper Fig. 5)
    n_negatives: torch.Tensor      # negatives per query row actually used
    bank_fill_q: torch.Tensor
    bank_fill_p: torch.Tensor


def subtree_norm(grads: Any, key: str) -> torch.Tensor:
    from repro_torch.common.treemath import tree_global_norm

    if isinstance(grads, dict) and key in grads:
        return tree_global_norm(grads[key])
    return torch.zeros((), dtype=STATS_DTYPE)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def chunk_tree(tree: Any, k: int) -> Any:
    """Reshape every leaf (B, ...) -> (K, B//K, ...)."""

    def _r(x):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"global batch {b} not divisible by K={k}")
        return x.reshape((k, b // k) + tuple(x.shape[1:]))

    return _map_leaves(_r, tree)


def flatten_hard(hard: Any) -> Any:
    """(B, H, ...) -> (B*H, ...) for encoding."""
    return _map_leaves(
        lambda x: x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:])), hard
    )
