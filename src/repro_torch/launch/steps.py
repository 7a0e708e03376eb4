"""Cell programs, the LM and recsys parts of ``repro.launch.steps`` on one
device: (architecture x shape cell x device) -> a step function plus
stand-ins of its inputs.

  train             LM causal-LM training step (microbatched gradient
                    accumulation, clip 1.0, then AdamW)
  prefill           LM prompt -> KV cache + last-position logits
  decode            LM one token against a seq_len-slot KV cache, which it
                    consumes (written in place: JAX donates it)
  recsys_train      DLRM/DCN/DeepFM BCE training step (clip 1.0, then AdamW)
  recsys_serve      forward scoring
  recsys_retrieval  1 query x 1M candidates, factorized scoring

``build_cell`` takes a device in place of the JAX package's mesh: it runs on
``cuda`` unless given ``device="cpu"``. ``CellProgram.fn`` is a plain
function on tensors; ``args`` are ``meta``-device tensors (and trees of them)
of the cell's input shapes, allocating nothing, for a later dry-run; and
``init(generator)`` draws the real first argument on the device (the
TrainState of a train cell, the params otherwise), which the JAX package
leaves to its callers. With one device there is no mesh, so the
psum-scatter lookup stays off (``lookup_fn`` None); on one device it gives
the values of the plain gather.

The LM train cell's microbatch count follows the JAX package's rule on one
device: the ArchSpec's ``micro_batches`` entry, capped at the batch and
lowered until it divides it; ``build_cell(..., micro_batches=)`` replaces
that entry (a smaller microbatch to fit one card), and
``build_cell(..., global_batch=)`` replaces the cell's global batch (a
smaller batch, or a smaller cache, to fit one card). JAX's sharding specs
have no meaning on one device and are left out.

The LM cells take the dense archs and the MoE ones (olmoe-1b-7b,
qwen3-moe-235b-a22b) alike; an MoE train step takes the gradient of
``lm_loss``'s token loss plus its ``moe_aux`` term, as JAX's does. Not yet
ported: the SchNet cells (ROADMAP A9e) and the contrastive and retrieval
cells of dpr-bert-base (A10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.common.treemath import tree_map
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.core.device import resolve_device
from repro_torch.models.lm import KVCache, LMConfig, decode_step, init_lm, lm_loss, prefill
from repro_torch.models.recsys import (
    RecsysConfig,
    bce_loss,
    forward as recsys_forward,
    init_recsys,
    score_candidates,
)
from repro_torch.optim.adamw import adamw, apply_updates, chain, clip_by_global_norm
from repro_torch.optim.schedules import linear_warmup_linear_decay

_META = torch.device("meta")


class TrainState(NamedTuple):
    step: torch.Tensor
    params: Any
    opt: Any


@dataclasses.dataclass
class CellProgram:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable
    args: Tuple[Any, ...]               # meta tensors of the input shapes
    static_info: dict
    init: Optional[Callable[[torch.Generator], Any]] = None   # the real args[0]


def _pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


#: bf16 AdamW moments for the >=100B configs (their HBM budget; the configs'
#: notes), fp32 for every other arch
MOMENT_DTYPE = {
    "qwen1.5-110b": torch.bfloat16,
    "qwen3-moe-235b-a22b": torch.bfloat16,
}


def _make_tx(arch_id: str, *, lr: float = 3e-4, clip: float = 1.0):
    """Clip, then AdamW on the JAX package's schedule, its moments stored in
    the arch's ``MOMENT_DTYPE`` (fp32 arithmetic, rounded on store)."""
    sched = linear_warmup_linear_decay(lr, 2000, 200_000)
    return chain(
        clip_by_global_norm(clip),
        adamw(sched, moment_dtype=MOMENT_DTYPE.get(arch_id, torch.float32)),
    )


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


# ---------------------------------------------------------------- LM: train
def _lm_flops(cfg: LMConfig, tokens: int, *, train: bool) -> float:
    """6ND (2ND without the backward) plus the attention term, as the JAX
    package counts it: its comment names 2 * 2 * S * tokens * H * dh, halved
    for the causal mask, but the term it computes has no factor S."""
    n = cfg.active_param_count()
    mult = 6.0 if train else 2.0
    attn = 2.0 * tokens * cfg.n_heads * cfg.dh * cfg.n_layers
    return mult * n * tokens + (3.0 if train else 1.0) * attn


def _lm_train_program(arch: ArchSpec, cell: ShapeCell, device: torch.device) -> CellProgram:
    cfg: LMConfig = arch.model_cfg
    B, S = cell.params["global_batch"], cell.params["seq_len"]
    # microbatch count: the config's, kept a divisor of the batch
    m = max(1, min(arch.micro_batch(cell.name), B))
    while B % m:
        m -= 1
    i32 = torch.int32
    tx = _make_tx(arch.arch_id)
    params_meta = init_lm(cfg, torch.Generator(), device=_META)
    state_meta = TrainState(step=_meta((), i32), params=params_meta, opt=tx.init(params_meta))

    def init_state(generator: torch.Generator) -> TrainState:
        params = init_lm(cfg, generator, device=device)
        return TrainState(torch.zeros((), dtype=i32, device=device), params, tx.init(params))

    def train_step(state_: TrainState, tokens, targets):
        # tokens, targets: (m, B // m, S), microbatch-major. Each backward
        # adds its gradients into the leaves' .grad (in the params' fp32),
        # and the sum is scaled once: JAX's tree_add, then tree_scale.
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), state_.params)
        losses = []
        for tk, tg in zip(tokens, targets):
            with torch.enable_grad():
                loss, _ = lm_loss(leaves, cfg, tk, tg)
                loss.backward()
            losses.append(loss.detach())
        grads = tree_map(
            lambda leaf: torch.zeros_like(leaf) if leaf.grad is None else leaf.grad.mul_(1.0 / m),
            leaves,
        )
        with torch.no_grad():
            updates, opt = tx.update(grads, state_.opt, state_.params)
            new_params = apply_updates(state_.params, updates)
        return TrainState(state_.step + 1, new_params, opt), {
            "loss": torch.stack(losses).mean(),
        }

    return CellProgram(
        arch_id=arch.arch_id, shape_name=cell.name, kind="train", fn=train_step,
        args=(state_meta, _meta((m, B // m, S), i32), _meta((m, B // m, S), i32)),
        static_info={
            "model_flops": _lm_flops(cfg, B * S, train=True),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "microbatches": m,
            "tokens_per_step": B * S,
        },
        init=init_state,
    )


# ------------------------------------------------------------ LM: serving
def _lm_prefill_program(arch: ArchSpec, cell: ShapeCell, device: torch.device) -> CellProgram:
    cfg: LMConfig = arch.model_cfg
    B, S = cell.params["global_batch"], cell.params["seq_len"]

    def init_params(generator: torch.Generator):
        return init_lm(cfg, generator, device=device)

    def prefill_step(params, tokens):
        return prefill(params, cfg, tokens)

    return CellProgram(
        arch_id=arch.arch_id, shape_name=cell.name, kind="prefill", fn=prefill_step,
        args=(init_lm(cfg, torch.Generator(), device=_META), _meta((B, S), torch.int32)),
        static_info={
            "model_flops": _lm_flops(cfg, B * S, train=False),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "tokens_per_step": B * S,
        },
        init=init_params,
    )


def _lm_decode_program(arch: ArchSpec, cell: ShapeCell, device: torch.device) -> CellProgram:
    cfg: LMConfig = arch.model_cfg
    B, S = cell.params["global_batch"], cell.params["seq_len"]
    i32 = torch.int32

    def init_params(generator: torch.Generator):
        return init_lm(cfg, generator, device=device)

    def serve_step(params, cache: KVCache, token):
        """One token a row; ``cache`` is consumed (written in place)."""
        return decode_step(params, cfg, cache, token)

    kv_shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.dh)
    cache = KVCache(_meta(kv_shape, cfg.dtype), _meta(kv_shape, cfg.dtype), _meta((B,), i32))
    kv_bytes = 2 * math.prod(kv_shape) * cache.k.element_size()
    return CellProgram(
        arch_id=arch.arch_id, shape_name=cell.name, kind="decode", fn=serve_step,
        args=(init_lm(cfg, torch.Generator(), device=_META), cache, _meta((B,), i32)),
        static_info={
            # JAX's count: one pass over the active params and the KV cache
            # a generated token
            "model_flops": 2.0 * cfg.active_param_count() * B
            + 4.0 * B * S * cfg.n_kv_heads * cfg.dh * cfg.n_layers,
            "params": cfg.param_count(),
            "kv_cache_bytes": float(kv_bytes),
            "tokens_per_step": B,
        },
        init=init_params,
    )


# ------------------------------------------------------------------- recsys
def _recsys_mlp_flops(cfg: RecsysConfig) -> float:
    total = 0.0
    prev = cfg.n_dense
    for d in cfg.bot_mlp:
        total += 2 * prev * d
        prev = d
    prev = cfg._concat_dim()
    for d in cfg.top_mlp:
        total += 2 * prev * d
        prev = d
    if cfg.interaction == "cross":
        x0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
        total += cfg.n_cross_layers * 2 * x0 * x0
    if cfg.interaction == "dot":
        f = cfg.n_sparse + 1
        total += 2 * f * f * cfg.embed_dim
    return total


def _recsys_program(arch: ArchSpec, cell: ShapeCell, device: torch.device) -> CellProgram:
    cfg: RecsysConfig = arch.model_cfg
    p = cell.params
    kind = cell.kind
    f32, i32 = torch.float32, torch.int32
    params_meta = init_recsys(torch.Generator(), cfg, device=_META)

    def init_params(generator: torch.Generator):
        return init_recsys(generator, cfg, device=device)

    if kind == "recsys_retrieval":
        c = _pad_to(p["n_candidates"], 1)

        def retrieval_step(params_, dense, sparse, cand_ids):
            return score_candidates(params_, cfg, dense, sparse, cand_ids)

        args = (params_meta, _meta((1, cfg.n_dense), f32), _meta((1, cfg.n_sparse), i32),
                _meta((c,), i32))
        flops = (_recsys_mlp_flops(cfg) + 2 * cfg.n_sparse * cfg.embed_dim) * c
        return CellProgram(
            arch_id=arch.arch_id, shape_name=cell.name, kind=kind,
            fn=retrieval_step, args=args,
            static_info={
                "model_flops": flops,
                "params": cfg.param_count(),
                "padded": {"n_candidates": [p["n_candidates"], c]},
            },
            init=init_params,
        )

    b = p["batch"]
    dense = _meta((b, cfg.n_dense), f32)
    sparse = _meta((b, cfg.n_sparse), i32)

    if kind == "recsys_serve":
        def serve_step(params_, dense_, sparse_):
            return recsys_forward(params_, cfg, dense_, sparse_)

        return CellProgram(
            arch_id=arch.arch_id, shape_name=cell.name, kind=kind,
            fn=serve_step, args=(params_meta, dense, sparse),
            static_info={
                "model_flops": _recsys_mlp_flops(cfg) * b,
                "params": cfg.param_count(),
            },
            init=init_params,
        )

    # recsys_train
    tx = _make_tx(arch.arch_id, lr=1e-3)
    state_meta = TrainState(step=_meta((), i32), params=params_meta, opt=tx.init(params_meta))

    def init_state(generator: torch.Generator) -> TrainState:
        params = init_params(generator)
        return TrainState(torch.zeros((), dtype=i32, device=device), params, tx.init(params))

    def train_step(state_: TrainState, dense_, sparse_, labels_):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), state_.params)
        with torch.enable_grad():
            loss, m = bce_loss(leaves, cfg, dense_, sparse_, labels_)
            loss.backward()
        grads = tree_map(
            lambda leaf: torch.zeros_like(leaf) if leaf.grad is None else leaf.grad, leaves
        )
        with torch.no_grad():
            updates, opt = tx.update(grads, state_.opt, state_.params)
            new_params = apply_updates(state_.params, updates)
        return TrainState(state_.step + 1, new_params, opt), {
            "loss": loss.detach(), "accuracy": m["accuracy"],
        }

    return CellProgram(
        arch_id=arch.arch_id, shape_name=cell.name, kind=kind,
        fn=train_step, args=(state_meta, dense, sparse, _meta((b,), f32)),
        static_info={
            "model_flops": 3.0 * _recsys_mlp_flops(cfg) * b,
            "params": cfg.param_count(),
        },
        init=init_state,
    )


# --------------------------------------------------------------- dispatcher
def _not_yet(item: str):
    def builder(arch: ArchSpec, cell: ShapeCell, device: torch.device) -> CellProgram:
        raise NotImplementedError(
            f"{arch.arch_id} {cell.name}: {cell.kind} cells are not yet ported to "
            f"repro_torch (ROADMAP {item})"
        )

    return builder


_BUILDERS = {
    "train": _lm_train_program,
    "prefill": _lm_prefill_program,
    "decode": _lm_decode_program,
    "gnn_full": _not_yet("A9e"),
    "gnn_minibatch": _not_yet("A9e"),
    "gnn_mol": _not_yet("A9e"),
    "recsys_train": _recsys_program,
    "recsys_serve": _recsys_program,
    "recsys_retrieval": _recsys_program,
    "contrastive": _not_yet("A10"),
    "retrieval_serve": _not_yet("A10"),
    "retrieval_eval": _not_yet("A10"),
}


def build_cell(
    arch_id: str,
    shape_name: str,
    device: Union[None, str, torch.device] = "cuda",
    *,
    model_cfg: Any = None,
    micro_batches: Optional[int] = None,
    global_batch: Optional[int] = None,
) -> CellProgram:
    """The cell's program on ``device`` (CUDA unless ``device="cpu"``).
    ``model_cfg`` replaces the arch's config, e.g. with capped vocabularies
    or fewer layers; ``micro_batches`` replaces the arch's microbatch count
    for this shape (``ArchSpec.micro_batches``); ``global_batch`` replaces
    the cell's global batch."""
    arch = get_arch(arch_id)
    if shape_name not in arch.shapes:
        raise KeyError(
            f"{arch_id} has no shape {shape_name!r}; known: {sorted(arch.shapes)}"
        )
    dev = resolve_device(device)
    if model_cfg is not None:
        arch = dataclasses.replace(arch, model_cfg=model_cfg)
    if micro_batches is not None:
        arch = dataclasses.replace(
            arch, micro_batches={**arch.micro_batches, shape_name: micro_batches})
    cell = arch.shapes[shape_name]
    if global_batch is not None:
        cell = dataclasses.replace(cell, params={**cell.params, "global_batch": global_batch})
    return _BUILDERS[cell.kind](arch, cell, dev)


def list_cells(include_contrastive: bool = True):
    """All (arch, shape) pairs of the registered archs."""
    out = []
    for arch_id in list_archs():
        arch = get_arch(arch_id)
        if arch.family == "bert" and not include_contrastive:
            continue
        for shape_name in arch.shapes:
            out.append((arch_id, shape_name))
    return out
