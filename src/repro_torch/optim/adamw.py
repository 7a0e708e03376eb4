"""AdamW, SGD, global-norm clipping and ``chain`` over nested dicts of
tensors, the port of ``repro.optim.adamw``: the same optax-shaped
``GradientTransformation`` and the same arithmetic, update for update (eps
outside the square root, bias correction from a count that starts at 1,
moments stored in ``moment_dtype`` with fp32 arithmetic).

Paper hyperparameters (Appendix B): AdamW, lr 2e-5, eps 1e-8, weight decay 0,
global-norm clip 2.0, linear warmup + linear decay.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.common.treemath import tree_global_norm, tree_map
from repro_torch.core.precision import MASTER_DTYPE


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)


class AdamWState(NamedTuple):
    count: torch.Tensor  # () int32
    mu: Any              # first moment (params-shaped, moment_dtype)
    nu: Any              # second moment (params-shaped, moment_dtype)
    master: Any = None   # fp32 master params (only with keep_master_params)


def _lr(learning_rate, count):
    return learning_rate(count) if callable(learning_rate) else learning_rate


def adamw(
    learning_rate: Union[float, Callable],
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    mask: Optional[Callable[[Any], Any]] = None,
    moment_dtype: torch.dtype = MASTER_DTYPE,
    keep_master_params: bool = False,
) -> GradientTransformation:
    """AdamW. ``mask(params)`` returns a tree of bools selecting the leaves
    that get weight decay. ``moment_dtype=torch.bfloat16`` stores the moments
    in bf16 (the arithmetic stays fp32). ``keep_master_params=True`` carries
    fp32 masters in the state for params stored in low precision: the
    update runs on the masters and re-rounds the params from them each
    step, so rounding never compounds."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=moment_dtype)  # noqa: E731
        master = tree_map(lambda p: p.to(MASTER_DTYPE).clone(), params) if keep_master_params else None
        count = torch.zeros((), dtype=torch.int32, device=_device(params))
        return AdamWState(count=count, mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params), master=master)

    def update(grads, state, params):
        count = state.count + 1
        lr = _lr(learning_rate, count)
        f32 = MASTER_DTYPE
        mu = tree_map(
            lambda m, g: (b1 * m.to(f32) + (1.0 - b1) * g.to(f32)).to(moment_dtype),
            state.mu, grads,
        )
        nu = tree_map(
            lambda v, g: (b2 * v.to(f32) + (1.0 - b2) * torch.square(g.to(f32))).to(moment_dtype),
            state.nu, grads,
        )
        c1 = 1.0 - b1 ** count.to(f32)
        c2 = 1.0 - b2 ** count.to(f32)
        wd_mask = mask(params) if mask is not None else tree_map(lambda _: True, params)

        def step_of(m, v, base, use_wd):
            step = (m.to(f32) / c1) / (torch.sqrt(v.to(f32) / c2) + eps)
            if weight_decay:
                wd = torch.where(torch.as_tensor(use_wd, device=step.device),
                                 weight_decay, 0.0)
                step = step + wd * base
            return step

        if keep_master_params:
            new_master = tree_map(
                lambda m, v, mstr, use_wd: mstr - lr * step_of(m, v, mstr, use_wd),
                mu, nu, state.master, wd_mask,
            )
            # p_new = round(master_new): low-precision rounding never compounds
            updates = tree_map(lambda nm, p: nm.to(p.dtype) - p, new_master, params)
            return updates, AdamWState(count=count, mu=mu, nu=nu, master=new_master)

        updates = tree_map(
            lambda m, v, p, use_wd: (-lr * step_of(m, v, p.to(f32), use_wd)).to(p.dtype),
            mu, nu, params, wd_mask,
        )
        return updates, AdamWState(count=count, mu=mu, nu=nu, master=None)

    return GradientTransformation(init=init, update=update)


def _device(tree):
    from repro_torch.common.treemath import tree_leaves

    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def sgd(learning_rate: Union[float, Callable]) -> GradientTransformation:
    """Plain SGD."""

    def init(params):
        return torch.zeros((), dtype=torch.int32, device=_device(params))

    def update(grads, state, params=None):
        count = state + 1
        lr = _lr(learning_rate, count)
        return tree_map(lambda g: (-lr * g).to(g.dtype), grads), count

    return GradientTransformation(init=init, update=update)


class ClipState(NamedTuple):
    pass


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return ClipState()

    def update(grads, state, params=None):
        norm = tree_global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return tree_map(lambda g: (g * scale).to(g.dtype), grads), state

    return GradientTransformation(init=init, update=update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Compose transformations left to right (like optax.chain)."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init=init, update=update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
