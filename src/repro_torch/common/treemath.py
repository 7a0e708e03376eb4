"""Math over nested dicts (and tuples) of tensors, the port's parameter
trees (``repro.common.treemath``)."""

from __future__ import annotations

from typing import Any, Callable, List

import torch

from repro_torch.core.precision import STATS_DTYPE


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf by leaf over trees of the same structure (dicts,
    tuples, lists); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out) if not hasattr(tree, "_fields") else type(tree)(*out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, dict):  # sorted keys: the JAX package's leaf order
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_add(a, b):
    """Elementwise a + b over matching trees."""
    return tree_map(torch.add, a, b)


def tree_scale(a, s):
    """Scale every leaf of ``a`` by scalar ``s``."""
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_global_norm(a) -> torch.Tensor:
    """Global L2 norm over all leaves, squares summed in fp32."""
    leaves = tree_leaves(a)
    if not leaves:
        return torch.zeros((), dtype=STATS_DTYPE)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(STATS_DTYPE))) for x in leaves))


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)
