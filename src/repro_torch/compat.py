"""Carries weights between the JAX package and the port.

A JAX param pytree, handed over as nested dicts of numpy arrays (what
``jax.device_get`` or a trainer checkpoint gives), becomes the port's nested
dicts of tensors on a given device, and back. The port keeps the JAX layout
(BERT's per-layer weights stacked on a leading ``n_layers`` axis; the recsys
MLPs as lists of per-layer dicts), so both directions are a straight,
bit-exact copy that keeps dicts, lists and tuples as they are.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from repro_torch.core.precision import tensor_from_numpy, tensor_to_numpy


def params_to_torch(tree: Any, device: Union[str, torch.device]) -> Any:
    """Nested dicts, lists and tuples of numpy arrays (or tensors) -> the
    same structure of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _like(tree, [params_to_torch(v, device) for v in tree])
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tensor_from_numpy(np.asarray(tree), device)


def params_to_numpy(tree: Any) -> Any:
    """Nested dicts, lists and tuples of tensors -> the same structure of host
    numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _like(tree, [params_to_numpy(v) for v in tree])
    return tensor_to_numpy(tree)


def _like(tree: Any, values: list) -> Any:
    """A list or tuple (a NamedTuple too) of ``tree``'s type holding ``values``."""
    return type(tree)(*values) if hasattr(tree, "_fields") else type(tree)(values)
