"""Carries weights between the JAX package and the port.

A JAX param pytree, handed over as nested dicts of numpy arrays (what
``jax.device_get`` or a trainer checkpoint gives), becomes the port's nested
dicts of tensors on a given device, and back. The port keeps the JAX layout
(BERT's per-layer weights stacked on a leading ``n_layers`` axis), so both
directions are a straight, bit-exact copy.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from repro_torch.core.precision import tensor_from_numpy, tensor_to_numpy


def params_to_torch(tree: Any, device: Union[str, torch.device]) -> Any:
    """Nested dicts of numpy arrays (or tensors) -> tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tensor_from_numpy(np.asarray(tree), device)


def params_to_numpy(tree: Any) -> Any:
    """Nested dicts of tensors -> nested dicts of host numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)
