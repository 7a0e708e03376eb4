"""PrecisionPolicy: the one owner of every dtype decision of the port.

Mirrors ``repro.core.precision``: the presets name the same dtypes, as torch
dtypes, so one preset name drives both packages.

    fp32        params fp32 | compute fp32 | banks fp32 | accum fp32
    bf16        params fp32 | compute bf16 | banks fp32 | accum fp32
    bf16_banks  params fp32 | compute bf16 | banks bf16 | accum fp32

Stored params stay fp32 in every preset and are cast to ``compute_dtype`` at
application; the search index is stored in ``bank_dtype``; scores are always
``SCORE_DTYPE``. This module is also the one place that spells numpy float
dtypes (the repo's dtype lint allows them only in a ``core/precision.py``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Optional, Union

import numpy as np
import torch

#: The finite score sentinel of masked columns and empty top-k slots. Never
#: ``-inf``: a fully masked row must stay finite through every reduction.
NEG_INF = -1e30

#: Named contract dtypes, fp32 in every preset (``repro.core.precision``):
#: STATS_DTYPE - every statistic that feeds logging or control (loss,
#:   accuracy, bank fill, softmax statistics) is cast here before reduction;
#: SCORE_DTYPE - retrieval scores and top-k merge buffers;
#: MASTER_DTYPE - AdamW master weights and moments.
STATS_DTYPE = torch.float32
SCORE_DTYPE = torch.float32
MASTER_DTYPE = torch.float32
#: numpy dtype of host-made float arrays (synthetic batches), fp32 as in JAX
HOST_FLOAT_DTYPE = np.float32


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Dtype assignments for one run (see the module docstring)."""

    name: str = "fp32"
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    bank_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32

    def cast_compute(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Cast a tensor (or None) to the compute dtype; identity under fp32."""
        if x is None:
            return None
        return x.to(self.compute_dtype)


PRECISION_PRESETS = {
    "fp32": PrecisionPolicy(name="fp32"),
    "bf16": PrecisionPolicy(name="bf16", compute_dtype=torch.bfloat16),
    "bf16_banks": PrecisionPolicy(
        name="bf16_banks", compute_dtype=torch.bfloat16, bank_dtype=torch.bfloat16
    ),
}


def resolve_precision(
    spec: Union[None, str, PrecisionPolicy] = None,
) -> PrecisionPolicy:
    """None -> fp32; a preset name -> the registered policy; an instance ->
    as is. Raises ValueError for unknown names."""
    if spec is None:
        return PRECISION_PRESETS["fp32"]
    if isinstance(spec, str):
        if spec not in PRECISION_PRESETS:
            raise ValueError(
                f"unknown precision {spec!r}; one of {sorted(PRECISION_PRESETS)}"
            )
        return PRECISION_PRESETS[spec]
    return spec


class _CastOnRead(Mapping):
    """A read-only view of a param dict whose float leaves read as ``dtype``.
    A leaf is cast when it is first read (then kept for the view's life), so
    a leaf the encoder never reads (the other tower, the LM head that
    ``encode_pooled`` skips) is never cast: the values are those of casting
    the whole tree, as the JAX package does, where XLA drops the unused
    casts as dead code."""

    def __init__(self, tree: Mapping, dtype: torch.dtype):
        self._tree, self._dtype, self._read = tree, dtype, {}

    def __getitem__(self, key):
        if key not in self._read:
            self._read[key] = _cast_floats(self._tree[key], self._dtype, on_read=True)
        return self._read[key]

    def __iter__(self):
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)


def _cast_floats(tree: Any, dtype: torch.dtype, *, on_read: bool = False) -> Any:
    """``tree`` (nested dicts, lists and tuples) with its float leaves in
    ``dtype``, other leaves as they are; with ``on_read`` its dicts become
    cast-on-read views."""
    if isinstance(tree, Mapping):
        if on_read:
            return _CastOnRead(tree, dtype)
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype, on_read=on_read) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def apply_compute_dtype(encoder, policy: Union[str, PrecisionPolicy]):
    """Wrap a DualEncoder so params are cast to ``compute_dtype`` at
    application and the emitted representations are in ``compute_dtype``
    (``repro.core.precision.apply_compute_dtype``): stored params stay in
    ``param_dtype`` (fp32 masters) and ``init`` casts to it; each encode
    reads its params through a cast-on-read view, so the compute copies are
    transient, made per call, and only of what the encoder reads; float
    inputs are cast alongside. Identity under fp32."""
    from repro_torch.core.types import DualEncoder

    policy = resolve_precision(policy)
    ct = policy.compute_dtype

    def encode_query(params, batch):
        return encoder.encode_query(_cast_floats(params, ct, on_read=True),
                                    _cast_floats(batch, ct)).to(ct)

    def encode_passage(params, batch):
        return encoder.encode_passage(_cast_floats(params, ct, on_read=True),
                                      _cast_floats(batch, ct)).to(ct)

    def init(*a, **kw):
        return _cast_floats(encoder.init(*a, **kw), policy.param_dtype)

    return DualEncoder(
        init=init,
        encode_query=encode_query,
        encode_passage=encode_passage,
        rep_dim=encoder.rep_dim,
    )


def tensor_from_numpy(a: np.ndarray, device: Union[str, torch.device]) -> torch.Tensor:
    """A numpy array (float32, int, bool, or ml_dtypes bfloat16 as JAX hands
    it out) as a tensor on ``device``, bit for bit."""
    a = np.array(a)  # a writable copy: the tensor must not alias read-only memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array, bit for bit; bf16 comes back as an
    ml_dtypes bfloat16 array, the type JAX uses."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
