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
from typing import Optional, Union

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
