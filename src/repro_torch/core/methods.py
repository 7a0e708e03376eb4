"""The paper's training methods behind one switch: a registry over the
StepProgram compositions of core/step_program.py (``repro.core.methods``).

``dpr`` (direct x in-batch), ``grad_accum`` (scan x in-batch),
``grad_cache`` (rep_cache x in-batch), ``contaccum`` (scan x dual banks, the
paper's method), ``contcache`` (rep_cache x dual banks), ``prebatch`` and
``prebatch_cache`` (passage bank), ``mined*`` (mined negatives) and
``dpr_xdev`` (cross-device in-batch; needs ``dp_axis``). Every method honours
``cfg.loss_impl`` ('dense' | 'fused') and ``cfg.precision``.
"""

from __future__ import annotations

from repro_torch.core.step_program import (  # noqa: F401  (re-exported API)
    COMPOSITIONS,
    SOURCES,
    STRATEGIES,
    StepProgram,
    available_methods,
    build_step_program,
    init_state,
    method_composition,
    method_needs_mesh,
    method_uses_banks,
)
from repro_torch.core.types import ContrastiveConfig, DualEncoder
from repro_torch.optim.adamw import GradientTransformation


def make_update_fn(encoder: DualEncoder, tx: GradientTransformation, cfg: ContrastiveConfig):
    """Factory: the registered methods behind one switch."""
    return build_step_program(encoder, tx, cfg).update
