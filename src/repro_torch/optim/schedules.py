"""Learning-rate schedules (``repro.optim.schedules``): functions of the
step count (a tensor or an int) returning an fp32 tensor. The paper
(Appendix B) uses linear warmup then linear decay to zero."""

from __future__ import annotations

import math

import torch

from repro_torch.core.precision import MASTER_DTYPE


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(MASTER_DTYPE)


def constant_schedule(lr: float):
    def schedule(step):
        return torch.full((), lr, dtype=MASTER_DTYPE, device=_step(step).device)

    return schedule


def linear_warmup_linear_decay(peak_lr: float, warmup_steps: int, total_steps: int):
    """0 -> peak over ``warmup_steps``, then linearly to 0 at ``total_steps``."""
    warmup_steps = max(int(warmup_steps), 1)
    total_steps = max(int(total_steps), warmup_steps + 1)

    def schedule(step):
        step = _step(step)
        warm = step / warmup_steps
        decay = (total_steps - step) / float(total_steps - warmup_steps)
        frac = torch.where(step < warmup_steps, warm, decay)
        return peak_lr * torch.clamp(frac, 0.0, 1.0)

    return schedule


def cosine_decay(peak_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.0):
    warmup_steps = max(int(warmup_steps), 1)
    total_steps = max(int(total_steps), warmup_steps + 1)

    def schedule(step):
        step = _step(step)
        warm = step / warmup_steps
        prog = torch.clamp((step - warmup_steps) / (total_steps - warmup_steps), 0.0, 1.0)
        cos = min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(step < warmup_steps, warm, cos)

    return schedule
