from repro_torch.optim.adamw import (
    GradientTransformation,
    adamw,
    apply_updates,
    chain,
    clip_by_global_norm,
    sgd,
)
from repro_torch.optim.schedules import constant_schedule, cosine_decay, linear_warmup_linear_decay

__all__ = [
    "adamw", "sgd", "apply_updates", "clip_by_global_norm", "chain",
    "GradientTransformation", "linear_warmup_linear_decay", "constant_schedule",
    "cosine_decay",
]
