from repro_torch.optim.optimizers import (
    Optimizer, adam, adamw, apply_updates, chain, clip_by_global_norm,
    global_norm, momentum, sgd,
)
from repro_torch.optim.schedules import constant, cosine_schedule, linear_warmup

__all__ = [
    "Optimizer", "adam", "adamw", "apply_updates", "chain",
    "clip_by_global_norm", "global_norm", "momentum", "sgd",
    "constant", "cosine_schedule", "linear_warmup",
]
