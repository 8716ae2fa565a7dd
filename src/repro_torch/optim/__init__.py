from repro_torch.optim.compression import (
    compress_int8, decompress_int8, error_feedback_compress,
)
from repro_torch.optim.optimizers import (
    Optimizer, adam, adamw, apply_updates, chain, clip_by_global_norm,
    global_norm, momentum, sgd,
)
from repro_torch.optim.schedules import constant, cosine_schedule, linear_warmup

__all__ = [
    "compress_int8", "decompress_int8", "error_feedback_compress",
    "Optimizer", "adam", "adamw", "apply_updates", "chain",
    "clip_by_global_norm", "global_norm", "momentum", "sgd",
    "constant", "cosine_schedule", "linear_warmup",
]
