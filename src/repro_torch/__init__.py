"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

Subpackages mirror ``repro``'s names so each module has an obvious
counterpart.  The port never imports JAX or ``repro``; only its tests
import both.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no device given they raise.
"""
from __future__ import annotations


def resolve_device(device=None) -> "torch.device":
    """``None`` means the card; without a card that is an error, never a
    quiet move to the CPU."""
    # torch is imported here, not with the package: the control plane's
    # subprocess worker (numpy and stdlib) starts without it
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain path")
        return torch.device("cuda")
    return torch.device(device)
