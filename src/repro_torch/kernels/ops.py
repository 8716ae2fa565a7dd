"""Public kernel ops of the port, routed by the device of their tensors.

The counterpart of ``repro.kernels.ops``, without a backend switch: a CPU
tensor takes the plain version, a CUDA tensor the Hopper kernel.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention


def attention(q, k, v, *, causal=True, window=0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); aligned-suffix positions."""
    return flash_attention(q, k, v, causal=causal, window=window)
