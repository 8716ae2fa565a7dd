"""Gradient compression for the cross-pod all-reduce (a copy of
``repro.optim.compression`` over the port's trees).

int8 per-tensor-scale quantization with error feedback: the residual of
each quantization step is carried and added to the next gradient, so the
compression error does not accumulate (Seide et al. / 1-bit-SGD style EF).
Plain torch, as the reference is plain ``jnp``: elementwise passes and one
max per leaf.
"""
from __future__ import annotations

import torch

from repro_torch import tree


def compress_int8(x):
    """x float -> (int8 codes, f32 0-d scale), round half to even as
    ``jnp.round``."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def error_feedback_compress(grads, residuals):
    """Quantize grads + residuals; return (dequantized grads, new residuals).

    The returned grads are what the wire carries, each in its leaf's
    dtype; the f32 residuals hold each leaf's quantization error for the
    next step (``None``: zeros, the first step).
    """
    if residuals is None:
        residuals = tree.map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def one(g, r):
        tot = g.float() + r
        q, s = compress_int8(tot)
        deq = decompress_int8(q, s)
        return deq.to(g.dtype), tot - deq

    out = [one(g, r) for g, r in zip(tree.leaves(grads),
                                     tree.leaves(residuals))]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))
