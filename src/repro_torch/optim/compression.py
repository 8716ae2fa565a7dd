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


def compress_int8(x, amax=None):
    """x float -> (int8 codes, f32 0-d scale), round half to even as
    ``jnp.round``.  ``amax``: the max |x| to scale by, when x is a slice
    of a larger tensor (ZeRO-3: the whole leaf's)."""
    xf = x.float()
    if amax is None:
        amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def error_feedback_compress(grads, residuals, reduce_max=None):
    """Quantize grads + residuals; return (dequantized grads, new residuals).

    The returned grads are what the wire carries, each in its leaf's
    dtype; the f32 residuals hold each leaf's quantization error for the
    next step (``None``: zeros, the first step).  ``reduce_max`` maps the
    (n_leaves,) vector of each leaf's local max |g + r| to the whole
    leaf's, where the leaves are slices (ZeRO-3: a max over the model
    axis), so every scale is the one-process step's.
    """
    if residuals is None:
        residuals = tree.map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    tots = [g.float() + r for g, r in zip(tree.leaves(grads),
                                          tree.leaves(residuals))]
    amax = [None] * len(tots)
    if reduce_max is not None:
        amax = reduce_max(torch.stack([torch.max(torch.abs(t))
                                       for t in tots])).unbind()

    def one(g, tot, m):
        q, s = compress_int8(tot, m)
        deq = decompress_int8(q, s)
        return deq.to(g.dtype), tot - deq

    out = [one(g, t, m) for g, t, m in zip(tree.leaves(grads), tots, amax)]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))
