"""A twin of ``jax.random`` (threefry2x32) in torch ops.

The same key gives the same bits as ``jax.random`` under JAX's default
configuration (``jax_threefry_partitionable=True``,
``jax_default_prng_impl=threefry2x32``, x64 off): the counter of element i
of a draw of shape ``shape`` is the 64-bit flat index i, split into a high
and a low 32-bit word, and a draw's 32 bits are the xor of threefry's two
output words.

A key is an int64 tensor whose last axis holds the two 32-bit words
(values in [0, 2^32)); the uint32 arithmetic runs in int64, masked to 32
bits after every add and rotate.  Every function is tensor-only (no
``torch.Generator``, no host read), so it runs on the CPU, on the card and
inside a captured CUDA graph.

Batched forms come from broadcasting over the key's leading axes: a key
stack of shape ``(J, 2)`` gives draws of shape ``(J, *shape)``, row j equal
to the draw from ``keys[j]`` (``jax.vmap`` of the same call).  ``fold_in``
broadcasts its key against ``data``.

Normals are ``sqrt(2) * erfinv(u)`` with XLA's single-precision ``ErfInv``
(Giles' polynomial) written in torch ops; ``torch.special.erfinv`` is
another approximation (40% of f32 normals bit-equal to JAX's, up to 90
ulps apart).  The bits of ``log1p`` still differ between XLA and torch, so
normals agree with JAX's to a few ulps, not bit for bit
(``tests/test_torch_random.py`` states the tolerance).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of the counter words ``x1, x2``
    under the key words ``k1, k2``; all int64 tensors with 32-bit values,
    broadcast together, or all python ints (a key made on the host without
    a tensor op).  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with x64 off: the words (0, seed mod
    2^32)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _words(key, extra_dims: int):
    """The key's two words, shaped to broadcast against ``extra_dims``
    trailing counter axes."""
    lead = key.shape[:-1]
    view = lead + (1,) * extra_dims
    return key[..., 0].reshape(view), key[..., 1].reshape(view)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2); key i hashes the
    counter (0, i)."""
    k1, k2 = _words(key, 1)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hashes the counter (0, data).  ``key``
    (..., 2) broadcasts against ``data`` (an int or an int tensor): a key
    and ``arange(n)`` give the n column keys, a (J, 2) stack and a (J,)
    vector the vmapped fold."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    data = data & _MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits per element, (*key.shape[:-1], *shape) int64: the
    counter of element i is the flat index i as (hi, lo) words."""
    shape = tuple(shape)
    k1, k2 = _words(key, len(shape))
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return b1 ^ b2


# (bits kept, int view dtype, the bits of 1.0) per float type, as
# jax.random._uniform takes them: 8 random bits below 8 mantissa bits
_FLOAT_BITS = {
    torch.float32: (32, 23, torch.int32, 0x3F800000),
    torch.bfloat16: (8, 7, torch.int16, 0x3F80),
    torch.float16: (16, 10, torch.int16, 0x3C00),
}


def _as(value, dtype):
    """A python float rounded to ``dtype``, as XLA converts a constant."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def uniform(key: torch.Tensor, shape=(), dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: uniforms in [minval, maxval) of ``dtype``
    (f32, bf16 or f16), shape (*key.shape[:-1], *shape)."""
    rng_bits, nmant, view, one = _FLOAT_BITS[dtype]
    bits = random_bits(key, shape)
    if rng_bits != 32:
        bits = bits & ((1 << rng_bits) - 1)
    floats = ((bits >> (rng_bits - nmant)) | one).to(view).view(dtype) - 1.0
    lo, hi = _as(minval, dtype), _as(maxval, dtype)
    # XLA fuses the scale and shift into one multiply-add: in f64 the
    # product is exact, so one rounding to ``dtype`` gives its bits
    scaled = (floats.double() * _as(hi - lo, dtype) + lo).to(dtype)
    return torch.clamp(scaled, min=lo)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision ``ErfInv`` (Giles' polynomial, the
    ``w < 5`` and ``w >= 5`` branches) for f32 ``x``.  XLA's CPU backend
    contracts each Horner step ``c + p * w`` into one fused multiply-add;
    the step runs in f64 here (the f32 product is exact there) and rounds
    once to f32, which gives XLA's bits for ~99% of inputs."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(x.dtype)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, a, b).to(x.dtype)
        p = (c.double() + p.double() * w).to(x.dtype)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erfinv(u)`` with u uniform in
    (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0)
    return _as(math.sqrt(2.0), dtype) * erfinv(u)


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` (the default "low" Gumbel mode): argmax
    over ``axis`` of ``logits`` plus Gumbel noise of the logits' dtype.
    A key stack (J, 2) draws row j of ``logits`` (J, ...) from key j."""
    lead = key.ndim - 1
    tiny = float(torch.finfo(logits.dtype).tiny)
    u = uniform(key, logits.shape[lead:], logits.dtype, tiny, 1.0)
    return torch.argmax(-torch.log(-torch.log(u)) + logits, dim=axis)
