"""Wrapper of the Hopper chunkwise mLSTM kernel (``csrc/mlstm_chunk.cu``).

The port's counterpart of ``repro.kernels.mlstm_chunk``.  It computes the
stabilized normalized mLSTM recurrence with scale 1/sqrt(hd), the
function of ``ref.reference_mlstm`` and of
``mlstm_plain.linear_recurrence``, and returns the final recurrence state
as well: prefill hands it to decode as the cache.

q/k/v are (B, S, H, hd) in f32 or bf16, g/i (B, S, H) f32 log gates; the
result is y (B, S, H, hd) f32 and a ``ScanState`` (loga (B,H), m (B,H),
C (B,H,hd,hd), n (B,H,hd)), all f32.  The kernel and the plain version
walk the sequence in chunks of different lengths (32 positions on the
card; 128 or the whole of S in the plain version), so their states hold
the same true memory ``C * exp(m)`` under different stabilizers m: compare
them through a ``recurrence_step``, not raw.

A CPU tensor goes to the plain version (``mlstm_plain.linear_recurrence``).
A CUDA tensor launches the kernel or raises; nothing falls back.  The
kernel has no backward: on the card, a call that would need a gradient
raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mlstm_plain import ScanState, linear_recurrence

NAME = "mlstm_chunk"
#: positions per chunk in the CUDA kernel (CH in csrc/mlstm_chunk.cu)
CHUNK = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 15 + [ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point, built and loaded at first use."""
    fn = build.load(NAME).mlstm_chunk_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, g, i):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm_chunk wants q, k, v (B,S,H,hd) alike; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if g.shape != q.shape[:3] or i.shape != q.shape[:3]:
        raise ValueError(f"mlstm_chunk wants g, i (B,S,H) = "
                         f"{tuple(q.shape[:3])}; got {tuple(g.shape)}, "
                         f"{tuple(i.shape)}")
    if min(q.shape) < 1:
        raise ValueError(f"mlstm_chunk: empty input {tuple(q.shape)}")


def _launch(q, k, v, g, i):
    B, S, H, hd = q.shape
    if not all(t.is_cuda and t.device == q.device for t in (k, v, g, i)):
        raise ValueError("mlstm_chunk: q, k, v, g, i must lie on one CUDA "
                         "device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"mlstm_chunk takes float32 or bfloat16 q, k, v "
                         f"alike; got {q.dtype}, {k.dtype}, {v.dtype}")
    if g.dtype != torch.float32 or i.dtype != torch.float32:
        raise ValueError(f"mlstm_chunk takes float32 log gates; got "
                         f"{g.dtype}, {i.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"mlstm_chunk: {name} must be contiguous in "
                             f"head_dim; strides {t.stride()}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, g, i)):
        raise NotImplementedError(
            "mlstm_chunk has no backward kernel: xLSTM training on the card "
            "waits for its autograd Function (ROADMAP, xLSTM training)")
    f32 = dict(dtype=torch.float32, device=q.device)
    y = torch.empty((B, S, H, hd), **f32)
    C = torch.empty((B, H, hd, hd), **f32)
    n = torch.empty((B, H, hd), **f32)
    m = torch.empty((B, H), **f32)
    loga = torch.empty((B, H), **f32)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 i.data_ptr(), y.data_ptr(), C.data_ptr(), n.data_ptr(),
                 m.data_ptr(), loga.data_ptr(), _DTYPE_CODE[q.dtype],
                 B, S, H, hd, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *g.stride(), *i.stride(),
                 1.0 / math.sqrt(hd), stream)
    if err == -1:
        raise ValueError(f"mlstm_chunk: csrc/mlstm_chunk.cu takes no "
                         f"head_dim {hd} (see value_tile there)")
    if err < 0:
        raise ValueError(f"mlstm_chunk: the kernel refused its arguments "
                         f"(code {err})")
    if err > 0:
        raise RuntimeError(f"mlstm_chunk launch failed: CUDA error {err}")
    build.LAUNCHES[NAME] += 1
    return y, ScanState(loga=loga, m=m, C=C, n=n)


def mlstm_chunk(q, k, v, g, i):
    """q/k/v: (B, S, H, hd); g/i: (B, S, H) f32 log gates ->
    (y (B, S, H, hd) f32, final ``ScanState``)."""
    _check(q, k, v, g, i)
    if q.is_cuda:
        return _launch(q, k, v, g, i)
    if q.device.type == "cpu":
        return linear_recurrence(q, k, v, g, i)
    raise ValueError(f"mlstm_chunk: no path for device {q.device}")
