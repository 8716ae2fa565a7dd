"""Wrapper of the Hopper chunkwise mLSTM kernel (``csrc/mlstm_chunk.cu``).

The port's counterpart of ``repro.kernels.mlstm_chunk``.  It computes the
stabilized normalized mLSTM recurrence with scale 1/sqrt(hd), the
function of ``ref.reference_mlstm`` and of
``mlstm_plain.linear_recurrence``, and returns the final recurrence state
as well: prefill hands it to decode as the cache.

q/k/v are (B, S, H, hd) in f32 or bf16, g/i (B, S, H) f32 log gates; the
result is y (B, S, H, hd) f32 and a ``ScanState`` (loga (B,H), m (B,H),
C (B,H,hd,hd), n (B,H,hd)), all f32.  The kernel and the plain version
walk the sequence in chunks that may differ (128 positions on the wgmma
path, 32 on the CUDA-core path; 128 or the whole of S in the plain
version), so their states hold the same true memory ``C * exp(m)`` under
different stabilizers m: compare them through a ``recurrence_step``, not
raw.

The kernel has two paths (``csrc/mlstm_chunk.cu``); ``choose_path`` picks
one by dtype, head dim and alignment, a pure function of the inputs'
shapes, tested without a card.  The wgmma path makes two CUDA kernels a
call (the chunk states, then the outputs), the CUDA-core path one.

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
from repro_torch.kernels.flash_attention import aligned16
from repro_torch.kernels.mlstm_plain import ScanState, linear_recurrence

NAME = "mlstm_chunk"
#: positions per chunk on the wgmma path (TC_CH in csrc/mlstm_chunk.cu),
#: the Pallas kernel's default chunk
CHUNK = 128
#: the kernel's paths, with their codes in the C interface
PATHS = {"simt": 0, "wgmma": 1}
#: the CUDA kernels one call launches on each path, by function name
PATH_KERNELS = {"simt": ("mlstm_fwd",),
                "wgmma": ("mlstm_state_tc", "mlstm_out_tc")}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 15
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p])


def choose_path(dtype, hd: int, aligned: bool) -> str:
    """The kernel path for a call: ``"wgmma"`` (tensor cores) for bf16
    q/k/v whose pointers and strides are 16-byte aligned and whose head dim
    is a multiple of 64 (the path copies 16 bytes at a time and tiles the
    head dim by 64); ``"simt"`` (CUDA cores) for the rest: f32 (only the
    parity runs use it), hd 16 or 32, and views off 16-byte alignment."""
    if dtype == torch.bfloat16 and hd % 64 == 0 and aligned:
        return "wgmma"
    return "simt"


def scratch_floats(B: int, S: int, H: int, hd: int) -> int:
    """f32 words of the wgmma path's scratch: the state entering each chunk
    after the first (C as bf16 hi and lo, n, m), written by the state
    kernel for the outputs kernel.  0 when S fits one chunk."""
    entering = (-(-S // CHUNK) - 1) * B * H
    return entering * (hd * hd + hd + 1)


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
    path = choose_path(q.dtype, hd, aligned16(q, k, v))
    scratch = None
    if path == "wgmma" and scratch_floats(B, S, H, hd):
        scratch = torch.empty(scratch_floats(B, S, H, hd), **f32)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 i.data_ptr(), y.data_ptr(), C.data_ptr(), n.data_ptr(),
                 m.data_ptr(), loga.data_ptr(), _DTYPE_CODE[q.dtype],
                 B, S, H, hd, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *g.stride(), *i.stride(),
                 1.0 / math.sqrt(hd), PATHS[path],
                 None if scratch is None else scratch.data_ptr(), stream)
    if err == -1:
        raise ValueError(f"mlstm_chunk: csrc/mlstm_chunk.cu takes no "
                         f"head_dim {hd} (16, 32 or a multiple of 64 up "
                         f"to 512)")
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
