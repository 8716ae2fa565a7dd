"""Wrapper of the Hopper masked-mean kernel (``csrc/masked_grad_agg.cu``).

The port's counterpart of ``repro.kernels.masked_grad_agg``.  It computes
``ref.reference_masked_agg``: grads (W, N) and a float mask (W,) give the
(N,) cutoff-weighted mean ``sum_w m_w g_w / max(sum m, 1)``, accumulated in
f32, in the grads' dtype.  Rows may have any pitch (only the columns must
be contiguous) and N need not be a multiple of anything.

A CPU tensor goes to the plain version.  A CUDA tensor launches the kernel
or raises; nothing falls back.  Any other device raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import reference_masked_agg

NAME = "masked_grad_agg"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: most workers the kernel takes: the mask and c, W + 1 floats, fill at
#: most the 48 KB of shared memory a block has by default; must equal
#: MAX_WORKERS in csrc/masked_grad_agg.cu
MAX_WORKERS = 12287

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point, built and loaded at first use."""
    lib = build.load(NAME)
    if lib.masked_grad_agg_max_workers() != MAX_WORKERS:
        raise RuntimeError("masked_grad_agg: MAX_WORKERS differs between "
                           "the wrapper and csrc/masked_grad_agg.cu")
    fn = lib.masked_grad_agg
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(grads, mask):
    if grads.dim() != 2 or mask.dim() != 1 or mask.shape[0] != grads.shape[0]:
        raise ValueError(f"masked_grad_agg wants grads (W, N) and mask (W,); "
                         f"got {tuple(grads.shape)} and {tuple(mask.shape)}")
    if grads.shape[0] < 1 or grads.shape[1] < 1:
        raise ValueError(f"masked_grad_agg: empty grads {tuple(grads.shape)}")


def _launch(grads, mask):
    W, N = grads.shape
    if grads.dtype not in _DTYPE_CODE:
        raise ValueError(f"masked_grad_agg takes float32 or bfloat16 grads; "
                         f"got {grads.dtype}")
    if W > MAX_WORKERS:
        raise ValueError(f"masked_grad_agg: {W} workers > {MAX_WORKERS}")
    if grads.stride(1) != 1 or (W > 1 and grads.stride(0) < N):
        raise ValueError(f"masked_grad_agg: rows must be contiguous and not "
                         f"overlap; strides {grads.stride()}")
    if not mask.is_cuda or mask.device != grads.device:
        raise ValueError("masked_grad_agg: the mask must lie on the grads' "
                         "CUDA device")
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty(N, dtype=grads.dtype, device=grads.device)
    pitch = grads.stride(0) if W > 1 else N
    elt = grads.element_size()
    vector = (grads.data_ptr() % (4 * elt) == 0 and pitch % 4 == 0
              and out.data_ptr() % (4 * elt) == 0)
    stream = torch.cuda.current_stream(grads.device).cuda_stream
    with torch.cuda.device(grads.device):
        err = _kernel_fn()(grads.data_ptr(), mask.data_ptr(), out.data_ptr(),
                           _DTYPE_CODE[grads.dtype], W, N, pitch, int(vector),
                           stream)
    if err < 0:
        raise ValueError(f"masked_grad_agg: the kernel refused its arguments "
                         f"(code {err})")
    if err > 0:
        raise RuntimeError(f"masked_grad_agg launch failed: CUDA error {err}")
    build.LAUNCHES[NAME] += 1
    return out


def masked_grad_agg(grads, mask):
    """grads: (W, N); mask: (W,) float -> (N,) masked mean over workers."""
    _check(grads, mask)
    if grads.is_cuda:
        return _launch(grads, mask)
    if grads.device.type == "cpu":
        return reference_masked_agg(grads, mask.reshape(-1, 1))[0]
    raise ValueError(f"masked_grad_agg: no path for device {grads.device}")
