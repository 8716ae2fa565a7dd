"""Wrapper of the Hopper masked-mean kernel (``csrc/masked_grad_agg.cu``).

The port's counterpart of ``repro.kernels.masked_grad_agg``.  It computes
``ref.reference_masked_agg``: grads (W, N) and a float mask (W,) give the
(N,) cutoff-weighted mean ``sum_w m_w g_w / max(sum m, 1)``, accumulated in
f32, in the grads' dtype; with ``mean=False`` (sum mode) the masked sum
``sum_w m_w g_w``, undivided, which a data-parallel rank all-reduces before
the division (``core.aggregation.masked_psum_mean``).  Rows may have any
pitch (only the columns must be contiguous) and N need not be a multiple of
anything.  ``out``, when given, is the (N,) contiguous tensor of the grads'
dtype and device the result is written into.

Launches are counted by mode: ``LAUNCHES["masked_grad_agg"]`` for the mean,
``LAUNCHES["masked_grad_agg_sum"]`` for the sum.

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
SUM_NAME = "masked_grad_agg_sum"    # the launch count of the sum mode
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: most workers the kernel takes: the mask and c, W + 1 floats, fill at
#: most the 48 KB of shared memory a block has by default; must equal
#: MAX_WORKERS in csrc/masked_grad_agg.cu
MAX_WORKERS = 12287

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])


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


def _check(grads, mask, out):
    if grads.dim() != 2 or mask.dim() != 1 or mask.shape[0] != grads.shape[0]:
        raise ValueError(f"masked_grad_agg wants grads (W, N) and mask (W,); "
                         f"got {tuple(grads.shape)} and {tuple(mask.shape)}")
    if grads.shape[0] < 1 or grads.shape[1] < 1:
        raise ValueError(f"masked_grad_agg: empty grads {tuple(grads.shape)}")
    if out is not None and (
            tuple(out.shape) != (grads.shape[1],) or out.dtype != grads.dtype
            or out.device != grads.device or not out.is_contiguous()):
        raise ValueError(
            f"masked_grad_agg: out must be a contiguous ({grads.shape[1]},) "
            f"{grads.dtype} tensor on {grads.device}; got "
            f"{tuple(out.shape)} {out.dtype} on {out.device}")


def _launch(grads, mask, mean, out):
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
    if out is None:
        out = torch.empty(N, dtype=grads.dtype, device=grads.device)
    pitch = grads.stride(0) if W > 1 else N
    elt = grads.element_size()
    vector = (grads.data_ptr() % (4 * elt) == 0 and pitch % 4 == 0
              and out.data_ptr() % (4 * elt) == 0)
    stream = torch.cuda.current_stream(grads.device).cuda_stream
    with torch.cuda.device(grads.device):
        err = _kernel_fn()(grads.data_ptr(), mask.data_ptr(), out.data_ptr(),
                           _DTYPE_CODE[grads.dtype], W, N, pitch, int(vector),
                           int(mean), stream)
    if err < 0:
        raise ValueError(f"masked_grad_agg: the kernel refused its arguments "
                         f"(code {err})")
    if err > 0:
        raise RuntimeError(f"masked_grad_agg launch failed: CUDA error {err}")
    build.LAUNCHES[NAME if mean else SUM_NAME] += 1
    return out


def masked_grad_agg(grads, mask, *, mean: bool = True, out=None):
    """grads: (W, N); mask: (W,) float -> (N,) masked mean over workers
    (``mean=False``: the masked sum), written into ``out`` when given."""
    _check(grads, mask, out)
    if grads.is_cuda:
        return _launch(grads, mask, mean, out)
    if grads.device.type == "cpu":
        res = reference_masked_agg(grads, mask.reshape(-1, 1), mean=mean)[0]
        if out is None:
            return res
        return out.copy_(res)
    raise ValueError(f"masked_grad_agg: no path for device {grads.device}")
