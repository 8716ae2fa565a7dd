"""Wrapper of the Hopper chunkwise mLSTM kernel (``csrc/mlstm_chunk.cu``).

The port's counterpart of ``repro.kernels.mlstm_chunk``.  It computes the
stabilized normalized mLSTM recurrence with scale 1/sqrt(hd), the
function of ``ref.reference_mlstm`` and of
``mlstm_plain.linear_recurrence``, and returns the final recurrence state
as well: prefill hands it to decode as the cache.  With
``normalize=False`` and a ``scale`` of its own it computes the other form
of the JAX package's ``ssm.linear_recurrence``, the one Hymba's Mamba
heads call (``normalize=False, scale=1.0``, q/k 16 wide and broadcast
over the heads, v 128 wide).

q/k are (B, S, H, dq) and v (B, S, H, dv) in f32 or bf16, g/i (B, S, H) f32
log gates; the result is y (B, S, H, dv) f32 and a ``ScanState`` (loga
(B,H), m (B,H), C (B,H,dq,dv), n (B,H,dq)), all f32.  q/k may be views with
a head stride of 0 (an ``expand`` over H): the kernel reads by strides, so
the broadcast is never materialized.  The kernel and the plain version walk
the sequence in chunks that may differ (128 positions on the wgmma path, 32
on the CUDA-core path; 128 or the whole of S in the plain version), so
their states hold the same true memory ``C * exp(m)`` under different
stabilizers m: compare them through a ``recurrence_step``, not raw.

The kernel has two paths (``csrc/mlstm_chunk.cu``); ``choose_path`` picks
one by dtype, head dim, alignment and form (the wgmma path takes the
normalized, square one only), a pure function of the inputs' shapes,
tested without a card.  The wgmma path makes two CUDA kernels a
call (the chunk states, then the outputs), the CUDA-core path one.

A CPU tensor goes to the plain version (``mlstm_plain.linear_recurrence``),
which autograd differentiates as it is.  A CUDA tensor launches the kernel
or raises; nothing falls back.  On the card, a call that needs a gradient
(grad mode on and an input that requires one: xLSTM and Hymba training)
goes through ``MLSTMChunk``: the kernel forward, and a backward that
recomputes the plain recurrence in f32, in the same form, and
differentiates it.  The JAX package has no Pallas backward either: its
xLSTM gradient is XLA's autodiff of the jnp ``ssm.linear_recurrence``, so a
Hopper backward is later work.
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

_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 15
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p])


def choose_path(dtype, hd: int, aligned: bool, *, dv=None,
                normalize: bool = True) -> str:
    """The kernel path for a call: ``"wgmma"`` (tensor cores) for bf16
    q/k/v whose pointers and strides are 16-byte aligned and whose head dim
    is a multiple of 64 (the path copies 16 bytes at a time and tiles the
    head dim by 64), in the normalized form with v as wide as q/k (``dv``
    None or ``hd``); ``"simt"`` (CUDA cores) for the rest: f32 (only the
    parity runs use it), hd 16 or 32, views off 16-byte alignment, and the
    unnormalized or unequal-width form (Hymba's Mamba heads)."""
    if (dtype == torch.bfloat16 and hd % 64 == 0 and aligned and normalize
            and dv in (None, hd)):
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
    if (q.dim() != 4 or k.shape != q.shape or v.dim() != 4
            or v.shape[:3] != q.shape[:3]):
        raise ValueError(f"mlstm_chunk wants q, k (B,S,H,dq) alike and v "
                         f"(B,S,H,dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if g.shape != q.shape[:3] or i.shape != q.shape[:3]:
        raise ValueError(f"mlstm_chunk wants g, i (B,S,H) = "
                         f"{tuple(q.shape[:3])}; got {tuple(g.shape)}, "
                         f"{tuple(i.shape)}")
    if min(q.shape) < 1:
        raise ValueError(f"mlstm_chunk: empty input {tuple(q.shape)}")


def _launch(q, k, v, g, i, normalize=True, scale=None):
    B, S, H, dq = q.shape
    dv = v.shape[-1]
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
    f32 = dict(dtype=torch.float32, device=q.device)
    y = torch.empty((B, S, H, dv), **f32)
    C = torch.empty((B, H, dq, dv), **f32)
    n = torch.empty((B, H, dq), **f32)
    m = torch.empty((B, H), **f32)
    loga = torch.empty((B, H), **f32)
    path = choose_path(q.dtype, dq, aligned16(q, k, v), dv=dv,
                       normalize=normalize)
    scratch = None
    if path == "wgmma" and scratch_floats(B, S, H, dq):
        scratch = torch.empty(scratch_floats(B, S, H, dq), **f32)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 i.data_ptr(), y.data_ptr(), C.data_ptr(), n.data_ptr(),
                 m.data_ptr(), loga.data_ptr(), _DTYPE_CODE[q.dtype],
                 B, S, H, dq, dv, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *g.stride(), *i.stride(),
                 1.0 / math.sqrt(dq) if scale is None else float(scale),
                 int(normalize), PATHS[path],
                 None if scratch is None else scratch.data_ptr(), stream)
    if err == -1:
        raise ValueError(f"mlstm_chunk: csrc/mlstm_chunk.cu takes no "
                         f"width {dq} of q/k or {dv} of v (16, 32 or a "
                         f"multiple of 64 up to 512)")
    if err < 0:
        raise ValueError(f"mlstm_chunk: the kernel refused its arguments "
                         f"(code {err})")
    if err > 0:
        raise RuntimeError(f"mlstm_chunk launch failed: CUDA error {err}")
    build.LAUNCHES[NAME] += 1
    return y, ScanState(loga=loga, m=m, C=C, n=n)


class MLSTMChunk(torch.autograd.Function):
    """``mlstm_chunk`` with a gradient, for training.

    ``apply(q, k, v, g, i[, normalize, scale])``: the two options trail the
    tensors with ``mlstm_chunk``'s defaults and take no gradient.  The
    forward is the kernel on a CUDA tensor (the plain version on a CPU one)
    and returns y and the final state's four tensors.  The backward
    recomputes ``linear_recurrence`` in f32, in the same form, from the
    saved q, k, v, g, i and differentiates it (unnormalized, its gradients
    of g and i pass through the stabilizer's max, as JAX's do), as
    ``FlashAttention.backward`` does with the plain attention; each gradient
    comes back in its input's dtype.  The final state takes no gradient: a
    gradient that reaches it raises rather than being dropped (its outputs
    stay in the graph for that reason, where ``mark_non_differentiable``
    would make a loss that reads both y and the state lose the state's part
    without a word).
    """

    @staticmethod
    def forward(ctx, q, k, v, g, i, normalize=True, scale=None):
        ctx.save_for_backward(q, k, v, g, i)
        ctx.set_materialize_grads(False)
        ctx.form = {"normalize": normalize, "scale": scale}
        if q.is_cuda:
            y, st = _launch(q, k, v, g, i, **ctx.form)
        else:
            y, st = linear_recurrence(q, k, v, g, i, **ctx.form)
        return (y, *st)

    @staticmethod
    def backward(ctx, dy, *dstate):
        if any(d is not None for d in dstate):
            raise RuntimeError(
                "mlstm_chunk: the final ScanState takes no gradient (it is "
                "the decode cache); differentiate through y only")
        # the options (when given) take no gradient
        opts = (None,) * (len(ctx.needs_input_grad) - 5)
        if dy is None:
            return (None,) * 5 + opts
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in
                      zip(ctx.saved_tensors, ctx.needs_input_grad)]
            y, _ = linear_recurrence(*(t.float() for t in leaves),
                                     **ctx.form)
            want = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, want, dy))
        return tuple(next(grads) if t.requires_grad else None
                     for t in leaves) + opts


def mlstm_chunk(q, k, v, g, i, *, normalize: bool = True, scale=None):
    """q/k: (B, S, H, dq); v: (B, S, H, dv); g/i: (B, S, H) f32 log gates
    -> (y (B, S, H, dv) f32, final ``ScanState``).  ``normalize`` and
    ``scale`` (None: 1/sqrt(dq)) as ``mlstm_plain.linear_recurrence``
    takes them.  On the card a call that needs a gradient goes through
    :class:`MLSTMChunk`."""
    _check(q, k, v, g, i)
    if q.is_cuda:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v, g, i)):
            y, *st = MLSTMChunk.apply(q, k, v, g, i, normalize, scale)
            return y, ScanState(*st)
        return _launch(q, k, v, g, i, normalize, scale)
    if q.device.type == "cpu":
        return linear_recurrence(q, k, v, g, i, normalize=normalize,
                                 scale=scale)
    raise ValueError(f"mlstm_chunk: no path for device {q.device}")
