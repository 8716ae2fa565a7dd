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
the broadcast is never materialized.  An ``init_state`` (a ``ScanState`` of
those shapes) starts the recurrence from it instead of the zero state, and
the final state is then its combine with the sequence's: under sequence
parallelism a rank's columns start from the ranks' before it
(``ops.mlstm``).  ``outputs=False`` returns the final state alone (y
None), the rank's own summary those prefixes are made of.  The kernel and
the plain version walk the sequence in chunks that may differ (128
positions on the wgmma path, 32 on the CUDA-core path; 128 or the whole of
S in the plain version), but both carry m as the running max of the log
weights, ``combine``'s ``max(m1 + loga2, m2)``, which no chunking changes:
their states agree entry by entry up to rounding, so a gradient on one is
a gradient on the other.

The kernel has two paths (``csrc/mlstm_chunk.cu``); ``choose_path`` picks
one by dtype, head dim, alignment and form (the wgmma path takes the
normalized, square one only), a pure function of the inputs' shapes,
tested without a card.  The wgmma path makes two CUDA kernels a
call (the chunk states, then the outputs), the CUDA-core path one.

A CPU tensor goes to the plain version (``mlstm_plain.local_recurrence``),
which autograd differentiates as it is.  A CUDA tensor launches the kernel
or raises; nothing falls back.  On the card, a call that needs a gradient
(grad mode on and an input that requires one: xLSTM and Hymba training)
goes through ``MLSTMChunk``: the kernel forward, and a backward that
recomputes the plain recurrence in f32, in the same form, from the same
entering state, and differentiates y and the final state together.  The
JAX package has no Pallas backward either: its xLSTM gradient is XLA's
autodiff of the jnp ``ssm.linear_recurrence``, so a Hopper backward is
later work.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import aligned16
from repro_torch.kernels.mlstm_plain import ScanState, local_recurrence

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

_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
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


def scratch_floats(B: int, S: int, H: int, hd: int, init: bool = False
                   ) -> int:
    """f32 words of the wgmma path's scratch: the state entering each chunk
    after the first, and the first too with an ``init`` state (C as bf16
    hi and lo, n, m), written by the state kernel for the outputs kernel.
    0 when S fits one chunk and no state enters it."""
    entering = (-(-S // CHUNK) - 1 + int(init)) * B * H
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


def _init_args(init_state, B, H, dq, dv, device):
    """The entering state's four f32 tensors in the C interface's order
    (C, n, m, loga), contiguous, checked; four Nones without one."""
    if init_state is None:
        return (None,) * 4
    want = {"C": (B, H, dq, dv), "n": (B, H, dq), "m": (B, H),
            "loga": (B, H)}
    out = []
    for name in ("C", "n", "m", "loga"):
        t = getattr(init_state, name)
        if (tuple(t.shape) != want[name] or t.dtype != torch.float32
                or t.device != device):
            raise ValueError(f"mlstm_chunk: init_state.{name} must be "
                             f"float32 {want[name]} on {device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        out.append(t.contiguous())
    return tuple(out)


def _launch(q, k, v, g, i, normalize=True, scale=None, init_state=None,
            outputs=True):
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
    init = _init_args(init_state, B, H, dq, dv, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    y = torch.empty((B, S, H, dv), **f32) if outputs else None
    C = torch.empty((B, H, dq, dv), **f32)
    n = torch.empty((B, H, dq), **f32)
    m = torch.empty((B, H), **f32)
    loga = torch.empty((B, H), **f32)
    path = choose_path(q.dtype, dq, aligned16(q, k, v), dv=dv,
                       normalize=normalize)
    scratch = None
    words = scratch_floats(B, S, H, dq, init_state is not None)
    if path == "wgmma" and outputs and words:
        scratch = torch.empty(words, **f32)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 i.data_ptr(), None if y is None else y.data_ptr(),
                 C.data_ptr(), n.data_ptr(), m.data_ptr(), loga.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in init),
                 _DTYPE_CODE[q.dtype],
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

    ``apply(q, k, v, g, i[, normalize, scale, outputs, *init])``: the
    options trail the tensors with ``mlstm_chunk``'s defaults and take no
    gradient; ``init`` is an entering state's four tensors in ``ScanState``
    order (loga, m, C, n), or nothing.  The forward is the kernel on a CUDA
    tensor (the plain version on a CPU one) and returns y and the final
    state's four tensors, or (``outputs`` False) the state's alone.  The
    backward recomputes ``local_recurrence`` in f32, in the same form, from
    the saved q, k, v, g, i and entering state, and differentiates y and
    the final state together for the gradients that reached them
    (unnormalized, its gradients of g and i pass through the stabilizer's
    max, as JAX's do), as ``FlashAttention.backward`` does with the plain
    attention; each gradient comes back in its input's dtype.  A gradient
    on the final state differentiates the plain version's state, which is
    the kernel's up to rounding (the module note).
    """

    @staticmethod
    def forward(ctx, q, k, v, g, i, normalize=True, scale=None, outputs=True,
                *init):
        ctx.save_for_backward(q, k, v, g, i, *init)
        ctx.set_materialize_grads(False)
        ctx.form = {"normalize": normalize, "scale": scale}
        ctx.outputs = outputs
        state = ScanState(*init) if init else None
        if q.is_cuda:
            y, st = _launch(q, k, v, g, i, init_state=state, outputs=outputs,
                            **ctx.form)
        else:
            y, st = local_recurrence(q, k, v, g, i, init_state=state,
                                     **ctx.form)
        return (y, *st) if outputs else tuple(st)

    @staticmethod
    def backward(ctx, *grads):
        dy, dstate = (grads[0], grads[1:]) if ctx.outputs else (None, grads)
        saved = ctx.saved_tensors
        # the inputs: five tensors, three options (no gradient), the state
        needs = ctx.needs_input_grad[:5] + ctx.needs_input_grad[8:]
        cots = [(0, dy)] + [(1 + j, d) for j, d in enumerate(dstate)]
        cots = [(j, d) for j, d in cots if d is not None]
        if not cots or not any(needs):
            return (None,) * len(ctx.needs_input_grad)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, needs)]
            init = ScanState(*leaves[5:]) if len(leaves) > 5 else None
            y, st = local_recurrence(*(t.float() for t in leaves[:5]),
                                     init_state=init, **ctx.form)
            outs = (y, *st)
            want = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(
                [outs[j] for j, _ in cots], want, [d for _, d in cots],
                allow_unused=True))
        grads = [next(got) if t.requires_grad else None for t in leaves]
        return tuple(grads[:5]) + (None,) * 3 + tuple(grads[5:])


def mlstm_chunk(q, k, v, g, i, *, normalize: bool = True, scale=None,
                init_state=None, outputs: bool = True):
    """q/k: (B, S, H, dq); v: (B, S, H, dv); g/i: (B, S, H) f32 log gates
    -> (y (B, S, H, dv) f32, final ``ScanState``).  ``normalize`` and
    ``scale`` (None: 1/sqrt(dq)) as ``mlstm_plain.linear_recurrence``
    takes them; ``init_state``, a ``ScanState`` of f32 (B, H[, dq[, dv]])
    tensors, starts the recurrence from it; ``outputs=False`` gives
    (None, the final state) and spends nothing on the outputs.  On the
    card a call that needs a gradient goes through :class:`MLSTMChunk`."""
    _check(q, k, v, g, i)
    init = () if init_state is None else tuple(init_state)
    if q.is_cuda:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v, g, i, *init)):
            out = MLSTMChunk.apply(q, k, v, g, i, normalize, scale, outputs,
                                   *init)
            if not outputs:
                return None, ScanState(*out)
            return out[0], ScanState(*out[1:])
        return _launch(q, k, v, g, i, normalize, scale, init_state, outputs)
    if q.device.type == "cpu":
        y, st = local_recurrence(q, k, v, g, i, normalize=normalize,
                                 scale=scale, init_state=init_state)
        return (y if outputs else None), st
    raise ValueError(f"mlstm_chunk: no path for device {q.device}")
