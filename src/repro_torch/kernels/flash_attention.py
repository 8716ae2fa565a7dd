"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

The port's counterpart of ``repro.kernels.flash_attention``.  It computes
``ref.reference_attention``: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), query
row i at position i + Sk - Sq, causal and sliding-window masks, f32
softmax statistics, output in ``q.dtype``.

A CPU tensor goes to the plain version.  A CUDA tensor launches the kernel
or raises; nothing falls back.  Any other device raises.

The kernel has three paths (``csrc/flash_attention.cu``); ``choose_path``
picks one by dtype, packed rows (Sq * H/KV) and alignment, and
``split_plan`` cuts the keys of the split-KV path into ranges.  Both are
pure functions of the shapes, tested without a card.  A decode call may
give its key count on the device (``length``): the plan is then cut for
the padded cache (``plan_keys``) and the kernel finds the visible range
from the count, so a CUDA graph of the call serves every position.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import reference_attention

NAME = "flash_attention"
#: head dims the CUDA build instantiates
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)

#: the kernel's paths, with their codes in the C interface
PATHS = {"simt": 0, "wgmma": 1, "split_kv": 2}
#: most packed rows (Sq * H/KV) the split-KV path takes: one warpgroup's
#: tile, and more rows than that fill the card without a split
SPLIT_MAX_ROWS = 64
#: keys a split gets: at least MIN, and at most MAX unless the card is
#: covered with fewer splits
SPLIT_MIN_KEYS = 32
SPLIT_MAX_KEYS = 256
#: most splits: the merge kernel's threads read one split's (m, l) each
SPLIT_MAX = 64
H100_SMS = 132


def choose_path(dtype, Sq: int, G: int, aligned: bool) -> str:
    """The kernel path for a call: in bf16, ``"split_kv"`` for at most 64
    packed rows (decode) and ``"wgmma"`` for more (prefill, the train
    forward); ``"simt"`` for f32 at any shape (only the f32 parity runs
    call it, at a tolerance tensor cores cannot hold) and for inputs whose
    pointers or strides are not 16-byte aligned (the other paths copy 16
    bytes at a time)."""
    if not aligned or dtype != torch.bfloat16:
        return "simt"
    return "split_kv" if Sq * G <= SPLIT_MAX_ROWS else "wgmma"


def key_range(Sq: int, Sk: int, causal: bool, window: int):
    """[k_begin, k_end): the keys that any of the Sq query rows sees (row i
    at position i + Sk - Sq)."""
    q_first, q_last = Sk - Sq, Sk - 1
    k_end = min(Sk, q_last + 1) if causal else Sk
    k_begin = max(0, q_first - window + 1) if window > 0 else 0
    return k_begin, k_end


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Keys [k_begin, k_end) cut into ``splits`` ranges of ``chunk`` keys
    (the last may be shorter); range s is [k_begin + s*chunk,
    min(k_end, k_begin + (s+1)*chunk))."""
    k_begin: int
    k_end: int
    chunk: int
    splits: int


def split_plan(Sq: int, Sk: int, causal: bool, window: int, n_bkv: int,
               n_sm: int = H100_SMS) -> SplitPlan:
    """Split the visible keys so that the (splits, KV, B) grid covers the
    SMs: about n_sm / (B*KV) splits, at least keys / SPLIT_MAX_KEYS, none
    shorter than SPLIT_MIN_KEYS keys (unless there is only one), at most
    SPLIT_MAX."""
    k_begin, k_end = key_range(Sq, Sk, causal, window)
    n = k_end - k_begin
    want = max(n_sm // max(n_bkv, 1), -(-n // SPLIT_MAX_KEYS))
    want = max(1, min(want, n // SPLIT_MIN_KEYS, SPLIT_MAX))
    chunk = -(-n // want)
    return SplitPlan(k_begin, k_end, chunk, -(-n // chunk))


def plan_keys(Sq: int, L: int, window: int) -> int:
    """The most keys a call with its key count on the device can see in a
    padded cache of L slots: all L, or the window's (plus the Sq - 1 rows
    before the last) for a windowed layer.  The split plan is cut for this
    many, from the visible range's start, which the kernel finds from the
    count."""
    return min(L, window + Sq - 1) if window > 0 else L


def aligned16(*ts) -> bool:
    """Every pointer and every stride but the last on 16 bytes."""
    return all(t.data_ptr() % 16 == 0
               and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])
               for t in ts)


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point, built and loaded at first use."""
    fn = build.load(NAME).flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants q (B,Sq,H,hd) and k/v "
                         f"(B,Sk,KV,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")


def _check_length(length, q):
    if not (isinstance(length, torch.Tensor) and length.dim() == 0
            and length.dtype == torch.int32 and length.device == q.device):
        raise ValueError("flash_attention: length must be a 0-d int32 "
                         f"tensor on {q.device}; got {length!r}")


def _launch(q, k, v, causal, window, length=None):
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("flash_attention: q, k, v must lie on one CUDA "
                         "device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 for "
                         f"q, k and v alike; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} is not built "
                         f"(built: {HEAD_DIMS})")
    if not 1 <= Sq <= Sk:
        # query row i sits at key position i + Sk - Sq; a non-causal call
        # (cross-attention) reads no position, but the kernel's tiling
        # still assumes the rows end at the last key
        raise ValueError(
            f"flash_attention needs 1 <= Sq <= Sk; got Sq={Sq}, Sk={Sk}"
            + ("" if causal or Sq <= Sk else
               ": the kernel takes no non-causal call with more queries "
               "than keys (a decoder longer than its encoder's frames)"))
    if B > 65535 or KV > 65535:
        raise ValueError("flash_attention: batch and KV heads must each "
                         "be at most 65535 (grid limits)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"in head_dim; strides {t.stride()}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    G = H // KV
    path = choose_path(q.dtype, Sq, G, aligned16(q, k, v))
    if length is not None and path == "wgmma":
        raise ValueError(f"flash_attention: a device key count takes at "
                         f"most {SPLIT_MAX_ROWS} packed rows (decode); got "
                         f"Sq {Sq} x G {G}")
    plan, part = SplitPlan(0, Sk, Sk, 1), None
    if path == "split_kv":
        n_sm = _n_sm(q.device.index or 0)
        plan = (split_plan(Sq, Sk, causal, window, B * KV, n_sm)
                if length is None else   # the grid for any count <= Sk
                split_plan(Sq, plan_keys(Sq, Sk, window), False, 0, B * KV,
                           n_sm))
        if plan.splits > 1:   # (acc[hd], m, l) per split and row
            part = torch.empty(B * KV * plan.splits * Sq * G * (hd + 2),
                               dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[q.dtype], B, Sq, Sk, H, KV, hd,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], int(causal), int(window),
                 1.0 / math.sqrt(hd), PATHS[path], plan.k_begin,
                 plan.k_end, plan.chunk, plan.splits,
                 None if part is None else part.data_ptr(),
                 None if length is None else length.data_ptr(), stream)
    if err < 0:
        raise ValueError(f"flash_attention: the kernel refused its "
                         f"arguments (code {err})")
    if err > 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    build.LAUNCHES[NAME] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    length=None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) -> (B, Sq, H, hd).

    ``length``, a 0-d int32 tensor on q's device, makes the keys the first
    ``length`` of the Sk slots (a padded decode cache), read by the kernel
    from the device: nothing waits for it, and one CUDA graph of the call
    serves every length.  At most ``SPLIT_MAX_ROWS`` packed rows."""
    _check_shapes(q, k, v)
    if length is not None:
        _check_length(length, q)
    if q.is_cuda:
        return _launch(q, k, v, causal, window, length)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal, window=window,
                                   length=length)
    raise ValueError(f"flash_attention: no path for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient, for training.

    The forward is :func:`flash_attention` (the Hopper kernel on the card).
    The backward recomputes the plain ``reference_attention`` from the saved
    q, k, v and differentiates it: the JAX package has no backward kernel
    either (its training attention is plain jnp), so a Hopper backward is
    later work.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = reference_attention(*qkv, causal=ctx.causal,
                                      window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, qkv, grad_out)
        return dq, dk, dv, None, None
