"""Wrapper of the Hopper fused AdamW kernel (``csrc/fused_adam.cu``).

The port's counterpart of ``repro.kernels.fused_adam``: one AdamW step,
``ref.reference_adam``, over a whole list of leaves.  It updates p, m and v
IN PLACE; that is the port's counterpart of JAX's donated train state.

On the card the whole list is ONE launch: a device table holds each leaf's
pointers and sizes, and the grid walks (leaf, chunk) pairs.  The table is
kept by a :class:`LeafTable` and rebuilt only when a pointer changes (p, m
and v never move, since the update is in place; g moves only if the caller
hands in new gradient tensors).

A CPU tensor goes to the plain version, leaf by leaf.  A CUDA tensor
launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import reference_adam

NAME = "fused_adam"
#: elements per block; must equal CHUNK in csrc/fused_adam.cu
CHUNK = 4096
_FLOAT_TYPES = (torch.float32, torch.bfloat16)
#: the ``Leaf`` record of the CUDA source, field for field
LEAF_DTYPE = np.dtype([("p", np.uint64), ("g", np.uint64), ("m", np.uint64),
                       ("v", np.uint64), ("n", np.int64),
                       ("chunk0", np.int64), ("flags", np.int64)])

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_float] * 9 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point, built and loaded at first use."""
    lib = build.load(NAME)
    if lib.fused_adam_chunk() != CHUNK:
        raise RuntimeError("fused_adam: CHUNK differs between the wrapper "
                           "and csrc/fused_adam.cu")
    fn = lib.fused_adam_step
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(ps, gs, ms, vs):
    if not len(ps) == len(gs) == len(ms) == len(vs):
        raise ValueError(f"fused_adam: {len(ps)} params, {len(gs)} grads, "
                         f"{len(ms)} m, {len(vs)} v")
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"fused_adam leaf {i}: shapes {tuple(p.shape)}, "
                             f"{tuple(g.shape)}, {tuple(m.shape)}, "
                             f"{tuple(v.shape)} differ")
        if p.dtype not in _FLOAT_TYPES or g.dtype not in _FLOAT_TYPES:
            raise ValueError(f"fused_adam leaf {i}: p and g must be float32 "
                             f"or bfloat16; got {p.dtype}, {g.dtype}")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise ValueError(f"fused_adam leaf {i}: m and v must be float32")


def leaf_records(ps, gs, ms, vs):
    """The kernel's host table: one ``LEAF_DTYPE`` record per non-empty
    leaf (pointers, size, first chunk, flags) and the grid's chunk count.

    flags: bit 0 p is bf16, bit 1 g is bf16, bit 2 all four base pointers
    allow 4-wide vector access (16 bytes for f32, 8 for bf16).
    """
    device = ps[0].device
    live = [i for i, p in enumerate(ps) if p.numel()]
    rec = np.zeros(len(live), LEAF_DTYPE)
    chunk0 = 0
    for r, i in enumerate(live):
        p, g, m, v = ps[i], gs[i], ms[i], vs[i]
        for t in (p, g, m, v):
            if t.device != device or not t.is_contiguous():
                raise ValueError(f"fused_adam leaf {i}: every tensor must "
                                 f"be contiguous on {device}")
        ptrs = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
        aligned = (ptrs[0] % (4 * p.element_size()) == 0
                   and ptrs[1] % (4 * g.element_size()) == 0
                   and ptrs[2] % 16 == 0 and ptrs[3] % 16 == 0)
        n = p.numel()
        rec[r] = (*ptrs, n, chunk0,
                  (p.dtype == torch.bfloat16)
                  | (g.dtype == torch.bfloat16) << 1 | aligned << 2)
        chunk0 += -(-n // CHUNK)
    return rec, chunk0


class LeafTable:
    """The kernel's device table of leaves, rebuilt when a pointer moves.

    The host record is compared with the last one each step (a few hundred
    integers); only a change uploads a new table, asynchronously.
    """

    def __init__(self):
        self._host = None
        self._dev = None
        self.n_chunks = 0
        self.uploads = 0

    def get(self, ps, gs, ms, vs):
        device = ps[0].device
        rec, n_chunks = leaf_records(ps, gs, ms, vs)
        if (self._host is None or self._host.shape != rec.shape
                or not np.array_equal(self._host, rec)
                or self._dev.device != device):
            # pinned and asynchronous: a changed table costs no host sync
            raw = torch.from_numpy(rec.view(np.uint8).copy()).pin_memory()
            self._dev = raw.to(device, non_blocking=True)
            self._host = rec
            self.n_chunks = n_chunks
            self.uploads += 1
        return self._dev, len(rec), self.n_chunks


def _launch(ps, gs, ms, vs, scalars, b1, b2, eps, wd, table):
    table = table if table is not None else LeafTable()
    dev_table, n_live, n_chunks = table.get(ps, gs, ms, vs)
    if n_live == 0:
        return
    lr, bc1, bc2 = (float(s) for s in scalars)
    device = ps[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel_fn()(dev_table.data_ptr(), n_live, n_chunks, lr, bc1,
                           bc2, b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, stream)
    if err < 0:
        raise ValueError(f"fused_adam: the kernel refused its arguments "
                         f"(code {err})")
    if err > 0:
        raise RuntimeError(f"fused_adam launch failed: CUDA error {err}")
    build.LAUNCHES[NAME] += 1


def fused_adam_(ps, gs, ms, vs, scalars, *, b1=0.9, b2=0.999, eps=1e-8,
                wd=0.0, table: LeafTable = None):
    """One AdamW step over lists of leaves, p/m/v updated IN PLACE.

    scalars: ``(lr, 1 - b1**t, 1 - b2**t)`` host floats.  ``table`` keeps
    the device table between calls (one per optimizer); without it each
    call uploads a fresh one.
    """
    _check(ps, gs, ms, vs)
    if not ps:
        return
    if ps[0].is_cuda:
        _launch(ps, gs, ms, vs, scalars, b1, b2, eps, wd, table)
        return
    if ps[0].device.type != "cpu":
        raise ValueError(f"fused_adam: no path for device {ps[0].device}")
    for p, g, m, v in zip(ps, gs, ms, vs):
        p_new, m_new, v_new = reference_adam(p, g, m, v, scalars, b1=b1,
                                             b2=b2, eps=eps, wd=wd)
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
