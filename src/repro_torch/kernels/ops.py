"""Public kernel ops of the port, routed by the device of their tensors.

The counterpart of ``repro.kernels.ops``, without a backend switch: a CPU
tensor takes the plain version, a CUDA tensor the Hopper kernel.  Both
follow the JAX kernel path's rules (f32 accumulation in the masked mean
and the mLSTM, f32 moments in Adam), so the CPU and the card compute the
same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_adam import LeafTable, fused_adam_
from repro_torch.kernels.masked_grad_agg import masked_grad_agg
from repro_torch.kernels.mlstm_chunk import mlstm_chunk


def attention(q, k, v, *, causal=True, window=0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); aligned-suffix positions."""
    return flash_attention(q, k, v, causal=causal, window=window)


def mlstm(q, k, v, g, i):
    """Normalized mLSTM over q/k/v (B, S, H, hd) and f32 log gates g/i
    (B, S, H) -> (y (B, S, H, hd) f32, final ``ScanState``).  JAX's
    ``ops.mlstm`` returns y alone; the port's prefill also needs the state
    for its decode cache.  With grad mode on and an input that requires a
    gradient (training), a CUDA tensor goes through the autograd Function
    ``MLSTMChunk`` (the kernel forward, the plain recurrence's backward)
    and a CPU tensor through ``linear_recurrence``, which autograd
    differentiates directly."""
    return mlstm_chunk(q, k, v, g, i)


# ---------------------------------------------------------------------------
# Masked mean over workers (the cutoff combine).
# ---------------------------------------------------------------------------


def masked_aggregate(grads_stacked, mask):
    """grads_stacked: (W, N); mask: (W,) -> (N,) cutoff-weighted mean, in
    the grads' dtype.  Any N: nothing is padded."""
    mask = torch.as_tensor(mask, dtype=torch.float32).to(
        grads_stacked.device, non_blocking=True)
    return masked_grad_agg(grads_stacked, mask)


class WorkerGrads:
    """One preallocated (W, N) f32 buffer of per-worker gradients.

    Built once for a parameter tree: ``rows[w]`` holds one view per leaf
    (in ``tree.leaves`` order, shaped like the leaf) into row ``w``, so a
    worker's gradient is written straight into its row with no
    concatenation copy.  :meth:`aggregate` runs the masked mean once over
    the whole buffer and splits it back into a tree, each leaf cast to its
    parameter's dtype (f32 leaves are views of the result).
    """

    def __init__(self, like, n_workers: int, device=None):
        flat = tree.leaves(like)
        self.like = like
        self.shapes = [tuple(x.shape) for x in flat]
        self.dtypes = [x.dtype for x in flat]
        sizes = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        device = flat[0].device if device is None else device
        self.buf = torch.empty((n_workers, self.offsets[-1]),
                               dtype=torch.float32, device=device)
        self.rows = [self._split(self.buf[w]) for w in range(n_workers)]

    def _split(self, flat_row):
        return [flat_row[a:b].view(s) for a, b, s in
                zip(self.offsets[:-1], self.offsets[1:], self.shapes)]

    def aggregate(self, mask):
        out = masked_aggregate(self.buf, mask)
        parts = [x.to(dt) for x, dt in zip(self._split(out), self.dtypes)]
        return tree.unflatten(self.like, parts)


def masked_aggregate_tree(grads, mask):
    """Masked mean over the leading worker dim of a gradient tree.

    Every leaf (W, ...) is written as f32 into one (W, N) buffer, the
    whole tree goes through ONE masked mean, and each result leaf is cast
    back to its leaf's dtype: the JAX kernel path's rule
    (``repro.kernels.ops.masked_aggregate_tree``).
    """
    flat = tree.leaves(grads)
    W = flat[0].shape[0]
    buf = WorkerGrads(tree.map(lambda x: x[0], grads), W)
    for i, x in enumerate(flat):
        a, b = buf.offsets[i], buf.offsets[i + 1]
        buf.buf[:, a:b].copy_(x.reshape(W, -1))
    return buf.aggregate(mask)


# ---------------------------------------------------------------------------
# Fused AdamW over a tree.
# ---------------------------------------------------------------------------


def adam_scalars(step: int, lr, b1: float, b2: float):
    """``(lr, 1 - b1**t, 1 - b2**t)`` with ``t = step + 1``, in float32 on
    the host, as the JAX op computes them on the device."""
    t = np.float32(step + 1)
    one = np.float32(1.0)
    return (np.float32(lr), one - np.float32(b1) ** t,
            one - np.float32(b2) ** t)


def adam_update_tree(params, grads, m, v, step: int, lr, *, b1=0.9,
                     b2=0.999, eps=1e-8, wd=0.0, table: LeafTable = None):
    """One AdamW step over a tree; p, m and v are updated IN PLACE and
    returned.  ``step`` is the host int of steps already taken; on the card
    the whole tree is one kernel launch (``table`` keeps its leaf table)."""
    scalars = adam_scalars(step, lr, b1, b2)
    fused_adam_(tree.leaves(params), tree.leaves(grads), tree.leaves(m),
                tree.leaves(v), scalars, b1=b1, b2=b2, eps=eps, wd=wd,
                table=table)
    return params, m, v
