"""Masked gradient aggregation (the port's ``repro.core.aggregation``).

The paper's production variant (§4.3): the parameter server broadcasts the
participant list as a bit array; dropped workers' gradients are zeroed and
the update divides by c.  ``example_weights`` folds the bit array into the
loss (the ``mask_agg="weights"`` path); ``masked_mean_local`` is the plain
combine over per-worker gradients in one process, the oracle of the Hopper
``masked_grad_agg`` kernel.

``masked_psum_mean`` is the combine across data-parallel ranks, the
reference's ``shard_map`` psum: rank r holds a contiguous block of W/R
worker rows, takes their masked SUM in one pass (the kernel's sum mode on
the card), all-reduces it over the dp group together with its share of
``sum m``, and divides by ``max(sum m, 1)``.  ``psum_mean`` is the same
code with an all-ones mask, so the two agree bit for bit.  The
layout-aware entry points are in ``repro_torch.dist.collectives``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.kernels import ops


def example_weights(mask: np.ndarray, global_batch: int) -> np.ndarray:
    """Expand a per-worker bit array to per-example weights.

    mask: (n_workers,) 0/1 — worker j owns the j-th contiguous slice of the
    global batch.
    """
    mask = np.asarray(mask, np.float32)
    n = mask.shape[0]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} is not divisible by "
                         f"{n} workers")
    return np.repeat(mask, global_batch // n)


def masked_mean_local(grads, mask_bit):
    """In-process reference combine: sum_w bit_w g_w / max(sum bit, 1).

    Over the leading worker dim of each leaf, each leaf in its own dtype
    (the JAX ``masked_mean_local``); the kernel path of
    ``dist.collectives.masked_grad_mean`` accumulates in f32 instead.
    """
    flat = tree.leaves(grads)
    bit = torch.as_tensor(mask_bit).to(flat[0].device)
    c = torch.clamp(torch.sum(bit.float()), min=1.0)

    def one(x):
        b = bit.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
        return torch.sum(x * b, dim=0) / c.to(x.dtype)

    return tree.map(one, grads)


def _worker_reduce(grads, mask_bit, mesh, dp_axes):
    """Sum of this rank's workers' masked gradients, all-reduced over the
    ``dp_axes`` group of ``mesh``, over the all-reduced ``sum m``.

    ``grads``: a tree whose leaves carry this rank's block of the worker
    dim (W/R, ...), or an ``ops.WorkerGrads`` buffer of those rows.
    ``mask_bit``: the GLOBAL (W,) contribution vector; this rank's block
    is rows ``[r W/R, (r + 1) W/R)``, r its index along ``dp_axes``.  The
    rows' masked sum and their ``sum m`` share ONE (N + 1,) f32 buffer, so
    a step makes one all-reduce.  Leaves come back in their own dtypes.
    """
    axes = tuple(dp_axes)
    R, r = mesh.size(axes), mesh.index(axes)
    buf = (grads if isinstance(grads, ops.WorkerGrads)
           else ops.WorkerGrads.of_stacked(grads))
    rows, N = buf.buf.shape
    mask = torch.as_tensor(mask_bit, dtype=torch.float32)
    if mask.dim() != 1 or mask.shape[0] != rows * R:
        raise ValueError(f"{R} dp ranks of {rows} workers each take a "
                         f"({rows * R},) mask; got {tuple(mask.shape)}")
    local = mask[r * rows:(r + 1) * rows].to(buf.buf.device,
                                               non_blocking=True)
    total = torch.empty(N + 1, dtype=torch.float32, device=buf.buf.device)
    ops.masked_aggregate(buf.buf, local, mean=False, out=total[:N])
    total[N:].copy_(torch.sum(local).reshape(1))
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group(axes))
    out = total[:N]
    out.div_(torch.clamp(total[N], min=1.0))
    return buf.unflatten(out)


def masked_psum_mean(grads, mask_bit, mesh, dp_axes):
    """Bit-array aggregation across ranks: ``g = psum(sum_w bit_w g_w) /
    max(psum(sum bit), 1)``.  A masked-out worker's gradient is multiplied
    by 0.0 before the sum, so it has no influence.  See
    :func:`_worker_reduce` for the contract."""
    return _worker_reduce(grads, mask_bit, mesh, dp_axes)


def psum_mean(grads, mesh, dp_axes):
    """Full-sync mean over the worker dim across ranks: the same code as
    :func:`masked_psum_mean` with an all-ones mask (so the two agree bit
    for bit)."""
    rows = (grads.buf.shape[0] if isinstance(grads, ops.WorkerGrads)
            else tree.leaves(grads)[0].shape[0])
    ones = torch.ones(rows * mesh.size(tuple(dp_axes)), dtype=torch.float32)
    return _worker_reduce(grads, ones, mesh, dp_axes)
