"""Data-parallel collectives behind the layout (the port's
``repro.dist.collectives``).

  * ``example_weights``   — the production path: the bit array becomes
    per-example loss weights.
  * ``masked_grad_mean``  — the explicit path (``mask_agg="psum"``):
    sum_w bit_w g_w / max(sum bit, 1) over per-worker gradients,
    accumulated in f32 and cast back to each leaf's dtype.  Under LOCAL
    (or a layout with no dp axes) it is one pass of ``kernels.ops`` (the
    Hopper ``masked_grad_agg`` kernel on the card, its plain version on
    the CPU); under a layout with dp axes it is
    ``core.aggregation.masked_psum_mean`` over them: each rank's rows in
    the kernel's sum mode, one all-reduce, the division.
  * ``grad_mean``         — the full-sync baseline (all-ones mask), the
    same code in the same order.

A layout this slice does not run (``train_sp``, ``decode_tp``, a model
axis of more than one shard) raises, naming the ROADMAP item it waits
for; nothing falls back to the one-process path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import aggregation
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops


def example_weights(mask: np.ndarray, global_batch: int) -> np.ndarray:
    """Per-worker bit array -> per-example loss weights (production path)."""
    return aggregation.example_weights(mask, global_batch)


def masked_grad_mean(grads, mask_bit, lay=None):
    """Masked mean over per-worker gradients; the worker dim is dropped.

    ``grads`` is a tree whose leaves carry a leading worker dim, or an
    ``ops.WorkerGrads`` buffer the caller already filled row by row (the
    train step's way: no concatenation copy).  Either way the whole tree
    is ONE masked pass.  ``lay`` defaults to the active layout; under one
    with dp axes, ``grads`` holds this rank's block of workers and
    ``mask_bit`` the global vector.
    """
    lay = lay if lay is not None else shd.layout()
    shd.require_data_parallel(lay, "masked_grad_mean")
    if lay.mesh is None or not lay.dp:
        if isinstance(grads, ops.WorkerGrads):
            return grads.aggregate(mask_bit)
        return ops.masked_aggregate_tree(grads, mask_bit)
    return aggregation.masked_psum_mean(grads, mask_bit, lay.mesh, lay.dp)


def grad_mean(grads, lay=None):
    """Full-sync mean over the worker dim (the all-ones-mask case)."""
    lay = lay if lay is not None else shd.layout()
    rows = (grads.buf.shape[0] if isinstance(grads, ops.WorkerGrads)
            else tree.leaves(grads)[0].shape[0])
    ones = torch.ones(rows * lay.dp_size, dtype=torch.float32)
    return masked_grad_mean(grads, ones, lay)
