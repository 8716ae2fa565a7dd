"""Data-parallel collectives, no-mesh path (the port's
``repro.dist.collectives``).

  * ``example_weights``   — the production path: the bit array becomes
    per-example loss weights.
  * ``masked_grad_mean``  — the explicit path (``mask_agg="psum"``):
    sum_w bit_w g_w / max(sum bit, 1) over per-worker gradients, through
    ``kernels.ops`` (the Hopper ``masked_grad_agg`` kernel on the card, its
    plain version on the CPU), accumulated in f32 and cast back to each
    leaf's dtype.
  * ``grad_mean``         — the full-sync baseline (all-ones mask).

A mesh layout raises until the multi-GPU slice ports ``dist/``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import aggregation
from repro_torch.kernels import ops


def example_weights(mask: np.ndarray, global_batch: int) -> np.ndarray:
    """Per-worker bit array -> per-example loss weights (production path)."""
    return aggregation.example_weights(mask, global_batch)


def _no_layout(lay):
    if lay is not None:
        raise NotImplementedError(
            "mesh layouts are not ported yet (ROADMAP A.15): the port "
            "combines per-worker gradients in one process")


def masked_grad_mean(grads, mask_bit, lay=None):
    """Masked mean over per-worker gradients; the worker dim is dropped.

    ``grads`` is a tree whose leaves carry a leading worker dim, or an
    ``ops.WorkerGrads`` buffer the caller already filled row by row (the
    train step's way: no concatenation copy).  Either way the whole tree
    is ONE masked-mean pass.
    """
    _no_layout(lay)
    if isinstance(grads, ops.WorkerGrads):
        return grads.aggregate(mask_bit)
    return ops.masked_aggregate_tree(grads, mask_bit)


def grad_mean(grads, lay=None):
    """Full-sync mean over the worker dim (the all-ones-mask case)."""
    n = tree.leaves(grads)[0].shape[0]
    return masked_grad_mean(grads, torch.ones(n, dtype=torch.float32), lay)
