"""Masked gradient aggregation without a mesh (the port's
``repro.core.aggregation``, its in-process part).

The paper's production variant (§4.3): the parameter server broadcasts the
participant list as a bit array; dropped workers' gradients are zeroed and
the update divides by c.  ``example_weights`` folds the bit array into the
loss (the ``mask_agg="weights"`` path); ``masked_mean_local`` is the plain
combine over per-worker gradients, the oracle of the Hopper
``masked_grad_agg`` kernel.  The mesh forms (``masked_psum_mean``,
``psum_mean``) come with the multi-GPU slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree


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
