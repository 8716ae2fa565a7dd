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
from repro_torch.dist import sharding as shd
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_adam import LeafTable, fused_adam_
from repro_torch.kernels.masked_grad_agg import masked_grad_agg
from repro_torch.kernels.mlstm_chunk import mlstm_chunk
from repro_torch.kernels.mlstm_plain import shard_states


def attention(q, k, v, *, causal=True, window=0, length=None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); aligned-suffix positions.
    ``length``: a 0-d int32 tensor on q's device, the keys' count in a
    padded cache, read on the device (decode)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           length=length)


def mlstm(q, k, v, g, i, *, normalize=True, scale=None):
    """The mLSTM recurrence over q/k (B, S, H, dq), v (B, S, H, dv) and f32
    log gates g/i (B, S, H) -> (y (B, S, H, dv) f32, final ``ScanState``):
    normalized with scale 1/sqrt(dq) by default (the xLSTM), or as the
    caller asks (Hymba's Mamba heads: ``normalize=False, scale=1.0``).
    JAX's ``ops.mlstm`` returns y alone; the port's prefill also needs the
    state for its decode cache.  With grad mode on and an input that
    requires a gradient (training), a CUDA tensor goes through the autograd
    Function ``MLSTMChunk`` (the kernel forward, the plain recurrence's
    backward) and a CPU tensor through ``local_recurrence``, which
    autograd differentiates directly.

    Under ``train_sp`` on T > 1 ranks the tensors are this rank's columns
    and the JAX module's exclusive prefix across ranks runs through the
    kernel (``src/repro/models/ssm.py:163-181``): rank 0 launches from the
    zero state; rank s > 0 first launches for its own final state alone,
    the ranks' states are gathered (``mlstm_plain.shard_states``), and it
    launches again from the combine of ranks 0..s-1's.  The final state
    returned is the whole sequence's, on every rank.  With one rank on the
    axis the call is the one-process one."""
    form = {"normalize": normalize, "scale": scale}
    lay = shd.layout()
    if not (shd.seq_parallel(lay) and lay.n_shards > 1):
        return mlstm_chunk(q, k, v, g, i, **form)
    if lay.mesh.index((lay.model_axis,)) > 0:
        _, own = mlstm_chunk(q, k, v, g, i, outputs=False, **form)
        prefix, final, _ = shard_states(own)
        y, _ = mlstm_chunk(q, k, v, g, i, init_state=prefix, **form)
        return y, final
    from repro_torch.dist import collectives   # collectives imports this
    y, own = mlstm_chunk(q, k, v, g, i, **form)
    _, final, gathered = shard_states(own)
    return collectives.depend(y, *gathered), final


# ---------------------------------------------------------------------------
# Masked mean over workers (the cutoff combine).
# ---------------------------------------------------------------------------


def masked_aggregate(grads_stacked, mask, *, mean: bool = True, out=None):
    """grads_stacked: (W, N); mask: (W,) -> (N,) cutoff-weighted mean, in
    the grads' dtype (``mean=False``: the masked sum, a data-parallel
    rank's share), written into ``out`` when given.  Any N: nothing is
    padded."""
    mask = torch.as_tensor(mask, dtype=torch.float32).to(
        grads_stacked.device, non_blocking=True)
    return masked_grad_agg(grads_stacked, mask, mean=mean, out=out)


class WorkerGrads:
    """One preallocated (W, N) f32 buffer of per-worker gradients.

    Built once for a parameter tree: ``rows[w]`` holds one view per leaf
    (in ``tree.leaves`` order, shaped like the leaf) into row ``w``, so a
    worker's gradient is written straight into its row with no
    concatenation copy.  :meth:`aggregate` runs the masked mean once over
    the whole buffer and splits it back into a tree, each leaf cast to its
    parameter's dtype (f32 leaves are views of the result).

    With a ``plan`` (a ``dist.sharding.ShardPlan``, ZeRO-3) the columns
    are the plan's shard-major order and ``like`` holds this rank's
    slices: ``rows[w][i]`` is leaf i's columns (``plan.columns``: for a
    sharded leaf a strided view of its T slices, on a dim after 0 too),
    and ``fit(i, g)`` views the FULL gradient of leaf i in that shape, so
    ``rows[w][i].copy_(fit(i, g))`` writes each slice into its shard's
    block.  The kernel adds each column over W in the same order wherever
    the column lies, so the sum over the buffer is the natural-order
    sum's, permuted, bit for bit; ``dist.collectives`` reduce-scatters it.
    """

    def __init__(self, like, n_workers: int, device=None, plan=None):
        flat = tree.leaves(like)
        self.like = like
        self.plan = plan
        self.dtypes = [x.dtype for x in flat]
        device = flat[0].device if device is None else device
        if plan is None:
            self.shapes = [tuple(x.shape) for x in flat]
            sizes = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
            self.offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
            n = self.offsets[-1]
        else:
            if len(plan.leaves) != len(flat):
                raise ValueError(f"WorkerGrads: {len(flat)} leaves, the "
                                 f"plan has {len(plan.leaves)}")
            self.shapes = [leaf.shape for leaf in plan.leaves]
            n = plan.size
        self.buf = torch.empty((n_workers, n), dtype=torch.float32,
                               device=device)
        self.rows = [self._split(self.buf[w]) for w in range(n_workers)]

    def _split(self, flat_row):
        if self.plan is not None:
            return [self.plan.columns(i, flat_row)
                    for i in range(len(self.shapes))]
        return [flat_row[a:b].view(s) for a, b, s in
                zip(self.offsets[:-1], self.offsets[1:], self.shapes)]

    def fit(self, i, g):
        """Leaf i's full gradient ``g`` viewed in ``rows[w][i]``'s
        shape."""
        return g if self.plan is None else self.plan.split(i, g)

    @classmethod
    def of_stacked(cls, grads):
        """A buffer holding a tree whose leaves carry a leading worker dim
        (W, ...), each written as f32 into its columns."""
        flat = tree.leaves(grads)
        W = flat[0].shape[0]
        buf = cls(tree.map(lambda x: x[0], grads), W)
        for i, x in enumerate(flat):
            a, b = buf.offsets[i], buf.offsets[i + 1]
            buf.buf[:, a:b].copy_(x.reshape(W, -1))
        return buf

    def unflatten(self, flat):
        """An (N,) f32 result -> a tree like the parameters, each leaf cast
        to its parameter's dtype (f32 leaves are views of ``flat``)."""
        if self.plan is not None:
            raise ValueError("a plan's buffer is shard-major: its sums go "
                             "through dist.collectives.Zero3.reduce")
        parts = [x.to(dt) for x, dt in zip(self._split(flat), self.dtypes)]
        return tree.unflatten(self.like, parts)

    def aggregate(self, mask):
        return self.unflatten(masked_aggregate(self.buf, mask))


def masked_aggregate_tree(grads, mask):
    """Masked mean over the leading worker dim of a gradient tree.

    Every leaf (W, ...) is written as f32 into one (W, N) buffer, the
    whole tree goes through ONE masked mean, and each result leaf is cast
    back to its leaf's dtype: the JAX kernel path's rule
    (``repro.kernels.ops.masked_aggregate_tree``).
    """
    return WorkerGrads.of_stacked(grads).aggregate(mask)


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
