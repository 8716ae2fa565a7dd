"""Data-parallel and ZeRO-3 collectives behind the layout (the port's
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

  * ``Zero3``            — the collectives of ZeRO-3 over the model axis
    (a ``train_fsdp`` layout with a model axis): the use-site gather of
    a block's shards (one all-gather of a flat buffer, an autograd
    Function whose backward hands the full gradient on), the
    reduce-scatter of a shard-major buffer with the sums over the other
    dp axes (zero1: a reduce-scatter over "data", and the all-gather of
    the updated pieces after the optimizer), the global gradient norm
    and the gather of whole trees for checkpoints.  Under a ZeRO-3
    layout ``masked_grad_mean`` of a ``WorkerGrads`` built on the plan
    is ONE sum-mode pass of the kernel, the reduce-scatter, the sums and
    the division: this rank's gradient, shaped as its moments.

Every collective is a ``torch.distributed`` call in its list form
(``all_gather``, ``reduce_scatter``), which both torch versions in use
run without a deprecation warning, and each runs at any group size, one
included.  A layout this slice does not run (``train_sp``,
``decode_tp``) raises, naming the ROADMAP item it waits for; nothing
falls back to the one-process path.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.core import aggregation
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.perf.knobs import knobs


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
    if shd.is_zero3(lay):
        if not isinstance(grads, ops.WorkerGrads) or grads.plan is None:
            raise ValueError(
                "masked_grad_mean under a ZeRO-3 layout takes an "
                "ops.WorkerGrads built on the layout's shard plan (its "
                "columns shard-major)")
        return Zero3.of(lay, grads.plan).masked_mean(grads, mask_bit)
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


# ---------------------------------------------------------------------------
# ZeRO-3 over the model axis.
# ---------------------------------------------------------------------------


def _gather_cat(shards, dims, n, group):
    """Full tensors from this rank's slices: ONE all-gather of their flat
    concatenation over ``group`` (``n`` ranks), then each tensor the
    concatenation of its ``n`` slices on its dim."""
    send = torch.cat([x.reshape(-1) for x in shards])
    recv = list(torch.empty(n * send.numel(), dtype=send.dtype,
                            device=send.device).chunk(n))
    dist.all_gather(recv, send, group=group)
    out, off = [], 0
    for x, k in zip(shards, dims):
        m = x.numel()
        out.append(torch.cat([c[off:off + m].view(x.shape) for c in recv],
                             dim=k))
        off += m
    return out


class _Gather(torch.autograd.Function):
    """The use-site gather of one block: forward, this rank's slices ->
    the full weights; backward, each full weight's gradient to its
    receiver (a zero-stride full-shaped leaf that requires grad) as it
    is, so the full gradient reaches the worker's row of the step's
    buffer; the reduce-scatter follows the masked combine, once a step.
    Nothing is saved: under ``dist.sharding.remat`` the backward's
    recompute gathers again."""

    @staticmethod
    def forward(ctx, z, idx, *tensors):
        ctx.n = len(idx)
        return tuple(z.gather_full(idx, tensors[:len(idx)]))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + (None,) * ctx.n + tuple(grads)


class Zero3:
    """The ZeRO-3 collectives of one ``dist.sharding.ShardPlan`` on the
    mesh of a ``train_fsdp`` layout.

    Groups: the model axis (the gathers and the reduce-scatter), the dp
    axes (every rank: the replicated leaves, the metrics, the norm), and
    the other dp axes (the sums of a slice over its replicas); under
    zero1 "data" apart (its reduce-scatter and all-gather) from the rest.
    Every rank makes them in this order, at construction.
    """

    _cache: Dict = {}

    def __init__(self, lay, plan):
        shd.require_data_parallel(lay, "ZeRO-3")
        if not shd.is_zero3(lay):
            raise ValueError(f"ZeRO-3 runs under a train_fsdp layout with a "
                             f"model axis; got {lay}")
        mesh = lay.mesh
        self.lay, self.plan, self.mesh = lay, plan, mesh
        model = (lay.model_axis,)
        others = tuple(a for a in lay.dp if a != lay.model_axis)
        if plan.zero1 and "data" not in others:
            raise ValueError(
                f"zero1 splits the moments over a 'data' axis beside the "
                f"model axis; the mesh has axes {mesh.axis_names} and the "
                f"model axis is {lay.model_axis!r}")
        self.data = ("data",) if plan.zero1 else ()
        rest = tuple(a for a in others if a not in self.data)
        self.g_model = mesh.group(model)
        self.g_dp = mesh.group(tuple(lay.dp))
        self.g_others = mesh.group(others) if others else None
        self.g_data = mesh.group(self.data) if self.data else None
        self.g_rest = mesh.group(rest) if rest else None
        # which rank counts each leaf once in the global norm: a slice
        # lives on every replica along the other dp axes, a wide piece on
        # every replica along the rest, a replicated leaf everywhere
        first_other = mesh.index(others) == 0 if others else True
        first_rest = mesh.index(rest) == 0 if rest else True
        first_dp = mesh.index(tuple(lay.dp)) == 0
        self.own = np.array(
            [first_dp if leaf.dim is None else
             first_rest if leaf.wide else first_other
             for leaf in plan.leaves], np.float32)
        self._own_dev = None
        self._pieces: Dict = {}
        self._shards = self._recvs = self._where = None
        self.impl = "wsc"

    @classmethod
    def of(cls, lay, plan) -> "Zero3":
        """The (cached) ``Zero3`` of ``plan`` under ``lay``."""
        key = (lay, plan)
        if key not in cls._cache:
            cls._cache[key] = cls(lay, plan)
        return cls._cache[key]

    # -- the use-site gather ---------------------------------------------
    def gather_full(self, idx, shards):
        """Leaves ``idx``' full weights from this rank's ``shards``: one
        all-gather over the model axis of their flat concatenation (one a
        dtype); under ``fsdp_gather="shardmap"`` a leaf sharded on dim 0
        is gathered alone, straight into its full weight."""
        plan, T = self.plan, self.plan.n_shards
        out = [None] * len(idx)
        groups: Dict = {}
        for j, (i, x) in enumerate(zip(idx, shards)):
            leaf = plan.leaves[i]
            if self.impl == "shardmap" and leaf.dim == 0:
                full = torch.empty(leaf.shape, dtype=x.dtype,
                                   device=x.device)
                dist.all_gather(list(full.chunk(T)), x.contiguous(),
                                group=self.g_model)
                out[j] = full
            else:
                groups.setdefault(x.dtype, []).append(j)
        for js in groups.values():
            full = _gather_cat([shards[j] for j in js],
                               [plan.leaves[idx[j]].dim for j in js], T,
                               self.g_model)
            for j, f in zip(js, full):
                out[j] = f
        return out

    def _gather_tree(self, t):
        flat = tree.leaves(t)
        where = [self._where.get(id(x)) for x in flat]
        pick = [j for j, i in enumerate(where) if i is not None]
        if not pick:
            return t
        idx = tuple(where[j] for j in pick)
        full = _Gather.apply(self, idx, *[self._shards[i] for i in idx],
                             *[self._recvs[i] for i in idx])
        out = list(flat)
        for j, f in zip(pick, full):
            out[j] = f
        return tree.unflatten(t, out)

    @contextlib.contextmanager
    def session(self, flat):
        """Install the use-site gather for this rank's parameter leaves
        ``flat`` (``tree.leaves`` order) around a forward and its
        backward.  Yields (inputs, wrt): the leaves the loss function
        takes (the shards themselves, and a grad-requiring alias of each
        replicated leaf) and the tensors to differentiate by (each shard's
        full-shaped receiver, each alias): their gradients are the full
        ones."""
        plan = self.plan
        if len(flat) != len(plan.leaves):
            raise ValueError(f"ZeRO-3: {len(flat)} parameter leaves, the "
                             f"plan has {len(plan.leaves)}")
        inputs, wrt = [], []
        for i, (x, leaf) in enumerate(zip(flat, plan.leaves)):
            want = plan.slice_shape(i)
            if tuple(x.shape) != want:
                raise ValueError(f"ZeRO-3 leaf {leaf.path!r}: shape "
                                 f"{tuple(x.shape)}, its slice is {want}")
            if leaf.dim is None:
                a = x.detach().requires_grad_(True)
                inputs.append(a)
                wrt.append(a)
            else:
                inputs.append(x)
                wrt.append(torch.zeros((), dtype=x.dtype, device=x.device)
                           .expand(leaf.shape).requires_grad_(True))
        self._shards, self._recvs = flat, wrt
        self._where = {id(x): i for i, (x, leaf) in
                       enumerate(zip(flat, plan.leaves))
                       if leaf.dim is not None}
        self.impl = knobs().fsdp_gather
        try:
            with shd.gathering(self._gather_tree):
                yield inputs, wrt
        finally:
            self._shards = self._recvs = self._where = None

    # -- the reductions ----------------------------------------------------
    def reduce(self, total):
        """A rank's full shard-major sum ``total`` (N,), or (N + 1,) with
        its share of ``sum m`` last -> this rank's gradient, shaped as
        its moments (a list in ``tree.leaves`` order, f32 views):

          * one reduce-scatter of the T blocks over the model axis (each
            rank its slices, summed over the model axis);
          * the sum over the other dp axes: one all-reduce, or under
            zero1 a reduce-scatter of the D wide runs over "data" and an
            all-reduce of the narrow columns (then the rest of the axes);
          * one all-reduce of the replicated columns (and ``sum m``) over
            every dp rank;
          * with ``sum m``, every column divided by ``max(sum m, 1)``.
        """
        plan = self.plan
        T, blk, D, Wd = plan.n_shards, plan.block, plan.n_data, plan.wide
        red = torch.empty(blk, dtype=total.dtype, device=total.device)
        if blk:
            dist.reduce_scatter(red, list(total[:T * blk].chunk(T)),
                                group=self.g_model)
        tail = total[T * blk:]
        if tail.numel():
            dist.all_reduce(tail, op=dist.ReduceOp.SUM, group=self.g_dp)
        narrow = red[D * Wd:]
        if self.data:
            wide = torch.empty(Wd, dtype=red.dtype, device=red.device)
            if Wd:
                dist.reduce_scatter(wide, list(red[:D * Wd].chunk(D)),
                                    group=self.g_data)
            if narrow.numel():
                dist.all_reduce(narrow, op=dist.ReduceOp.SUM,
                                group=self.g_data)
            for part in (wide, narrow):
                if self.g_rest is not None and part.numel():
                    dist.all_reduce(part, op=dist.ReduceOp.SUM,
                                    group=self.g_rest)
        else:
            wide = red[:D * Wd]
            if self.g_others is not None and blk:
                dist.all_reduce(red, op=dist.ReduceOp.SUM,
                                group=self.g_others)
        rep = tail[:plan.replicated]
        if total.numel() == plan.size + 1:
            c = torch.clamp(tail[plan.replicated], min=1.0)
            for part in (wide, narrow, rep):
                part.div_(c)
        return [plan.local(i, wide, narrow, rep)
                for i in range(len(plan.leaves))]

    def masked_mean(self, buf, mask_bit):
        """``masked_grad_mean`` of a plan's ``ops.WorkerGrads`` (this
        rank's block of workers): ONE sum-mode pass of the kernel over the
        whole shard-major buffer, then :meth:`reduce`, as a tree of this
        rank's gradient, each leaf in its parameter's dtype."""
        R, r = self.mesh.size(self.lay.dp), self.mesh.index(self.lay.dp)
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
        return self.as_tree(buf.like, self.reduce(total))

    def as_tree(self, like, flat):
        """Reduced f32 leaves -> a tree like ``like``, each leaf in its
        dtype (f32 leaves stay views)."""
        return tree.unflatten(like, [x.to(p.dtype) for x, p in
                                     zip(flat, tree.leaves(like))])

    # -- the update, the norm, the max -------------------------------------
    def _piece_buffers(self, flat_p):
        """zero1: one flat buffer a dtype holding this rank's piece of
        every wide leaf, the update's parameters and the all-gather's send
        buffer in one, kept across steps (the fused Adam's leaf table and
        the collective see the same pointers every step).  Returns
        ({leaf: its piece, a view}, [(buffer, its leaves)])."""
        plan = self.plan
        by_dtype: Dict = {}
        for i, leaf in enumerate(plan.leaves):
            if leaf.wide:
                by_dtype.setdefault(flat_p[i].dtype, []).append(i)
        pieces, groups = {}, []
        for dt, idx in by_dtype.items():
            key = (dt, flat_p[idx[0]].device)
            shapes = [plan.slice_shape(i, moments=True) for i in idx]
            n = sum(math.prod(sh) for sh in shapes)
            buf = self._pieces.get(key)
            if buf is None or buf.numel() != n:
                buf = self._pieces[key] = torch.empty(n, dtype=dt,
                                                      device=key[1])
            off = 0
            for i, sh in zip(idx, shapes):
                pieces[i] = buf[off:off + math.prod(sh)].view(sh)
                off += math.prod(sh)
            groups.append((buf, idx))
        return pieces, groups

    def update(self, optimizer, grads, opt_state, params):
        """The optimizer's step on this rank's shards: under zero1 its
        wide leaves update their pieces (copied out of the slices), whose
        all-gather over "data" writes the slices back; the rest update in
        place (the fused Adam) or come back new.  Returns (params, opt)."""
        from repro_torch import optim

        flat = tree.leaves(params)
        pieces, groups = self._piece_buffers(flat)
        ps = list(flat)
        for i, view in pieces.items():
            view.copy_(self._piece_of(i, flat[i]))
            ps[i] = view
        ups, opt = optimizer.update(grads, opt_state,
                                    tree.unflatten(params, ps))
        new = tree.leaves(optim.apply_updates(tree.unflatten(params, ps),
                                              ups))
        for i, view in pieces.items():
            if new[i] is not view:
                view.copy_(new[i])
            new[i] = flat[i]
        D = self.plan.n_data
        for buf, idx in groups:
            recv = list(torch.empty(D * buf.numel(), dtype=buf.dtype,
                                    device=buf.device).chunk(D))
            dist.all_gather(recv, buf, group=self.g_data)
            off = 0
            for i in idx:
                n = pieces[i].numel()
                flat[i].copy_(torch.cat(
                    [c[off:off + n].view(pieces[i].shape) for c in recv],
                    dim=self.plan.leaves[i].dim))
                off += n
        return tree.unflatten(params, new), opt

    def _piece_of(self, i, slice_):
        """This rank's zero1 piece of leaf i, out of its slice."""
        leaf = self.plan.leaves[i]
        n = slice_.shape[leaf.dim] // self.plan.n_data
        return slice_.narrow(leaf.dim, self.plan.data * n, n)

    def global_norm(self, grads):
        """The full gradient's norm from this rank's parts: each leaf's
        sum of squares, counted on one rank of those holding the same
        part, all-reduced over the dp ranks in one (n_leaves,) vector
        (with one rank the vector ``optim.global_norm`` sums)."""
        flat = tree.leaves(grads)
        if self._own_dev is None or self._own_dev.device != flat[0].device:
            self._own_dev = torch.from_numpy(self.own).to(flat[0].device)
        sq = torch.stack([torch.sum(torch.square(x.float())) for x in flat])
        sq = sq * self._own_dev
        dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=self.g_dp)
        return torch.sqrt(sq.sum())

    def max_over_model(self, maxes):
        """Per-leaf maxima of this rank's slices -> the full leaves'
        (all-reduced over the model axis; the replicas along the other dp
        axes hold the same slices)."""
        dist.all_reduce(maxes, op=dist.ReduceOp.MAX, group=self.g_model)
        return maxes

    # -- whole trees (checkpoints) ----------------------------------------
    def gather_tree(self, like_shards, moments=False):
        """A tree of this rank's slices (or, ``moments``, its moments'
        pieces) -> the full tree, on every rank: zero1's pieces gathered
        over "data" into slices, then every slice over the model axis, one
        all-gather a dtype each."""
        plan = self.plan
        flat = list(tree.leaves(like_shards))
        for axis, group, n, pick in (
                ("data", self.g_data, plan.n_data,
                 lambda leaf: moments and leaf.wide),
                ("model", self.g_model, plan.n_shards,
                 lambda leaf: leaf.dim is not None)):
            idx = [i for i, leaf in enumerate(plan.leaves) if pick(leaf)]
            by_dt: Dict = {}
            for i in idx:
                by_dt.setdefault(flat[i].dtype, []).append(i)
            for js in by_dt.values():
                full = _gather_cat([flat[i].contiguous() for i in js],
                                   [plan.leaves[i].dim for i in js], n,
                                   group)
                for i, f in zip(js, full):
                    flat[i] = f
        return tree.unflatten(like_shards, flat)
