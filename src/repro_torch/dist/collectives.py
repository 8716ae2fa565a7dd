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

  * Sequence parallelism over the model axis (``train_sp``), each an
    autograd Function whose backward is its forward's transpose:
    ``seq_gather`` (an all-gather of the ranks' columns; backward, a
    reduce-scatter), ``halo`` (the neighbouring chunks a sliding window
    reads, by point-to-point sends; backward, the reverse sends),
    ``stack_gather`` (each rank's copy of small tensors, stacked: the
    recurrence's states, whose exclusive prefix each rank combines; with
    ``depend``, which keeps it in the graph of a rank that reads none of
    it), ``ring_shift`` (a block one step round the model ring),
    ``all_to_all`` (equal blocks of dim 0 to each rank; backward, the same
    exchange of the gradients), ``vocab_block`` (an untied head's dim-0 shard
    re-blocked to its vocab columns) and the sums and means over the
    model axis of values every rank then holds (``model_sum``,
    ``model_mean``; backward, the identity or its 1/T: each rank's loss is
    the whole one, so its cotangent needs no sum).  Together they keep
    the gradient a rank computes its own path's part of the whole one;
    the step's reduce-scatter over the model axis sums them.

Every collective is a ``torch.distributed`` call in its list form
(``all_gather``, ``reduce_scatter``), ``all_to_all_single`` or
``batch_isend_irecv``, which both torch versions in use run without a
deprecation warning, and each runs at any group size, one included.  A
layout this slice does not run (``decode_tp``) raises, naming the
ROADMAP item it waits for; nothing falls back to the one-process path.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, NamedTuple

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


class _Local(torch.autograd.Function):
    """A shard used where it lies (``dist.sharding.use_shard``): forward,
    the shard itself; backward, its gradient, which is the whole gradient
    of this rank's slice, written into that slice of a zero gradient of
    the full leaf for its receiver, so the reduce-scatter over the model
    axis hands it back to this rank with nothing added to it."""

    @staticmethod
    def forward(ctx, shard, receiver, dim, start):
        ctx.dim, ctx.start = dim, start
        ctx.shape = tuple(receiver.shape)
        return shard.view_as(shard)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(ctx.dim, ctx.start, g.shape[ctx.dim]).copy_(g)
        return None, full, None, None


class Zero3:
    """The ZeRO-3 collectives of one ``dist.sharding.ShardPlan`` on the
    mesh of a ``train_fsdp`` or ``train_sp`` layout.

    Groups: the model axis (the gathers and the reduce-scatter), every
    rank of the dp and model axes (the replicated leaves, the norm), and
    the other dp axes (the sums of a slice over its replicas); under
    zero1 "data" apart (its reduce-scatter and all-gather) from the rest.
    Every rank makes them in this order, at construction.  Under
    ``train_sp`` the ranks of one model axis share their workers and each
    holds its columns' part of their gradients, which the reduce-scatter
    and the sum over every rank add up; only the first of them counts
    the workers' ``sum m``.
    """

    _cache: Dict = {}

    def __init__(self, lay, plan):
        shd.require_data_parallel(lay, "ZeRO-3")
        if not shd.is_zero3(lay):
            raise ValueError(f"ZeRO-3 runs under a train_fsdp or train_sp "
                             f"layout with a model axis; got {lay}")
        mesh = lay.mesh
        self.lay, self.plan, self.mesh = lay, plan, mesh
        model = (lay.model_axis,)
        others = tuple(a for a in lay.dp if a != lay.model_axis)
        ranks = set(lay.dp) | set(model)
        everyone = tuple(a for a in mesh.axis_names if a in ranks)
        if plan.zero1 and "data" not in others:
            raise ValueError(
                f"zero1 splits the moments over a 'data' axis beside the "
                f"model axis; the mesh has axes {mesh.axis_names} and the "
                f"model axis is {lay.model_axis!r}")
        self.data = ("data",) if plan.zero1 else ()
        rest = tuple(a for a in others if a not in self.data)
        self.g_model = mesh.group(model)
        self.g_all = mesh.group(everyone)
        self.g_others = mesh.group(others) if others else None
        self.g_data = mesh.group(self.data) if self.data else None
        self.g_rest = mesh.group(rest) if rest else None
        # which rank counts each leaf once in the global norm: a slice
        # lives on every replica along the other dp axes, a wide piece on
        # every replica along the rest, a replicated leaf everywhere
        first_other = mesh.index(others) == 0 if others else True
        first_rest = mesh.index(rest) == 0 if rest else True
        first_all = mesh.index(everyone) == 0
        self.counts_mask = (not shd.seq_parallel(lay)
                            or mesh.index(model) == 0)
        self.own = np.array(
            [first_all if leaf.dim is None else
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

    def _gather_tree(self, t, local=False):
        flat = tree.leaves(t)
        where = [self._where.get(id(x)) for x in flat]
        pick = [j for j, i in enumerate(where) if i is not None]
        if not pick:
            return t
        idx = tuple(where[j] for j in pick)
        if local:
            plan = self.plan
            full = [_Local.apply(
                self._shards[i], self._recvs[i], plan.leaves[i].dim,
                plan.shard * plan.slice_shape(i)[plan.leaves[i].dim])
                for i in idx]
        else:
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
            every rank;
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
            dist.all_reduce(tail, op=dist.ReduceOp.SUM, group=self.g_all)
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
        if self.counts_mask:
            total[N:].copy_(torch.sum(local).reshape(1))
        else:   # train_sp: the first rank of the model axis counts them
            total[N:].zero_()
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
        part, all-reduced over every rank in one (n_leaves,) vector
        (with one rank the vector ``optim.global_norm`` sums)."""
        flat = tree.leaves(grads)
        if self._own_dev is None or self._own_dev.device != flat[0].device:
            self._own_dev = torch.from_numpy(self.own).to(flat[0].device)
        sq = torch.stack([torch.sum(torch.square(x.float())) for x in flat])
        sq = sq * self._own_dev
        dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=self.g_all)
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


# ---------------------------------------------------------------------------
# Sequence parallelism over the model axis (train_sp).
# ---------------------------------------------------------------------------


class ModelAxis(NamedTuple):
    """The model axis of a ``train_sp`` layout, as this rank sees it."""
    mesh: Any
    axis: str
    size: int        # T
    index: int       # s, this rank's place on it
    group: Any

    def peer(self, index: int) -> int:
        """The global rank at ``index`` on this rank's model axis."""
        return self.mesh.global_rank((self.axis,), index)


def model_axis(lay=None) -> ModelAxis:
    """The active (or given) ``train_sp`` layout's model axis."""
    lay = shd.layout() if lay is None else lay
    if not shd.seq_parallel(lay):
        raise ValueError(f"the sequence collectives run under a train_sp "
                         f"layout on a mesh; got {lay}")
    m = lay.model_axis
    return ModelAxis(lay.mesh, m, lay.n_shards, lay.mesh.index((m,)),
                     lay.mesh.group((m,)))


def _exchange(sends, recvs, group):
    """One batch of point-to-point ops: ``sends`` and ``recvs`` are
    (tensor, global peer rank) pairs; returns when all are done."""
    ops_ = ([dist.P2POp(dist.isend, t, p, group) for t, p in sends]
            + [dist.P2POp(dist.irecv, t, p, group) for t, p in recvs])
    if ops_:
        for req in dist.batch_isend_irecv(ops_):
            req.wait()


class _SeqGather(torch.autograd.Function):
    """This rank's columns on ``dim`` -> the T ranks' columns in order;
    backward, a reduce-scatter: each rank the sum of every rank's
    gradient of its columns."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(ax.size)]
        dist.all_gather(parts, x, group=ax.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        parts = [c.contiguous() for c in g.chunk(ctx.ax.size, dim=ctx.dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.ax.group)
        return out, None, None


def seq_gather(x, dim: int = 1, lay=None):
    """The full sequence from every rank's columns of it (dim ``dim``):
    one all-gather over the model axis; its gradient a reduce-scatter."""
    return _SeqGather.apply(x, dim, model_axis(lay))


class _StackGather(torch.autograd.Function):
    """Tensors of one dtype -> each rank's copies of each, stacked on a new
    dim 0 in the model axis's order: one all-gather of their flat
    concatenation; backward, a reduce-scatter of the stacked gradients
    (zeros where none reached a copy), each rank the sum over the ranks of
    its own copies' gradients."""

    @staticmethod
    def forward(ctx, ax, *xs):
        ctx.ax = ax
        ctx.shapes = [x.shape for x in xs]
        ctx.set_materialize_grads(False)
        flat = torch.cat([x.reshape(-1) for x in xs])
        ctx.like = (flat.dtype, flat.device)
        parts = list(torch.empty((ax.size, flat.numel()), dtype=flat.dtype,
                                 device=flat.device))
        dist.all_gather(parts, flat, group=ax.group)
        full = torch.stack(parts)
        out, off = [], 0
        for shape in ctx.shapes:
            n = math.prod(shape)
            out.append(full[:, off:off + n].reshape((ax.size, *shape)))
            off += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        ax = ctx.ax
        dtype, device = ctx.like
        full = torch.cat([
            (g if g is not None else torch.zeros(
                (ax.size, *shape), dtype=dtype, device=device)
             ).reshape(ax.size, -1) for g, shape in zip(gs, ctx.shapes)],
            dim=1)
        mine = torch.empty_like(full[0])
        dist.reduce_scatter(mine, [r.contiguous() for r in full],
                            group=ax.group)
        out, off = [], 0
        for shape in ctx.shapes:
            n = math.prod(shape)
            out.append(mine[off:off + n].view(shape))
            off += n
        return (None, *out)


def stack_gather(xs, lay=None):
    """Each of the tensors ``xs`` (one dtype) from every rank of the model
    axis, stacked on a new dim 0 (T, ...): one all-gather; the gradient a
    reduce-scatter (the recurrence's exclusive prefix across ranks)."""
    return _StackGather.apply(model_axis(lay), *xs)


class _Depend(torch.autograd.Function):
    """``y`` as it is, with other tensors in its graph: their gradient is
    none, but the backward of what made them runs once y's has."""

    @staticmethod
    def forward(ctx, y, *deps):
        ctx.n = len(deps)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return (g,) + (None,) * ctx.n


def depend(y, *deps):
    """``y``, its backward also running the backward of the collective that
    made ``deps``: a rank whose y reads none of a gather's output still
    joins the gather's reduce-scatter, which every rank of the group must
    call."""
    return _Depend.apply(y, *deps)


class _Halo(torch.autograd.Function):
    """The ``hops`` chunks before this rank's (fewer on the first ranks,
    which have fewer before them), then its own, along ``dim``: each rank
    sends its chunk to the next ``hops`` ranks; backward, each received
    chunk's gradient goes back to its sender, which adds it to its own."""

    @staticmethod
    def forward(ctx, x, dim, hops, ax):
        s, T = ax.index, ax.size
        ctx.dim, ctx.hops, ctx.ax = dim, hops, ax
        x = x.contiguous()
        got = [torch.empty_like(x) for _ in range(min(hops, s))]
        _exchange([(x, ax.peer(s + h)) for h in range(1, hops + 1)
                   if s + h < T],
                  [(got[-h], ax.peer(s - h)) for h in range(1, len(got) + 1)],
                  ax.group)
        return torch.cat(got + [x], dim=dim)

    @staticmethod
    def backward(ctx, g):
        ax, hops, dim = ctx.ax, ctx.hops, ctx.dim
        s, T = ax.index, ax.size
        parts = list(g.chunk(min(hops, s) + 1, dim=dim))
        mine = parts.pop().clone()
        back = [torch.empty_like(mine) for h in range(1, hops + 1)
                if s + h < T]
        _exchange([(parts[-h].contiguous(), ax.peer(s - h))
                   for h in range(1, len(parts) + 1)],
                  [(b, ax.peer(s + h)) for h, b in enumerate(back, 1)],
                  ax.group)
        for b in back:
            mine += b
        return mine, None, None, None


def halo(x, hops: int, dim: int = 1, lay=None):
    """This rank's columns with the ``min(hops, s)`` ranks' columns before
    them prepended (dim ``dim``), by point-to-point sends over the model
    axis: what a sliding window of at most ``hops`` chunks reads."""
    return _Halo.apply(x, dim, hops, model_axis(lay))


class _RingShift(torch.autograd.Function):
    """``x`` one step round the model ring: each rank's to the rank
    before it (s - 1), the first rank's to the last; backward, the
    gradients the other way round."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _ring(x, ax, -1)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, ctx.ax, 1), None


def _ring(x, ax, step):
    x = x.contiguous()
    out = torch.empty_like(x)
    s, T = ax.index, ax.size
    _exchange([(x, ax.peer((s + step) % T))],
              [(out, ax.peer((s - step) % T))], ax.group)
    return out


def ring_shift(x, lay=None):
    """The block of the rank after this one (s + 1), this rank's going to
    the rank before it: one step of the vocab ring."""
    return _RingShift.apply(x, model_axis(lay))


class _AllToAll(torch.autograd.Function):
    """Block t of ``x``'s dim 0 (T equal blocks) to rank t, block t of the
    result from rank t; the backward exchanges the gradients alike."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _a2a(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.ax), None


def _a2a(x, ax):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=ax.group)
    return out


def all_to_all(x, lay=None):
    """One all-to-all over the model axis of ``x``'s T equal dim-0 blocks
    (expert parallelism's dispatch and its inverse)."""
    return _AllToAll.apply(x, model_axis(lay))


def vocab_block(w, lay=None):
    """An untied head's ZeRO-3 shard, this rank's (D/T, V) rows of the
    (D, V) weight, -> its vocab block, the (D, V/T) columns ``[s V/T,
    (s+1) V/T)``: one all-to-all over the model axis.  Its gradient
    comes back by the inverse exchange as the gradient of the rank's own
    shard, whole."""
    ax = model_axis(lay)
    rows, V = w.shape
    if V % ax.size:
        raise ValueError(f"vocab_block: a vocab of {V} does not split over "
                         f"{ax.size} ranks")
    parts = w.unflatten(1, (ax.size, V // ax.size)).transpose(0, 1)
    return _AllToAll.apply(parts, ax).reshape(ax.size * rows, V // ax.size)


class _ModelSum(torch.autograd.Function):
    """The sum over the model axis of every rank's part, held by each;
    backward, the identity: every rank's loss is the whole sum, so the
    cotangent of a rank's part is the sum's."""

    @staticmethod
    def forward(ctx, x, ax, scale):
        ctx.scale = scale
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=ax.group)
        return y if scale == 1.0 else y * scale

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.scale == 1.0 else g * ctx.scale), None, None


def model_sum(x, lay=None):
    """Under ``train_sp``, the sum of ``x`` over the model axis (a loss's
    parts over the ranks' columns); ``x`` itself under other layouts."""
    lay = shd.layout() if lay is None else lay
    if not shd.seq_parallel(lay):
        return x
    return _ModelSum.apply(x, model_axis(lay), 1.0)


def model_mean(x, lay=None):
    """Under ``train_sp``, the mean of ``x`` over the model axis (the MoE
    router's statistics over the ranks' tokens); its gradient 1/T of the
    cotangent; ``x`` itself under other layouts."""
    lay = shd.layout() if lay is None else lay
    if not shd.seq_parallel(lay):
        return x
    ax = model_axis(lay)
    return _ModelSum.apply(x, ax, 1.0 / ax.size)
