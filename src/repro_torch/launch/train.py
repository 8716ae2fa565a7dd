"""Training entry points: the cutoff train step and the ``Trainer``.

The port of ``repro.launch.train``, on one device or across the
data-parallel ranks of a layout (``dist.sharding``).  ``make_train_step``
builds the step:

  * ``mask_agg="weights"`` (production, paper Alg. 1 / §4.3 variant):
    per-example weights carry the cutoff bit array, so the masked mean is
    the loss normalization itself;
  * ``mask_agg="psum"`` (explicit, Chen et al.'s PS semantics): per-worker
    gradients are written into one preallocated (W, N) f32 buffer and
    combined by ONE pass of the Hopper ``masked_grad_agg`` kernel
    (``dist.collectives.masked_grad_mean``);
  * gradient accumulation over ``grad_accum`` microbatches, and anytime
    (fractional) contributions on the psum path;
  * stale-gradient reuse (psum): the dropped workers' mean, a second
    ``masked_grad_agg`` pass over the same buffer, folded into the next
    step;
  * int8 error-feedback compression of the aggregated gradient.

Under a layout with dp axes (``dist.sharding.use_layout``) each rank
computes the gradients of its own rows and workers: the weights path
all-reduces the weighted-loss gradient (its normalizer the global one),
the psum path combines the rank's (W/R, N) buffer in the kernel's sum
mode, all-reduces it and divides (``core.aggregation.masked_psum_mean``).
The reported loss, ce and aux are the global ones.

Under a ZeRO-3 layout (``train_fsdp`` with a model axis, the reference's
FSDP) the state is this rank's shards (``shard_state``; ``state_shardings``
gives each leaf's dim and mesh axes, the reference's): each block's
weights are gathered where it runs, the full gradients fill the rows of a
shard-major buffer (``dist.sharding.ShardPlan``), whose one sum-mode
kernel pass is reduce-scattered over the model axis and summed over the
other dp axes (``dist.collectives.Zero3``), and the optimizer updates the
shards; with ``zero1`` the moments are also split over "data".

The update is the optimizer's: with ``optim.adamw(..., fused=True)`` one
Hopper ``fused_adam`` launch updates every parameter and both moments in
place, the port's counterpart of the JAX step's donated state.

Under ``train_sp`` (the reference's sequence parallelism) the batch is
split over the dp axes alone, each rank of a model axis holding the same
rows at full length, and the forward takes each rank's columns of the
sequence; the parameters are ZeRO-3 over the model axis as under
``train_fsdp``.  Each rank's gradient is its columns' part of its
workers' gradients, and the same buffer, kernel pass and reduce-scatter
sum those parts.

The ``Trainer`` is the host-side loop: controller -> bit array ->
weights (or the bit array itself under ``mask_agg="psum"``), simulated
(or measured) per-worker step times, the stale-gradient buffer, elastic
resize, checkpoint/restart through ``checkpoint.store``, and telemetry
through an optional ``obs.ObsRun``.  Across ranks only the lead rank holds
the controller; its decision reaches the others by one broadcast a step.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import optim, tree
from repro_torch.checkpoint import store
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.perf.knobs import knobs


# ---------------------------------------------------------------------------
# Train step.
# ---------------------------------------------------------------------------


def make_loss_fn(cfg, aux_coef: float = 0.01):
    """Cross-entropy summed over tokens and divided by ``normalizer``, plus
    ``aux_coef`` times the auxiliary loss.  The CE is dense, or, where the
    active knobs ask ``ce_chunk > 0`` (``perf.knobs``), the vocab-chunked
    ``models.model.chunked_ce_sum`` from the final hidden state.
    ``ce_impl="ring"`` is ``models.model.ring_ce_sum``: the vocab ring
    under ``train_sp``, and the dense sum under every other layout, as
    the reference's ring computes it outside ``train_sp``.

    Under ``train_sp`` the batch is this rank's rows at full length and
    the CE is its columns' (``labels`` cut as the forward cuts the
    tokens), summed over the model axis (``collectives.model_sum``; the
    ring sums its own): every rank of a model axis holds the loss of the
    rows they share, and its gradient is its columns' part."""
    def loss_fn(params, batch, normalizer):
        w = batch.get("weights")
        k = knobs()
        if k.ce_impl == "ring":
            shd.require_data_parallel(shd.layout(), "ce_impl='ring'")
        labels = shd.seq_shard(batch["labels"])
        if k.ce_impl == "ring":
            x, _, aux = M.forward(cfg, params, batch, mode="train",
                                  head=False)
            ce_sum = M.ring_ce_sum(cfg, params, x, labels, w)
        elif k.ce_chunk > 0:
            x, _, aux = M.forward(cfg, params, batch, mode="train",
                                  head=False)
            ce_sum = collectives.model_sum(
                M.chunked_ce_sum(cfg, params, x, labels, w, k.ce_chunk))
        else:
            logits, _, aux = M.forward(cfg, params, batch, mode="train")
            ce_sum = collectives.model_sum(
                M._ce_sum_dense(logits, labels, w))
        loss = ce_sum / normalizer
        return loss + aux_coef * aux, {"ce": loss, "aux": aux}
    return loss_fn


MASK_AGG_MODES = ("weights", "psum")


def _split(batch, parts: int):
    """Split every batch entry into ``parts`` contiguous row blocks: on
    axis 0, except M-RoPE's (3, B, S) positions, whose rows are axis 1
    (the reference's ``_split_batch``).  ``frames``, ``patch_embeds`` and
    ``image_mask`` are split by row like the tokens."""
    B = batch["tokens"].shape[0]
    if B % parts:
        raise ValueError(f"{B} batch rows do not split into {parts} equal "
                         f"parts")
    n = B // parts

    def rows(k, v, i):
        if k == "positions" and v.ndim == 3:
            return v[:, i * n:(i + 1) * n]
        return v[i * n:(i + 1) * n]

    return [{k: rows(k, v, i) for k, v in batch.items()}
            for i in range(parts)]


def _device_batch(batch, device):
    """Batch arrays onto the params' device; the psum ``mask`` stays on the
    host (the step reads it there to pick each worker's microbatches).
    The positions are checked here, on the host, against the train
    forward's contract (``models.model.check_positions``)."""
    if "positions" in batch:
        M.check_positions(batch["positions"])
    out = {}
    for k, v in batch.items():
        if k == "mask":
            out[k] = torch.as_tensor(np.asarray(v, np.float32))
        else:
            out[k] = torch.as_tensor(v).to(device, non_blocking=True)
    return out


class _DP(NamedTuple):
    """This process's place among the data-parallel ranks of a layout."""
    mesh: Any
    axes: tuple
    size: int        # R, the dp ranks
    index: int       # r, this rank's index along the dp axes
    group: Any       # their process group
    # every rank of the step: the dp axes, and under train_sp the model
    # axis, whose ranks share their rows; the lead decides for them all
    share: tuple = ()

    @property
    def lead(self) -> bool:
        return self.mesh.index(self.share) == 0


def _dp(lay) -> Optional[_DP]:
    """The dp ranks of a layout with dp axes (or of ``train_sp``, whose
    model axis shares a decision even without them), else None; a layout
    this slice does not run raises by name."""
    shd.require_data_parallel(lay, "the train step")
    sp = shd.seq_parallel(lay)
    if lay.mesh is None or not (lay.dp or sp):
        return None
    mesh, axes = lay.mesh, tuple(lay.dp)
    share = axes + ((lay.model_axis,) if sp else ())
    return _DP(mesh, axes, mesh.size(axes), mesh.index(axes),
               mesh.group(axes), tuple(a for a in mesh.axis_names
                                       if a in share))


def _value_and_grad(loss_fn, params, batch, norm, z=None):
    """(loss, metrics, grads as a list in ``tree.leaves`` order).  The
    params stay plain tensors: the gradient is taken w.r.t. detached
    aliases of them.  Under ZeRO-3 (``z``, a ``dist.collectives.Zero3``)
    the params are this rank's slices, gathered at their use sites, and
    the gradients are the FULL ones."""
    if z is None:
        flat = [p.detach().requires_grad_(True)
                for p in tree.leaves(params)]
        loss, metrics = loss_fn(tree.unflatten(params, flat), batch, norm)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    else:
        with z.session(tree.leaves(params)) as (inputs, flat):
            loss, metrics = loss_fn(tree.unflatten(params, inputs), batch,
                                    norm)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros(p.shape, dtype=p.dtype, device=p.device)
             if g is None else g for p, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg, optimizer: optim.Optimizer, *,
                    grad_accum: int = 1, aux_coef: float = 0.01,
                    compress_pod_grads: bool = False,
                    mask_agg: str = "weights", stale_reuse: bool = False,
                    zero1: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params", "opt"[, "ef"]}; batch holds numpy arrays
    (``tokens``, ``labels``, ``positions`` and ``weights`` or ``mask``) and
    goes to the params' device.

    mask_agg="weights": batch["weights"] is the per-example cutoff mask
    expanded by ``dist.collectives.example_weights``.

    mask_agg="psum": batch["mask"] is the per-worker CONTRIBUTION vector
    ((n_workers,) float on the host, n_workers | global batch): 0/1 for the
    discard policy, completed-microbatch fractions for the anytime policy.
    Worker w owns the w-th contiguous slice of the batch; with
    contribution f it keeps its first ``round(f * grad_accum)`` microbatch
    gradients (``torch.round`` rounds half to even, as ``jnp.round``
    does), normalized by ``max(f, 1/grad_accum)`` times its full token
    count, and writes their f32 sum into row w of one preallocated (W, N)
    buffer (``kernels.ops.WorkerGrads``, built at the first step at W).
    Trainers sharing one step at different widths (the multi-tenant jobs
    of ``launch.multi_job``) each register theirs (``train_step.hold``) and
    keep one buffer per width; a width no trainer holds any longer loses
    its buffer before another is allocated.  ONE
    masked mean weighted by f then combines the rows: the JAX step's
    concatenate-then-combine result without the concatenation copy.  With
    a 0/1 vector every weight is exactly 1.0 or 0.0, and the weights and
    psum paths agree where the auxiliary loss is zero (dense, xLSTM and
    Hymba archs, or aux_coef 0).  For MoE archs they differ on the aux, as the
    JAX step's do: "psum" takes each worker's own aux (a dropped worker
    contributes nothing, aux included) and routes each worker's rows at
    their own capacity, "weights" takes the whole batch's.

    stale_reuse=True (mask_agg="psum" only, the
    ``core.controller.StaleReuseController`` policy): the step also
    returns the DROPPED workers' mean gradient and their count as the
    device pair ``metrics["stale"]`` (a second masked mean over the same
    buffer, weighted by ``1 - mask``), and consumes ``batch["stale_g"]``
    and ``batch["stale_w"]``, last step's dropped mean and its decayed
    weight w (device tensors), folding them into this step's mean as
    ``g = a (c / (c + w)) + b (w / (c + w))``, each factor cast to the
    leaf's dtype as the JAX step casts it.  With w = 0 the factors are
    exactly 1.0 and 0.0: the update is plain discard's, bit for bit.

    compress_pod_grads=True: the aggregated gradient goes through int8
    error-feedback compression (``optim.error_feedback_compress``) before
    the update; the state carries the f32 residuals as ``"ef"``.

    Under the active layout's dp axes (R ranks; rank r is this process's
    index along them) the batch holds rank r's rows of the global batch,
    rows ``[r B/R, (r + 1) B/R)``, with the GLOBAL cutoff vector:
    ``weights`` (B,) or ``mask`` (W,), W/R workers a rank.  The weights
    path takes the global normalizer from the whole vector and all-reduces
    the gradient (through a flat buffer kept across steps, one collective
    per dtype); the psum path writes its rank's W/R rows and combines them
    through ``collectives.masked_grad_mean`` (sum mode, one all-reduce,
    the division), the dropped mean of stale reuse likewise.  Every step also
    all-reduces the local sums of loss, ce and aux once, so the metrics are
    the one-process step's.  The weights path of an MoE arch raises there:
    its auxiliary loss is a function of the whole batch's routing, which no
    sum of the ranks' gives.

    Under a ZeRO-3 layout (``dist.sharding.is_zero3``: ``train_fsdp`` with
    a model axis, of any size) ``state`` is this rank's shards
    (:func:`shard_state` with the same ``zero1``): the plan is the
    config's tree's (``dist.sharding.shard_plan``).  The forward gathers
    each block's weights where it runs and again in its backward; each
    worker's full gradient fills its row of the shard-major (W/R, N)
    buffer, and the rank's ONE sum-mode kernel pass is reduce-scattered
    over the model axis, summed over the other dp axes (zero1: a
    reduce-scatter over "data") and divided (``collectives.Zero3``); the
    weights path writes its gradient into a one-row buffer of the same
    layout and reduces it alike.  The optimizer then updates the rank's
    shards (the fused Adam: one launch over them; zero1: over its pieces,
    all-gathered over "data" after).  Grad accumulation, anytime
    fractions and stale reuse run on the shards (``train_step.zeros_grad``
    gives stale reuse's zero buffer in the gradient's layout), and so does
    compression, whose per-leaf scales are the full leaves' (a max over
    the model axis) — except under zero1, where it raises: its residuals
    take the parameters' sharding, zero1's gradient the moments'.
    """
    if mask_agg not in MASK_AGG_MODES:
        raise ValueError(f"unknown mask_agg {mask_agg!r} "
                         f"(want one of {MASK_AGG_MODES})")
    if stale_reuse and mask_agg != "psum":
        raise ValueError(
            "stale_reuse needs per-worker gradients: build the step with "
            "mask_agg='psum' (the weights path never materializes a "
            "dropped worker's gradient to buffer)")
    loss_fn = make_loss_fn(cfg, aux_coef)
    buffers: Dict[Any, ops.WorkerGrads] = {}
    weights_bufs: Dict[Any, ops.WorkerGrads] = {}  # ZeRO-3's one-row
    plans: Dict[Any, shd.ShardPlan] = {}
    flat_sums: Dict[Any, torch.Tensor] = {}   # (dtype, device) -> (n,)
    holders: Dict[int, int] = {}      # id(trainer) -> the width it steps at

    def normalizer_of(batch, R=1):
        """The loss normalizer; ``weights`` is the global vector, the
        tokens R ranks' share of the batch (under ``train_sp`` at full
        length: the global tokens, not a rank's columns)."""
        w = batch.get("weights")
        B, S = batch["tokens"].shape
        if w is None:
            return float(B * S * R)
        return torch.clamp(torch.sum(w.float()) * S, min=1e-6)

    def plan_for(lay):
        """The ZeRO-3 shard plan of the config's tree under ``lay``, or
        None when ``lay`` is not a ZeRO-3 layout."""
        if not shd.is_zero3(lay):
            return None
        if lay not in plans:
            plans[lay] = shd.shard_plan(
                M.init_model(cfg, None, device="meta"), lay, zero1=zero1)
        return plans[lay]

    def zero3_of(lay):
        plan = plan_for(lay)
        if plan is None:
            return None
        if compress_pod_grads and zero1:
            raise NotImplementedError(
                "error-feedback compression under zero1: its residuals take "
                "the parameters' sharding (state_shardings' 'ef'), zero1's "
                "gradient the moments' pieces; build the step without zero1 "
                "or without compress_pod_grads (ROADMAP C.23)")
        return collectives.Zero3.of(lay, plan)

    def zeros_grad(params):
        """Zeros in the layout of the step's aggregated gradient (stale
        reuse's first buffer): the params' own, or under ZeRO-3 each
        leaf's moments' shape."""
        plan = plan_for(shd.layout())
        if plan is None:
            return tree.map(torch.zeros_like, params)
        flat = tree.leaves(params)
        return tree.unflatten(params, [
            torch.zeros(plan.slice_shape(i, moments=True), dtype=p.dtype,
                        device=p.device) for i, p in enumerate(flat)])

    def accumulate(params, micro, norm, weights, rows, fit=None, z=None):
        """Sum of weight x gradient over the microbatches into the f32
        ``rows`` (the first written, the rest added), and the weighted sums
        of loss, ce and aux.  Weights are the host floats 1.0 or 0.0.
        ``fit(i, g)`` views leaf i's gradient in its row's shape (a plan's
        strided columns); ``z`` runs the forward and backward under
        ZeRO-3."""
        loss = ce = aux = 0.0
        for j, (mb, wj) in enumerate(zip(micro, weights)):
            l_mb, metrics, g = _value_and_grad(loss_fn, params, mb, norm, z)
            if fit is not None:
                g = [fit(i, x) for i, x in enumerate(g)]
            for row, x in zip(rows, g):
                if j == 0:
                    row.copy_(x)
                    if wj != 1.0:
                        row.mul_(wj)
                else:
                    row.add_(x, alpha=wj)
            loss = loss + l_mb * wj
            ce = ce + metrics["ce"] * wj
            aux = aux + metrics["aux"] * wj
        return loss, ce, aux

    def grads_of(params, batch, norm, z=None):
        if grad_accum == 1:
            return _value_and_grad(loss_fn, params, batch, norm, z)
        shapes = ([p.shape for p in tree.leaves(params)] if z is None
                  else [leaf.shape for leaf in z.plan.leaves])
        dev = tree.leaves(params)[0].device
        rows = [torch.empty(sh, dtype=torch.float32, device=dev)
                for sh in shapes]
        loss, _, aux = accumulate(params, _split(batch, grad_accum), norm,
                                  [1.0] * grad_accum, rows, z=z)
        return loss, {"ce": loss, "aux": aux / grad_accum}, rows

    def worker_buffer(params, W, plan=None):
        # a width that is neither this call's nor held by a trainer
        # (``train_step.hold``) loses its buffer BEFORE a new one is
        # allocated: a single job's resize frees the old width's buffer
        # first, so the two never coexist, while jobs that share this step
        # at different widths keep one buffer each
        keep = set(holders.values()) | {W}
        for k in [k for k in buffers if k[0] not in keep]:
            del buffers[k]
        key = (W, tree.leaves(params)[0].device, plan)
        if key not in buffers:
            buffers[key] = (ops.WorkerGrads(params, W) if plan is None
                            else ops.WorkerGrads(params, W, plan=plan))
        return buffers[key]

    def hold(owner, W: int):
        """Record that ``owner`` (a Trainer) steps at width ``W``: the
        buffer of every width some live owner holds survives calls at
        other widths.  An owner holds one width at a time; its hold goes
        with it."""
        key = id(owner)
        if key not in holders:
            weakref.finalize(owner, holders.pop, key, None)
        holders[key] = int(W)

    def fold_stale(grads, stale_g, stale_w, c):
        """g = a (c / (c + w)) + b (w / (c + w)), as the JAX step."""
        w = torch.as_tensor(stale_w, dtype=torch.float32).to(c.device)
        denom = c + w
        fa, fb = c / denom, w / denom
        factors = {dt: (fa.to(dt), fb.to(dt))
                   for dt in {a.dtype for a in tree.leaves(grads)}}

        def one(a, b):
            ca, cb = factors[a.dtype]
            return a * ca + b.to(a.dtype) * cb

        return tree.map(one, grads, stale_g)

    def all_reduce_grads(grads, group):
        """All-reduce (sum) the gradient leaves: one copy kernel writes
        them into a flat buffer per dtype, kept across steps, one
        collective sums it, and the sums come back as views of it.  (One
        collective a leaf pays an eager NCCL call's host cost 290 times
        at qwen2-0.5b: PERF.md §5.)"""
        out = list(grads)
        by_dtype: Dict[Any, list] = {}
        for i, g in enumerate(grads):
            by_dtype.setdefault(g.dtype, []).append(i)
        for dtype, idx in by_dtype.items():
            n = sum(grads[i].numel() for i in idx)
            key = (dtype, grads[idx[0]].device)
            flat = flat_sums.get(key)
            if flat is None or flat.numel() != n:
                flat = flat_sums[key] = torch.empty(n, dtype=dtype,
                                                    device=key[1])
            torch.cat([grads[i].reshape(-1) for i in idx], out=flat)
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            off = 0
            for i in idx:
                k = grads[i].numel()
                out[i] = flat[off:off + k].view(grads[i].shape)
                off += k
        return out

    def metric_sums(sums, dp):
        """The local sums of loss, ce and aux, all-reduced over the dp
        ranks in one collective (as they are in one process)."""
        if dp is None:
            return sums
        both = torch.stack(sums)
        dist.all_reduce(both, op=dist.ReduceOp.SUM, group=dp.group)
        return list(both.unbind())

    def weights_grads_of(params, batch, dp, z=None):
        if dp is None and z is None:
            # the optimizer's kernel reads contiguous leaves, and autograd
            # may hand a leaf's gradient back permuted (the sLSTM's r, out
            # of its einsum); the other paths copy into flat buffers
            loss, metrics, grads = grads_of(params, batch,
                                            normalizer_of(batch))
            return loss, metrics, [g.contiguous() for g in grads]
        R, r = (1, 0) if dp is None else (dp.size, dp.index)
        if cfg.family == "moe" and dp is not None:
            raise NotImplementedError(
                "the weights path of an MoE arch across dp ranks: its aux "
                "loss is the whole batch's routing, which no sum of the "
                "ranks' gives; use mask_agg='psum' (each worker's own aux)")
        b = batch["tokens"].shape[0]
        w = batch.get("weights")
        if w is not None and w.shape[0] != b * R:
            raise ValueError(f"{R} dp ranks of {b} rows each take the "
                             f"global ({b * R},) weights; got "
                             f"{tuple(w.shape)}")
        norm = normalizer_of(batch, R)
        if w is not None:
            batch = dict(batch, weights=w[r * b:(r + 1) * b])
        loss, metrics, grads = grads_of(params, batch, norm, z)
        loss, ce, aux = metric_sums([loss, metrics["ce"], metrics["aux"]],
                                    dp)
        if z is None:
            return loss, {"ce": ce, "aux": aux}, all_reduce_grads(
                grads, dp.group)
        # the rank's gradient in the shard-major layout, then the same
        # reduce-scatter and sums as the psum path's (no division: the
        # normalizer is the global one)
        key = (tree.leaves(params)[0].device, z.plan)
        if key not in weights_bufs:
            weights_bufs.clear()
            weights_bufs[key] = ops.WorkerGrads(params, 1, plan=z.plan)
        buf = weights_bufs[key]
        for i, (row, g) in enumerate(zip(buf.rows[0], grads)):
            row.copy_(buf.fit(i, g))
        return loss, {"ce": ce, "aux": aux}, z.as_tree(
            params, z.reduce(buf.buf[0]))

    def psum_grads_of(params, batch, dp, stale_in=None, z=None):
        mask = batch["mask"]
        data = {k: v for k, v in batch.items() if k != "mask"}
        B, S = data["tokens"].shape
        R, r = (1, 0) if dp is None else (dp.size, dp.index)
        if mask.shape[0] % R:
            raise ValueError(f"{mask.shape[0]} workers do not split over "
                             f"{R} dp ranks")
        W = mask.shape[0] // R           # this rank's workers
        local = mask[r * W:(r + 1) * W]
        base_norm = np.float32((B // W) * S)
        done = torch.round(local * grad_accum).tolist()
        buf = worker_buffer(params, W, None if z is None else z.plan)
        losses, ces, auxs = [], [], []
        for w, wbatch in enumerate(_split(data, W)):
            f = np.float32(local[w].item())
            norm = float(np.maximum(f, np.float32(1.0 / grad_accum))
                         * base_norm)
            # the completed-microbatch prefix: the first round(f G) count
            weights = [1.0 if j < done[w] else 0.0
                       for j in range(grad_accum)]
            loss, ce, aux = accumulate(params, _split(wbatch, grad_accum),
                                       norm, weights, buf.rows[w],
                                       buf.fit if z is not None else None,
                                       z)
            if grad_accum > 1:
                ce, aux = loss, aux / grad_accum
            losses.append(loss)
            ces.append(ce)
            auxs.append(aux)
        # one sum-mode kernel pass over the rank's rows, then the
        # reduce-scatter over the model axis.  Under train_sp a rank's row
        # w holds worker w's gradient from this rank's columns only; the
        # reduce-scatter adds the columns' parts of ONE worker's gradient
        # (the ranks of a model axis hold the same workers), so masking
        # each row first is still the masked mean across workers
        # (ROADMAP C.24's argument)
        agg = collectives.masked_grad_mean(buf, mask)
        mask_dev = mask.to(buf.buf.device, non_blocking=True)
        local_dev = mask_dev[r * W:(r + 1) * W]
        c = torch.clamp(torch.sum(mask_dev), min=1.0)
        stale = None
        if stale_in is not None:
            # the dropped workers' mean, buffered by the Trainer for the
            # NEXT step (Dutta et al.); stale reuse is a 0/1-mask policy,
            # so 1 - mask is the dropped bit array
            stale = (collectives.masked_grad_mean(buf, 1.0 - mask),
                     torch.sum(1.0 - mask_dev))
            agg = fold_stale(agg, *stale_in, c)
        loss, ce, aux = metric_sums(
            [torch.sum(torch.stack(xs) * local_dev)
             for xs in (losses, ces, auxs)], dp)
        return loss / c, {"ce": ce / c, "aux": aux / c}, agg, stale

    def train_step(state, batch):
        params = state["params"]
        batch = dict(batch)
        stale_in = (batch.pop("stale_g", None), batch.pop("stale_w", None))
        if not stale_reuse:
            stale_in = None        # a plain step ignores them, as JAX's
        elif stale_in[0] is None:
            raise ValueError(
                "a stale_reuse step folds batch['stale_g'] with weight "
                "batch['stale_w']: drive it with a StaleReuseController")
        batch = _device_batch(batch, tree.leaves(params)[0].device)
        lay = shd.layout()
        dp = _dp(lay)
        z = zero3_of(lay)
        if mask_agg == "psum":
            loss, metrics, grads, stale = psum_grads_of(params, batch, dp,
                                                        stale_in, z)
        elif z is None:
            loss, metrics, flat = weights_grads_of(params, batch, dp)
            grads = tree.unflatten(params, flat)
        else:
            loss, metrics, grads = weights_grads_of(params, batch, dp, z)
        if compress_pod_grads:
            grads, ef = optim.error_feedback_compress(
                grads, state.get("ef"),
                reduce_max=None if z is None else z.max_over_model)
        if z is None:
            ups, opt = optimizer.update(grads, state["opt"], params)
            params = optim.apply_updates(params, ups)
            gnorm = optim.global_norm(grads)
        else:
            params, opt = z.update(optimizer, grads, state["opt"], params)
            gnorm = z.global_norm(grads)
        new_state = {"params": params, "opt": opt}
        if compress_pod_grads:
            new_state["ef"] = ef
        metrics = dict(metrics, loss=loss, gnorm=gnorm)
        if stale_reuse:
            metrics["stale"] = stale
        return new_state, metrics

    train_step.hold = hold
    train_step.buffers = buffers
    train_step.plan_for = plan_for
    train_step.zeros_grad = zeros_grad
    return train_step


# ---------------------------------------------------------------------------
# The ZeRO-3 train state: placement, shards, gathers.
# ---------------------------------------------------------------------------


def state_shardings(cfg, params, lay, *, zero1: bool = False,
                    has_ef: bool = False):
    """Each leaf's (dim, mesh axes) of the train state under ``lay``, or
    None where it is replicated: the reference's ``state_shardings`` spec
    for ``{"params", "opt": {"step", "m", "v", "mu"}[, "ef"]}``.  The
    params are ZeRO-3 over the model axis (``dist.sharding.placement``);
    with ``zero1`` the moments of a leaf sharded on dim k are sharded on
    it over (model, "data") where T·D divides it (the reference's
    ``widen``).  ``params`` is the full tree (any leaves with a shape;
    the port keeps one dict a layer, so nothing is stacked)."""
    del cfg   # the port's trees carry no scan-stacked leaves
    plan = shd.shard_plan(params, lay, zero1=zero1)
    m = lay.model_axis

    def spec(moments):
        return tree.unflatten(params, [plan.axes(i, m, moments)
                                       for i in range(len(plan.leaves))])

    mom = spec(True)
    out = {"params": spec(False),
           "opt": {"step": None, "m": mom, "v": mom, "mu": mom}}
    if has_ef:
        out["ef"] = spec(False)
    return out


def _state_parts(state):
    """(name, subtree, moments?) of a train state's trees: the params and
    ``ef`` (the params' sharding), the optimizer's moment trees (``m``,
    ``v``, ``mu``: the moments'), anything else (``step``) whole."""
    parts = [("params", state["params"], False)]
    for k, v in state.get("opt", {}).items():
        if k in ("m", "v", "mu"):
            parts.append((("opt", k), v, True))
    if "ef" in state:
        parts.append(("ef", state["ef"], False))
    return parts


def _with_parts(state, new):
    out = dict(state)
    out["opt"] = dict(state.get("opt", {}))
    for key, v in new.items():
        if isinstance(key, tuple):
            out[key[0]][key[1]] = v
        else:
            out[key] = v
    return out


def shard_tree(t, plan: shd.ShardPlan, *, moments: bool = False,
               device=None):
    """A full tree -> this rank's slice of each leaf (``moments``: its
    moments' piece under zero1), copied out so that the full tree can
    go, on ``device`` (default: the leaf's own)."""
    flat = tree.leaves(t)
    if len(flat) != len(plan.leaves):
        raise ValueError(f"shard_tree: {len(flat)} leaves, the plan has "
                         f"{len(plan.leaves)}")
    out = []
    for i, x in enumerate(flat):
        if tuple(x.shape) != plan.leaves[i].shape:
            raise ValueError(f"shard_tree: leaf {plan.leaves[i].path!r} is "
                             f"{tuple(x.shape)}, the plan's full leaf "
                             f"{plan.leaves[i].shape}")
        part = plan.slice_of(i, x, moments)
        dev = x.device if device is None else torch.device(device)
        out.append(torch.empty(part.shape, dtype=x.dtype,
                               device=dev).copy_(part))
    return tree.unflatten(t, out)


def shard_state(state, plan: shd.ShardPlan, device=None):
    """A full train state -> this rank's shards under ``plan``: the
    params' and ``ef``'s slices, the moments' pieces (:func:`shard_tree`);
    ``step`` as it is."""
    return _with_parts(state, {
        k: shard_tree(v, plan, moments=mom, device=device)
        for k, v, mom in _state_parts(state)})


def gather_state(state, plan: shd.ShardPlan, lay):
    """This rank's shards of a train state -> the full state, on every
    rank (a collective: every rank calls it)."""
    z = collectives.Zero3.of(lay, plan)
    return _with_parts(state, {k: z.gather_tree(v, moments=mom)
                               for k, v, mom in _state_parts(state)})


def clock_to_loss(history, target: float, window: int = 3):
    """Simulated wall-clock until the ``window``-step trailing mean loss
    reaches ``target``; None if the run never gets there.

    ``history`` is a list of step records (or anything with a ``records``
    attribute) whose losses are already drained floats, i.e. after
    ``run()`` returned.  Only FULL windows are eligible: the first
    ``window - 1`` steps cannot trigger the target.
    """
    records = getattr(history, "records", history)
    losses = [h["loss"] for h in records]
    for i in range(window - 1, len(losses)):
        if np.mean(losses[i - window + 1:i + 1]) <= target:
            return records[i]["clock"]
    return None


# ---------------------------------------------------------------------------
# Trainer (the host-side loop).
# ---------------------------------------------------------------------------


@dataclass
class Trainer:
    """Cutoff-SGD trainer: controller + masked aggregation + checkpoints.

    ``n_workers`` virtual workers share one device.  ``timer`` provides
    per-worker step times each iteration: a ``ClusterSim`` / ``TraceReplay``,
    or per-host measurements.  ``mask_agg`` must match the
    ``make_train_step`` the ``step_fn`` was built with.

    The hot loop launches the train step (PyTorch queues its kernels on
    the card and returns) BEFORE the controller's ``observe`` runs, so the
    parameter server's bookkeeping overlaps the device's gradient work.
    Per-step losses stay device tensors and are fetched together every
    ``metrics_every`` steps, at eval / verbose boundaries and at the end of
    :meth:`run`; ``metrics_every=0`` drains only at boundaries.

    Stale-gradient reuse: with a controller that carries ``stale_decay``
    (``core.controller.StaleReuseController``) the loop keeps last step's
    dropped-worker mean and count on the device and hands them to the
    next step (a ``stale_reuse=True`` psum step) with the decayed weight
    ``decay * count``, computed on the device.

    Checkpoints (``ckpt_dir``): every ``ckpt_every`` steps an async save
    (``checkpoint.store.AsyncCheckpointer``, ``keep`` newest) of the train
    state, ``meta`` (step, clock), ``ctl`` (worker count, membership, the
    controller's step and window) and, under stale reuse, ``stale`` (the
    buffered dropped mean and count, so a restart folds what the
    uninterrupted run would).  :meth:`restore_or_init` resumes from the
    newest valid step.

    Elastic membership: when the timer exposes ``n_workers`` /
    ``active_ids`` (``cluster.simulator.ChurnSim``), the loop follows the
    worker set before each step (:meth:`resize`): the controller remaps
    its window (``core.controller.ElasticController`` also decides through
    its Elfving fallback until its DMM is refitted at the new width), and
    the psum step's next call drops the (W, N) f32 worker buffer of the
    old width (which the trainer no longer holds) before it allocates one
    of the new width (full-width qwen2-0.5b: 15.81 GB at W = 8, 11.86 GB
    at W = 6), so the two never coexist.  A controller
    that keeps no step of its own (``ElasticController``) has the
    trainer's step saved in the ``ctl`` group, as in the reference.

    Telemetry (``obs``, a :class:`repro_torch.obs.ObsRun`): host spans
    around the step (``trainer.step``) and its parts
    (``controller.predict_cutoff``, ``train.dispatch``,
    ``controller.observe``), one ring row a step (``trainer`` or
    ``trainer[name]``: loss, gnorm, c, iter_time) and, at each metrics
    drain, the records forwarded to ``obs.steps`` and ``obs.drain()``
    inside an ``obs.drain`` span.  Nothing of it fetches inside a step,
    and the run's losses and cutoffs are the bare run's, bit for bit.

    Across data-parallel ranks (an active layout with dp axes, installed
    by ``dist.sharding.use_layout``): every rank runs this loop and takes
    its own rows of each global batch.  Only the lead rank (index 0 along
    the dp axes, and under ``train_sp`` along the model axis too, whose
    ranks share their rows) holds the ``controller`` and the ``timer``
    (the others pass None for both) and decides.  The (W,) vector the step aggregates
    with (the bit array or the anytime contributions), the cutoff c, the
    step's simulated time and the stale decay reach the other ranks by
    ONE device broadcast a step, before the step (stream-ordered on NCCL:
    no host sync on the lead rank; the others read it to pick their
    workers' microbatches), and they use it as sent.  The lead rank
    writes the checkpoints; every rank reads them.  :meth:`resize`
    raises: a change of width is a change of mesh.

    Under a ZeRO-3 layout (a ``step_fn`` from :func:`make_train_step`,
    whose ``plan_for`` gives the layout's shard plan) the state is held as
    this rank's shards: :meth:`restore_or_init` shards the full state that
    ``init_state_fn`` returns (``weights.from_jax``'s, say) or that a
    checkpoint holds, and at a checkpoint step every rank gathers the
    state (and the stale buffer), which the lead rank writes: the same
    files as the one-process trainer's, loadable either way.  ``eval_fn``
    gets the shards.
    """
    step_fn: Callable
    data: Any
    controller: Any
    timer: Any = None
    n_workers: int = 8
    mask_agg: str = "weights"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    metrics_every: int = 10
    obs: Any = None
    name: Optional[str] = None     # job/run label of the obs streams

    state: Dict = None
    step: int = 0
    sim_clock: float = 0.0
    members: Optional[np.ndarray] = None      # global worker ids
    history: list = field(default_factory=list)
    _pending_metrics: list = field(default_factory=list, repr=False)
    # stale-reuse buffer: last step's (dropped-mean tree, count) on device
    _stale: Any = field(default=None, repr=False)
    # a non-lead rank's stale decay, as the last broadcast carried it
    _decay_seen: Any = field(default=None, repr=False)

    @property
    def _stale_decay(self):
        if self.controller is None:
            return self._decay_seen
        return getattr(self.controller, "stale_decay", None)

    def _plan(self):
        """The active layout's ZeRO-3 shard plan, or None."""
        plan_for = getattr(self.step_fn, "plan_for", None)
        return plan_for(shd.layout()) if plan_for is not None else None

    def restore_or_init(self, init_state_fn):
        """Restore from the newest VALID checkpoint, else init cold.

        Steps are tried newest first: a corrupt or truncated step
        (``store.CheckpointError``: bad checksum, missing group, torn
        manifest) is skipped and the previous one is used.  The state is
        restored onto the devices and into the dtypes of
        ``init_state_fn()``'s tree; the controller (and, under stale
        reuse, the stale buffer) from the SAME step.  Under ZeRO-3 the
        full state (restored, or ``init_state_fn()``'s) is then cut into
        this rank's shards.
        """
        if self.members is None:
            self.members = np.arange(self.n_workers)
        steps = (list(reversed(store.list_steps(self.ckpt_dir)))
                 if self.ckpt_dir else [])
        example = init_state_fn()
        plan = self._plan()
        for step in steps:
            try:
                want = {"state": example,
                        "meta": {"step": 0, "clock": 0.0}}
                # a non-lead rank holds no controller: it takes the stale
                # buffer wherever the lead rank saved one
                stale = ((self._stale_decay is not None
                          or self.controller is None)
                         and "stale" in store.groups(self.ckpt_dir, step))
                if stale:
                    # restore makes new tensors shaped, typed and placed
                    # like the example's leaves: the params describe g
                    params = example["params"]
                    want["stale"] = {
                        "g": params,
                        "count": torch.zeros(
                            (), dtype=torch.float32,
                            device=tree.leaves(params)[0].device)}
                restored = store.restore(self.ckpt_dir, want, step=step)
                self.state = restored["state"]
                self.step = int(restored["meta"]["step"])
                self.sim_clock = float(restored["meta"]["clock"])
                if stale:
                    self._stale = (restored["stale"]["g"],
                                   restored["stale"]["count"])
                if plan is not None:
                    self.state = shard_state(self.state, plan)
                    if stale:
                        self._stale = (shard_tree(self._stale[0], plan,
                                                  moments=True),
                                       self._stale[1])
                if self.controller is not None:
                    self._restore_controller(step)
                return self
            except store.CheckpointError as e:
                print(f"checkpoint step {step} unusable ({e}); "
                      f"falling back to the previous step")
        self.state = (example if plan is None
                      else shard_state(example, plan))
        return self

    def _restore_controller(self, step):
        """Warm-restore the straggler predictor from the ``ctl`` group: the
        membership, the window (through ``seed_window``, which writes the
        device ring in place) and the controller's step."""
        grp = store.restore_group(self.ckpt_dir, "ctl", step=step)
        if grp is None:
            return
        n_saved = int(grp["n"])
        members = np.asarray(grp["members"], int)
        if (n_saved != self.n_workers
                or not np.array_equal(members, self.members)):
            # the checkpoint was taken with a different worker set: remap
            # onto the SAVED membership (survivor columns by global id)
            old = {wid: col for col, wid in enumerate(self.members)}
            col_map = np.array([old.get(wid, -1) for wid in members], int)
            self.resize(n_saved, col_map=col_map, members=members)
        ctl = self.controller
        if "window" in grp and hasattr(ctl, "seed_window"):
            ctl.seed_window(grp["window"])
        if hasattr(ctl, "_step"):
            ctl._step = int(grp["step"])

    def _controller_ckpt(self) -> Dict[str, np.ndarray]:
        members = (self.members if self.members is not None
                   else np.arange(self.n_workers))
        grp = {"n": np.int64(self.n_workers),
               "members": np.asarray(members, np.int64),
               "step": np.int64(getattr(self.controller, "_step",
                                        self.step))}
        if hasattr(self.controller, "window_array"):
            try:
                grp["window"] = np.asarray(self.controller.window_array(),
                                           np.float64)
            except ValueError:      # window still empty (cold controller)
                pass
        return grp

    # -- elastic membership --------------------------------------------
    def resize(self, n_workers: int, col_map=None, members=None):
        """Elastic worker-membership change, mid-run.

        Re-checks global-batch divisibility for the new width, remaps the
        controller (``col_map`` as in the JAX ``remap_columns``), and
        records the new membership.  The psum step builds a buffer of the
        new width at its next call.  Under a mesh layout it raises: the
        ranks' share of the workers is the mesh's.
        """
        if shd.layout().mesh is not None:
            raise NotImplementedError(
                "resizing a trainer across dp ranks changes the mesh; it "
                f"waits for {shd.WAITS_FOR['aot']}")
        n_new = int(n_workers)
        B = getattr(self.data, "global_batch", None)
        if B is not None and B % n_new != 0:
            raise ValueError(
                f"cannot resize to {n_new} workers: global batch {B} is "
                f"not divisible by the worker count (mask_agg="
                f"{self.mask_agg!r} slices the batch into B//W per-worker "
                f"shards — pick a worker count that divides {B})")
        if hasattr(self.controller, "resize"):
            self.controller.resize(n_new, col_map=col_map, members=members)
        elif getattr(self.controller, "n", n_new) != n_new:
            raise ValueError(
                f"controller {type(self.controller).__name__} cannot "
                f"resize to {n_new} workers")
        self.n_workers = n_new
        self.members = (np.asarray(members, int) if members is not None
                        else np.arange(n_new))
        return self

    def _sync_membership(self):
        """Follow the timer's worker set before each step."""
        if self.members is None:
            self.members = np.arange(self.n_workers)
        if self.timer is None:
            return
        ids = getattr(self.timer, "active_ids", None)
        w = int(getattr(self.timer, "n_workers", self.n_workers))
        if ids is None:
            if w != self.n_workers:
                self.resize(w)          # prefix survivors
            return
        ids = np.asarray(ids, int)
        if w == self.n_workers and np.array_equal(ids, self.members):
            return
        old = {wid: col for col, wid in enumerate(self.members)}
        col_map = np.array([old.get(wid, -1) for wid in ids], int)
        self.resize(w, col_map=col_map, members=ids)

    def _drain_metrics(self):
        """Fetch every pending device-side loss into its history record
        (one copy to the host for all of them) and forward the records to
        the obs step stream; then the obs drain, inside its span."""
        if self._pending_metrics:
            losses = torch.stack([rec["loss"]
                                  for rec in self._pending_metrics])
            for rec, loss in zip(self._pending_metrics, losses.tolist()):
                rec["loss"] = loss
                if self.obs is not None:
                    self.obs.steps.on_step(rec, job=self.name)
            self._pending_metrics.clear()
        if self.obs is not None:
            # decision scoring and the device rings come back here, and
            # ONLY here, never inside a step
            with self.obs.trace.span("obs.drain", track="trainer",
                                     step=self.step):
                self.obs.drain()

    def _stale_batch(self, batch, decay: float):
        """Last step's dropped mean and its decayed weight into the batch
        (zeros of weight 0 before the first step)."""
        if self.mask_agg != "psum":
            raise ValueError(
                "StaleReuseController needs mask_agg='psum' (the weights "
                "path never materializes a dropped worker's gradient to "
                "buffer)")
        if self._stale is None:
            params = self.state["params"]
            # zeros in the aggregated gradient's layout (under ZeRO-3 the
            # moments' shapes)
            zeros = getattr(self.step_fn, "zeros_grad", None)
            self._stale = ((zeros or (lambda t: tree.map(torch.zeros_like,
                                                         t)))(params),
                           torch.zeros((), dtype=torch.float32,
                                       device=tree.leaves(params)[0].device))
        stale_g, stale_d = self._stale
        batch["stale_g"] = stale_g
        # decay per worker that contributed to the buffered mean, kept
        # lazy on the device
        batch["stale_w"] = decay * stale_d

    def _broadcast_decision(self, n, c, contrib, iter_time, dp):
        """The lead rank's decision to every dp rank by ONE device
        broadcast of f64 ``[contrib (n), c, iter_time, stale decay or
        -1]``: the (n,) vector the step aggregates with (the bit array or
        the anytime contributions), the cutoff and the step's simulated
        time, each exact in f64.  The other ranks take it as sent."""
        mesh, lead = dp.mesh, dp.lead
        if lead:
            decay = self._stale_decay
            msg = np.concatenate([
                contrib, [c, iter_time, -1.0 if decay is None else decay]
            ]).astype(np.float64)
            host = torch.from_numpy(msg)
            if mesh.device.type == "cuda":
                # from pinned memory the upload is queued, not waited on
                host = host.pin_memory()
            vec = host.to(mesh.device, non_blocking=True)
        else:
            vec = torch.empty(n + 3, dtype=torch.float64, device=mesh.device)
        dist.broadcast(vec, src=mesh.global_rank(dp.share, 0),
                       group=mesh.group(dp.share))
        if lead:
            return c, contrib, iter_time
        msg = vec.cpu().numpy()
        self._decay_seen = None if msg[n + 2] < 0 else float(msg[n + 2])
        return int(msg[n]), msg[:n].astype(np.float32), float(msg[n + 1])

    def run(self, n_steps: int, *, eval_fn=None, eval_every: int = 0,
            verbose: bool = False):
        dp = _dp(shd.layout())
        lead = dp is None or dp.lead
        if not lead and (self.controller is not None
                         or self.timer is not None):
            raise ValueError(
                "a dp rank other than the lead holds neither a controller "
                "nor a timer: the lead's decision reaches it by broadcast")
        ckpt = (store.AsyncCheckpointer(self.ckpt_dir, self.keep)
                if self.ckpt_dir and lead else None)
        hold = getattr(self.step_fn, "hold", None)
        tracer = self.obs.trace if self.obs is not None else None

        def span(name, **attrs):
            return (tracer.span(name, track="trainer", **attrs)
                    if tracer is not None else contextlib.nullcontext())

        ring = (self.obs.metrics.ring(
            "trainer" if self.name is None else f"trainer[{self.name}]",
            ("loss", "gnorm", "c", "iter_time"))
            if self.obs is not None else None)
        for _ in range(n_steps):
            with span("trainer.step", step=self.step + 1, job=self.name):
                self._step_once(ckpt, hold, span, ring, eval_fn,
                                eval_every, verbose, dp)
        self._drain_metrics()
        if ckpt:
            ckpt.wait()
        return self.history

    def _step_once(self, ckpt, hold, span, ring, eval_fn, eval_every,
                   verbose, dp=None):
        """One step of :meth:`run`: cutoff, bit array, train step, observe,
        and the drains and checkpoints that fall on it."""
        lead = dp is None or dp.lead
        if lead:
            self._sync_membership()
        n = self.n_workers
        if hold is not None and self.mask_agg == "psum":
            hold(self, n)
        c = contrib = iter_time = None
        if lead:
            with span("controller.predict_cutoff"):
                c = min(int(self.controller.predict_cutoff()), n)
            times = (self.timer.step() if self.timer is not None
                     else np.ones(n))
            # fastest c workers participate (the PS's bit array)
            order = np.argsort(times)
            mask = np.zeros(n, np.float32)
            mask[order[:c]] = 1.0
            iter_time = float(times[order[c - 1]])
            # the controller sees the SAME worker set the aggregation used
            finished = mask.astype(bool)
            # anytime policy: stragglers contribute their completed
            # fraction instead of a zeroed bit; finishers stay 1.0
            contrib = mask
            if hasattr(self.controller, "contribution"):
                contrib = np.asarray(
                    self.controller.contribution(times, c), np.float32)
        if dp is not None:
            # the other ranks aggregate with the lead's vector as sent
            c, contrib, iter_time = self._broadcast_decision(
                n, c, contrib, iter_time, dp)

        batch = dict(self.data.batch(self.step))
        if dp is not None:
            # this rank's rows of the global batch; the cutoff vector
            # below stays global
            batch = _split(batch, dp.size)[dp.index]
        if self.mask_agg == "psum":
            batch["mask"] = contrib
        else:
            rows = batch["tokens"].shape[0] * (1 if dp is None else dp.size)
            batch["weights"] = collectives.example_weights(contrib, rows)
        decay = self._stale_decay
        if decay is not None:
            self._stale_batch(batch, decay)
        # launch the train step FIRST, then the PS's observe, so the
        # controller's work overlaps the device's
        with span("train.dispatch"):
            self.state, metrics = self.step_fn(self.state, batch)
        if decay is not None:
            if "stale" not in metrics:
                raise ValueError(
                    "StaleReuseController needs a step_fn built with "
                    "make_train_step(..., mask_agg='psum', "
                    "stale_reuse=True): this one returned no "
                    "metrics['stale'] buffer")
            self._stale = metrics.pop("stale")
        if lead:
            with span("controller.observe"):
                self.controller.observe(times, finished)
        self.step += 1
        self.sim_clock += iter_time
        rec = {"step": self.step, "clock": self.sim_clock, "c": c,
               "n": n, "iter_time": iter_time,
               "loss": metrics["loss"]}  # device scalar; drained
        self.history.append(rec)
        self._pending_metrics.append(rec)
        if ring is not None:
            # loss and gnorm are copied on the device, c and iter_time
            # kept on the host: nothing is fetched
            ring.push((metrics["loss"], metrics["gnorm"], float(c),
                       iter_time))
        if self.metrics_every and self.step % self.metrics_every == 0:
            self._drain_metrics()
        if eval_fn and eval_every and self.step % eval_every == 0:
            self._drain_metrics()
            rec["eval"] = float(eval_fn(self.state))
        if verbose and self.step % 20 == 0:
            self._drain_metrics()
            print(f"  step {self.step}: loss={rec['loss']:.4f} "
                  f"c={c}/{n} t={iter_time:.3f}s "
                  f"clock={self.sim_clock:.1f}s")
        plan = self._plan() if self.ckpt_dir else None
        if ((ckpt or plan is not None)
                and self.step % self.ckpt_every == 0):
            state, stale_g = self.state, (self._stale[0] if decay is not None
                                          else None)
            if plan is not None:
                # every rank takes part in the gathers; the lead writes
                lay = shd.layout()
                state = gather_state(state, plan, lay)
                if stale_g is not None:
                    stale_g = collectives.Zero3.of(lay, plan).gather_tree(
                        stale_g, moments=True)
            if ckpt:
                groups = {"state": state,
                          "meta": {"step": self.step,
                                   "clock": self.sim_clock},
                          "ctl": self._controller_ckpt()}
                if decay is not None:
                    groups["stale"] = {"g": stale_g,
                                       "count": self._stale[1]}
                ckpt.save(self.step, groups)
