"""Training entry points: the cutoff train step and the ``Trainer``.

The port of ``repro.launch.train`` on one device.  ``make_train_step``
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

The update is the optimizer's: with ``optim.adamw(..., fused=True)`` one
Hopper ``fused_adam`` launch updates every parameter and both moments in
place, the port's counterpart of the JAX step's donated state.

The ``Trainer`` is the host-side loop: controller -> bit array ->
weights (or the bit array itself under ``mask_agg="psum"``), simulated
(or measured) per-worker step times, the stale-gradient buffer, elastic
resize, checkpoint/restart through ``checkpoint.store``, and telemetry
through an optional ``obs.ObsRun``.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import optim, tree
from repro_torch.checkpoint import store
from repro_torch.dist import collectives
from repro_torch.kernels import ops
from repro_torch.models import model as M


# ---------------------------------------------------------------------------
# Train step.
# ---------------------------------------------------------------------------


def make_loss_fn(cfg, aux_coef: float = 0.01):
    """Dense cross-entropy summed over tokens and divided by
    ``normalizer``, plus ``aux_coef`` times the auxiliary loss.  (The ring
    and vocab-chunked CE of the JAX package come with the mesh, ROADMAP
    A.15.)"""
    def loss_fn(params, batch, normalizer):
        logits, _, aux = M.forward(cfg, params, batch, mode="train")
        loss = M._ce_sum_dense(logits, batch["labels"],
                               batch.get("weights")) / normalizer
        return loss + aux_coef * aux, {"ce": loss, "aux": aux}
    return loss_fn


MASK_AGG_MODES = ("weights", "psum")


def _split(batch, parts: int):
    """Split every batch entry into ``parts`` contiguous row blocks."""
    B = batch["tokens"].shape[0]
    if B % parts:
        raise ValueError(f"{B} batch rows do not split into {parts} equal "
                         f"parts")
    n = B // parts
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
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


def _value_and_grad(loss_fn, params, batch, norm):
    """(loss, metrics, grads as a list in ``tree.leaves`` order).  The
    params stay plain tensors: the gradient is taken w.r.t. detached
    aliases of them."""
    flat = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss, metrics = loss_fn(tree.unflatten(params, flat), batch, norm)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg, optimizer: optim.Optimizer, *,
                    grad_accum: int = 1, aux_coef: float = 0.01,
                    compress_pod_grads: bool = False,
                    mask_agg: str = "weights", stale_reuse: bool = False):
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
    psum paths agree where the auxiliary loss is zero (dense and xLSTM
    archs, or aux_coef 0).  For MoE archs they differ on the aux, as the
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
    holders: Dict[int, int] = {}      # id(trainer) -> the width it steps at

    def normalizer_of(batch):
        w = batch.get("weights")
        B, S = batch["tokens"].shape
        if w is None:
            return float(B * S)
        return torch.clamp(torch.sum(w.float()) * S, min=1e-6)

    def accumulate(params, micro, norm, weights, rows):
        """Sum of weight x gradient over the microbatches into the f32
        ``rows`` (the first written, the rest added), and the weighted sums
        of loss, ce and aux.  Weights are the host floats 1.0 or 0.0."""
        loss = ce = aux = 0.0
        for j, (mb, wj) in enumerate(zip(micro, weights)):
            l_mb, metrics, g = _value_and_grad(loss_fn, params, mb, norm)
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

    def grads_of(params, batch):
        norm = normalizer_of(batch)
        if grad_accum == 1:
            return _value_and_grad(loss_fn, params, batch, norm)
        rows = [torch.empty(p.shape, dtype=torch.float32, device=p.device)
                for p in tree.leaves(params)]
        loss, _, aux = accumulate(params, _split(batch, grad_accum), norm,
                                  [1.0] * grad_accum, rows)
        return loss, {"ce": loss, "aux": aux / grad_accum}, rows

    def worker_buffer(params, W):
        # a width that is neither this call's nor held by a trainer
        # (``train_step.hold``) loses its buffer BEFORE a new one is
        # allocated: a single job's resize frees the old width's buffer
        # first, so the two never coexist, while jobs that share this step
        # at different widths keep one buffer each
        keep = set(holders.values()) | {W}
        for k in [k for k in buffers if k[0] not in keep]:
            del buffers[k]
        key = (W, tree.leaves(params)[0].device)
        if key not in buffers:
            buffers[key] = ops.WorkerGrads(params, W)
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

    def psum_grads_of(params, batch, stale_in=None):
        mask = batch["mask"]
        W = mask.shape[0]
        data = {k: v for k, v in batch.items() if k != "mask"}
        B, S = data["tokens"].shape
        base_norm = np.float32((B // W) * S)
        done = torch.round(mask * grad_accum).tolist()
        buf = worker_buffer(params, W)
        losses, ces, auxs = [], [], []
        for w, wbatch in enumerate(_split(data, W)):
            f = np.float32(mask[w].item())
            norm = float(np.maximum(f, np.float32(1.0 / grad_accum))
                         * base_norm)
            # the completed-microbatch prefix: the first round(f G) count
            weights = [1.0 if j < done[w] else 0.0
                       for j in range(grad_accum)]
            loss, ce, aux = accumulate(params, _split(wbatch, grad_accum),
                                       norm, weights, buf.rows[w])
            if grad_accum > 1:
                ce, aux = loss, aux / grad_accum
            losses.append(loss)
            ces.append(ce)
            auxs.append(aux)
        agg = collectives.masked_grad_mean(buf, mask)
        mask_dev = mask.to(buf.buf.device, non_blocking=True)
        c = torch.clamp(torch.sum(mask_dev), min=1.0)
        stale = None
        if stale_in is not None:
            # the dropped workers' mean, buffered by the Trainer for the
            # NEXT step (Dutta et al.); stale reuse is a 0/1-mask policy,
            # so 1 - mask is the dropped bit array
            stale = (collectives.masked_grad_mean(buf, 1.0 - mask),
                     torch.sum(1.0 - mask_dev))
            agg = fold_stale(agg, *stale_in, c)

        def masked_mean(xs):
            return torch.sum(torch.stack(xs) * mask_dev) / c

        return masked_mean(losses), {"ce": masked_mean(ces),
                                     "aux": masked_mean(auxs)}, agg, stale

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
        if mask_agg == "psum":
            loss, metrics, grads, stale = psum_grads_of(params, batch,
                                                        stale_in)
        else:
            loss, metrics, flat = grads_of(params, batch)
            grads = tree.unflatten(params, flat)
        if compress_pod_grads:
            grads, ef = optim.error_feedback_compress(grads,
                                                      state.get("ef"))
        ups, opt = optimizer.update(grads, state["opt"], params)
        params = optim.apply_updates(params, ups)
        new_state = {"params": params, "opt": opt}
        if compress_pod_grads:
            new_state["ef"] = ef
        metrics = dict(metrics, loss=loss, gnorm=optim.global_norm(grads))
        if stale_reuse:
            metrics["stale"] = stale
        return new_state, metrics

    train_step.hold = hold
    train_step.buffers = buffers
    return train_step


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

    @property
    def _stale_decay(self):
        return getattr(self.controller, "stale_decay", None)

    def restore_or_init(self, init_state_fn):
        """Restore from the newest VALID checkpoint, else init cold.

        Steps are tried newest first: a corrupt or truncated step
        (``store.CheckpointError``: bad checksum, missing group, torn
        manifest) is skipped and the previous one is used.  The state is
        restored onto the devices and into the dtypes of
        ``init_state_fn()``'s tree; the controller (and, under stale
        reuse, the stale buffer) from the SAME step.
        """
        if self.members is None:
            self.members = np.arange(self.n_workers)
        steps = (list(reversed(store.list_steps(self.ckpt_dir)))
                 if self.ckpt_dir else [])
        example = init_state_fn()
        for step in steps:
            try:
                want = {"state": example,
                        "meta": {"step": 0, "clock": 0.0}}
                stale = (self._stale_decay is not None and "stale"
                         in store.groups(self.ckpt_dir, step))
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
                self._restore_controller(step)
                return self
            except store.CheckpointError as e:
                print(f"checkpoint step {step} unusable ({e}); "
                      f"falling back to the previous step")
        self.state = example
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
        new width at its next call.
        """
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
            self._stale = (tree.map(torch.zeros_like, params),
                           torch.zeros((), dtype=torch.float32,
                                       device=tree.leaves(params)[0].device))
        stale_g, stale_d = self._stale
        batch["stale_g"] = stale_g
        # decay per worker that contributed to the buffered mean, kept
        # lazy on the device
        batch["stale_w"] = decay * stale_d

    def run(self, n_steps: int, *, eval_fn=None, eval_every: int = 0,
            verbose: bool = False):
        ckpt = (store.AsyncCheckpointer(self.ckpt_dir, self.keep)
                if self.ckpt_dir else None)
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
                                eval_every, verbose)
        self._drain_metrics()
        if ckpt:
            ckpt.wait()
        return self.history

    def _step_once(self, ckpt, hold, span, ring, eval_fn, eval_every,
                   verbose):
        """One step of :meth:`run`: cutoff, bit array, train step, observe,
        and the drains and checkpoints that fall on it."""
        self._sync_membership()
        n = self.n_workers
        if hold is not None and self.mask_agg == "psum":
            hold(self, n)
        with span("controller.predict_cutoff"):
            c = int(self.controller.predict_cutoff())
        c = min(c, n)
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

        batch = dict(self.data.batch(self.step))
        if self.mask_agg == "psum":
            batch["mask"] = contrib
        else:
            batch["weights"] = collectives.example_weights(
                contrib, batch["tokens"].shape[0])
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
        if ckpt and self.step % self.ckpt_every == 0:
            groups = {"state": self.state,
                      "meta": {"step": self.step,
                               "clock": self.sim_clock},
                      "ctl": self._controller_ckpt()}
            if decay is not None:
                groups["stale"] = {"g": self._stale[0],
                                   "count": self._stale[1]}
            ckpt.save(self.step, groups)
