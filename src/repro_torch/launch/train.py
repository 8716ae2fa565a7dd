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
    (fractional) contributions on the psum path.

The update is the optimizer's: with ``optim.adamw(..., fused=True)`` one
Hopper ``fused_adam`` launch updates every parameter and both moments in
place, the port's counterpart of the JAX step's donated state.

The ``Trainer`` is the host-side loop: controller -> bit array ->
weights (or the bit array itself under ``mask_agg="psum"``), simulated
(or measured) per-worker step times, and elastic resize.  Checkpoints,
telemetry, stale-gradient reuse and pod-gradient compression are not
ported yet (ROADMAP A.9, A.14).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import optim, tree
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

    state = {"params", "opt"}; batch holds numpy arrays (``tokens``,
    ``labels``, ``positions`` and ``weights`` or ``mask``) and goes to the
    params' device.

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
    buffer (``kernels.ops.WorkerGrads``, built at the first step).  ONE
    masked mean weighted by f then combines the rows: the JAX step's
    concatenate-then-combine result without the concatenation copy.  With
    a 0/1 vector every weight is exactly 1.0 or 0.0, and the weights and
    psum paths agree (dense archs).
    """
    if mask_agg not in MASK_AGG_MODES:
        raise ValueError(f"unknown mask_agg {mask_agg!r} "
                         f"(want one of {MASK_AGG_MODES})")
    if stale_reuse:
        raise NotImplementedError(
            "stale_reuse is not ported yet (ROADMAP A.9: the stale-gradient "
            "fold comes with the rest of the straggler policies)")
    if compress_pod_grads:
        raise NotImplementedError(
            "compress_pod_grads is not ported yet (ROADMAP A.9: "
            "optim/compression.py comes with the cross-pod all-reduce)")
    loss_fn = make_loss_fn(cfg, aux_coef)
    buffers: Dict[Any, ops.WorkerGrads] = {}

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
        key = (W, tree.leaves(params)[0].device)
        if key not in buffers:
            buffers.clear()   # a resize: the old width's buffer goes
            buffers[key] = ops.WorkerGrads(params, W)
        return buffers[key]

    def psum_grads_of(params, batch):
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

        def masked_mean(xs):
            return torch.sum(torch.stack(xs) * mask_dev) / c

        return masked_mean(losses), {"ce": masked_mean(ces),
                                     "aux": masked_mean(auxs)}, agg

    def train_step(state, batch):
        params = state["params"]
        batch = _device_batch(batch, tree.leaves(params)[0].device)
        if mask_agg == "psum":
            loss, metrics, grads = psum_grads_of(params, batch)
        else:
            loss, metrics, flat = grads_of(params, batch)
            grads = tree.unflatten(params, flat)
        ups, opt = optimizer.update(grads, state["opt"], params)
        params = optim.apply_updates(params, ups)
        metrics = dict(metrics, loss=loss, gnorm=optim.global_norm(grads))
        return {"params": params, "opt": opt}, metrics

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
    """Cutoff-SGD trainer: controller + masked aggregation.

    ``n_workers`` virtual workers share one device.  ``timer`` provides
    per-worker step times each iteration: a ``ClusterSim`` / ``TraceReplay``,
    or per-host measurements.  ``mask_agg`` must match the
    ``make_train_step`` the ``step_fn`` was built with.

    The hot loop launches the train step (PyTorch queues its kernels on
    the card and returns) BEFORE the controller's ``observe`` runs, so the
    parameter server's bookkeeping overlaps the device's gradient work.
    Per-step losses stay device tensors and are fetched together every
    ``metrics_every`` steps and at the end of :meth:`run`;
    ``metrics_every=0`` drains only at the end.

    Elastic membership: when the timer exposes ``n_workers`` /
    ``active_ids``, the loop follows the worker set before each step
    (:meth:`resize`).  ``ckpt_dir`` and ``obs`` raise until the checkpoint
    store and telemetry are ported (ROADMAP A.9, A.14).
    """
    step_fn: Callable
    data: Any
    controller: Any
    timer: Any = None
    n_workers: int = 8
    mask_agg: str = "weights"
    ckpt_dir: Optional[str] = None
    metrics_every: int = 10
    obs: Any = None

    state: Dict = None
    step: int = 0
    sim_clock: float = 0.0
    members: Optional[np.ndarray] = None      # global worker ids
    history: list = field(default_factory=list)
    _pending_metrics: list = field(default_factory=list, repr=False)

    def __post_init__(self):
        if self.ckpt_dir is not None:
            raise NotImplementedError(
                "checkpoints are not ported yet (ROADMAP A.9: "
                "checkpoint/store.py and the 'ctl' group)")
        if self.obs is not None:
            raise NotImplementedError(
                "telemetry is not ported yet (ROADMAP A.14: obs/*)")

    def restore_or_init(self, init_state_fn):
        """Init cold (there is no checkpoint store yet)."""
        if self.members is None:
            self.members = np.arange(self.n_workers)
        self.state = init_state_fn()
        return self

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
        """Fetch every pending device-side loss into its history record:
        one copy to the host for all of them."""
        if not self._pending_metrics:
            return
        losses = torch.stack([rec["loss"] for rec in self._pending_metrics])
        for rec, loss in zip(self._pending_metrics, losses.tolist()):
            rec["loss"] = loss
        self._pending_metrics.clear()

    def run(self, n_steps: int):
        if getattr(self.controller, "stale_decay", None) is not None:
            raise NotImplementedError(
                "stale-gradient reuse is not ported yet (ROADMAP A.9)")
        for _ in range(n_steps):
            self._sync_membership()
            n = self.n_workers
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

            batch = dict(self.data.batch(self.step))
            if self.mask_agg == "psum":
                batch["mask"] = contrib
            else:
                batch["weights"] = collectives.example_weights(
                    contrib, batch["tokens"].shape[0])
            # launch the train step FIRST, then the PS's observe, so the
            # controller's work overlaps the device's
            self.state, metrics = self.step_fn(self.state, batch)
            self.controller.observe(times, finished)
            self.step += 1
            self.sim_clock += iter_time
            rec = {"step": self.step, "clock": self.sim_clock, "c": c,
                   "n": n, "iter_time": iter_time,
                   "loss": metrics["loss"]}  # device scalar; drained
            self.history.append(rec)
            self._pending_metrics.append(rec)
            if self.metrics_every and self.step % self.metrics_every == 0:
                self._drain_metrics()
        self._drain_metrics()
        return self.history
