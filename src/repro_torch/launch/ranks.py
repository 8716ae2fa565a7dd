"""Run a function on R local ranks, each a process of one process group.

``spawn(fn, R, *args, init_method=..., **kwargs)`` starts R processes
(the ``spawn`` start method), initializes each one's process group
(``launch.mesh.init_distributed``: gloo on the CPU, NCCL on cards), calls
``fn(*args, **kwargs)`` there and returns the R results in rank order.  ``fn`` must
be importable by name, as a spawned process finds it: the rank programs
below are the port's multi-rank checks, the counterparts of the
reference's ``tests/sharded`` payloads, and run on gloo in the CPU tests:

  * ``masked_means``   — ``masked_psum_mean`` / ``psum_mean`` of each
    rank's block of a seeded per-worker gradient tree on a mesh;
  * ``train_steps``    — a few train steps of ``make_train_step`` under a
    pure data-parallel layout from one numpy state;
  * ``zero3_steps``    — the same steps under a ZeRO-3 layout
    (``train_fsdp`` on a mesh with a model axis), the state sharded;
  * ``zero3_trainer``  — a ZeRO-3 ``Trainer`` run with checkpoints;
  * ``cutoff_sgd``     — ``launch.cutoff_sgd.train`` on the ranks;
  * ``several``        — several of these in one process group.

Every rank must finish: an error in one rank stops the others and raises
here.  ``init_method`` is a ``file://`` path the ranks share (no port is
taken).
"""
from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import tree
from repro_torch.launch.mesh import init_distributed, make_mesh


def _entry(rank, fn, world_size, init_method, device, args, kwargs,
           out_dir):
    torch.set_num_threads(1)
    init_distributed(device, init_method=init_method, rank=rank,
                     world_size=world_size)
    try:
        result = fn(*args, **kwargs)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn, world_size: int, *args, init_method: str, device="cpu",
          **kwargs):
    """``fn(*args, **kwargs)`` on ``world_size`` ranks; the results in rank
    order."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_entry, args=(fn, world_size, init_method, device,
                                         args, kwargs, out_dir),
                           nprocs=world_size, join=True,
                           start_method="spawn")
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _numpy(t):
    return tree.map(lambda x: x.detach().float().cpu().numpy(), t)


# ---------------------------------------------------------------------------
# Rank programs.
# ---------------------------------------------------------------------------


def masked_means(grads, masks, shape=None, axes=("data",),
                 dp_axes=("data",)):
    """Each mask's ``masked_psum_mean`` of this rank's block of ``grads``
    (a numpy tree whose leaves carry the global worker dim W), then
    ``psum_mean``, on a mesh of ``shape`` over ``axes`` (default: all
    ranks on one axis).  Returns numpy trees: ``[masked per mask,
    plain]``."""
    from repro_torch.core import aggregation

    mesh = make_mesh(shape or (dist.get_world_size(),), axes)
    R, r = mesh.size(dp_axes), mesh.index(dp_axes)
    W = tree.leaves(grads)[0].shape[0]
    rows = W // R
    block = tree.map(lambda a: torch.from_numpy(
        np.ascontiguousarray(a[r * rows:(r + 1) * rows])), grads)
    out = [_numpy(aggregation.masked_psum_mean(block, m, mesh, dp_axes))
           for m in masks]
    out.append(_numpy(aggregation.psum_mean(block, mesh, dp_axes)))
    return out


def train_steps(cfg, params_np, batches, mask_agg, lr, *, grad_accum=1,
                compress=False, stale_decay=None, optimizer="adamw"):
    """``make_train_step(cfg, adamw(lr, fused=True), ...)`` under a pure
    data-parallel layout of all ranks, from ``params_np`` (a numpy tree in
    the port's layout) and a fresh optimizer state, over ``batches``: each
    a global numpy batch with its cutoff vector (``weights`` (B,) or
    ``mask`` (W,)), of which this rank takes its rows.  ``stale_decay``
    builds a ``stale_reuse`` step and carries last step's dropped mean as
    the ``Trainer`` does (weight ``decay * count``).  ``optimizer``:
    "adamw" (fused) or "sgd" (plain).  Returns (per-step metrics as
    floats, the final params as numpy)."""
    from repro_torch import optim
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.train import _split, make_train_step

    mesh = make_mesh((dist.get_world_size(),), ("data",))
    lay = shd.Layout(mesh=mesh, mode="train_fsdp", dp=("data",))
    opt = (optim.adamw(lr, fused=True) if optimizer == "adamw"
           else optim.sgd(lr))
    step = make_train_step(cfg, opt, mask_agg=mask_agg,
                           grad_accum=grad_accum,
                           compress_pod_grads=compress,
                           stale_reuse=stale_decay is not None)
    params = tree.map(lambda a: torch.from_numpy(np.array(a)), params_np)
    state = {"params": params, "opt": opt.init(params)}
    stale = (tree.map(torch.zeros_like, params), torch.zeros(()))
    metrics = []
    with shd.use_layout(lay):
        for b in batches:
            cut = {k: b[k] for k in ("weights", "mask") if k in b}
            rows = _split({k: v for k, v in b.items() if k not in cut},
                          mesh.world)[mesh.rank]
            batch = dict(rows, **cut)
            if stale_decay is not None:
                batch.update(stale_g=stale[0], stale_w=stale_decay * stale[1])
            state, m = step(state, batch)
            if stale_decay is not None:
                stale = m.pop("stale")
            metrics.append({k: float(m[k]) for k in ("loss", "ce", "aux",
                                                     "gnorm")})
    return metrics, _numpy(state["params"])


def _state_bytes(state):
    """Bytes of a train state's tensors: params, m, v (and ef)."""
    parts = [state["params"]] + [state["opt"][k] for k in ("m", "v")
                                 if k in state["opt"]]
    if "ef" in state:
        parts.append(state["ef"])
    return sum(x.numel() * x.element_size()
               for t in parts for x in tree.leaves(t))


def zero3_steps(cfg, params_np, batches, mask_agg, lr, shape, axes, *,
                zero1=False, grad_accum=1, compress=False, stale_decay=None,
                fsdp_gather="wsc", optimizer="adamw"):
    """``train_steps`` under ``make_layout(mesh, "train_fsdp")`` on a mesh
    of ``shape`` over ``axes``: the state is cut into this rank's shards
    (``launch.train.shard_state``), each step takes this rank's rows of
    the global batch (the batch over the whole mesh), the final state is
    gathered back.  ``optimizer``: "adamw" (fused) or "sgd" (plain; at
    lr 1 a step's parameters change by its gradient).  Returns (per-step metrics as floats, the final params
    as numpy, {"state_bytes": this rank's resident params, m and v in
    bytes, "collectives": the calls a step made by kind})."""
    from repro_torch import optim
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.train import (_split, gather_state,
                                          make_train_step, shard_state)
    from repro_torch.perf.knobs import use_knobs

    mesh = make_mesh(shape, axes)
    lay = shd.make_layout(mesh, "train_fsdp")
    R, r = mesh.size(lay.dp), mesh.index(lay.dp)
    opt = (optim.adamw(lr, fused=True) if optimizer == "adamw"
           else optim.sgd(lr))
    step = make_train_step(cfg, opt, mask_agg=mask_agg,
                           grad_accum=grad_accum,
                           compress_pod_grads=compress,
                           stale_reuse=stale_decay is not None, zero1=zero1)
    params = tree.map(lambda a: torch.from_numpy(np.array(a)), params_np)
    plan = step.plan_for(lay)
    state = shard_state({"params": params, "opt": opt.init(params)}, plan)
    del params
    resident = _state_bytes(state) if optimizer == "adamw" else None
    calls = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    real = {k: getattr(dist, k) for k in calls}

    def counting(name):
        def call(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return call

    metrics, made = [], []
    with shd.use_layout(lay), use_knobs(fsdp_gather=fsdp_gather):
        stale = (step.zeros_grad(state["params"]), torch.zeros(()))
        for b in batches:
            cut = {k: b[k] for k in ("weights", "mask") if k in b}
            rows = _split({k: v for k, v in b.items() if k not in cut},
                          R)[r]
            batch = dict(rows, **cut)
            if stale_decay is not None:
                batch.update(stale_g=stale[0], stale_w=stale_decay * stale[1])
            before = dict(calls)
            for k in calls:
                setattr(dist, k, counting(k))
            try:
                state, m = step(state, batch)
            finally:
                for k in calls:
                    setattr(dist, k, real[k])
            made.append({k: calls[k] - before[k] for k in calls})
            if stale_decay is not None:
                stale = m.pop("stale")
            metrics.append({k: float(m[k]) for k in ("loss", "ce", "aux",
                                                     "gnorm")})
        full = gather_state(state, plan, lay)
    return metrics, _numpy(full["params"]), {"state_bytes": resident,
                                             "collectives": made}


def zero3_trainer(cfg, params_np, shape, axes, n_steps, ckpt_dir, *,
                  zero1=False, mask_agg="psum", ckpt_every=2,
                  stale_decay=None, n_workers=4, seq=16, batch=8):
    """A ``Trainer`` under a ZeRO-3 layout on a mesh of ``shape`` over
    ``axes`` (``shape=None``: the one-process trainer, no layout):
    first-k (k = ``n_workers`` - 1) over a seeded ``ClusterSim`` on the
    lead rank, stale reuse at ``stale_decay`` when given.  It restores
    from ``ckpt_dir`` when that holds a checkpoint (the timer advanced to
    the restored step), then takes ``n_steps`` steps, checkpointing every
    ``ckpt_every``.  Returns {"losses", "step", "restored": the full
    params right after the restore, "params", "m", "v": the full final
    state} (numpy), gathered on every rank."""
    from repro_torch import optim
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import (FirstKController,
                                             StaleReuseController)
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.train import (Trainer, gather_state,
                                          make_train_step)

    lay = (shd.LOCAL if shape is None
           else shd.make_layout(make_mesh(shape, axes), "train_fsdp"))
    lead = shape is None or lay.mesh.index(lay.dp) == 0
    opt = optim.adamw(3e-3, fused=True)
    step = make_train_step(cfg, opt, mask_agg=mask_agg, zero1=zero1,
                           stale_reuse=stale_decay is not None)
    ctl = timer = None
    if lead:
        ctl = FirstKController(n_workers, backup=1)
        if stale_decay is not None:
            ctl = StaleReuseController(ctl, decay=stale_decay)
        timer = ClusterSim(n_workers=n_workers, n_nodes=2, seed=3)
    data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=0)
    tr = Trainer(step_fn=step, data=data, controller=ctl, timer=timer,
                 n_workers=n_workers, mask_agg=mask_agg, ckpt_dir=ckpt_dir,
                 ckpt_every=ckpt_every, metrics_every=1)

    def full():
        plan = step.plan_for(lay)
        st = tr.state if plan is None else gather_state(tr.state, plan, lay)
        return {"params": _numpy(st["params"]),
                "m": _numpy(st["opt"]["m"]), "v": _numpy(st["opt"]["v"])}

    with shd.use_layout(lay):
        def init():
            p = tree.map(lambda a: torch.from_numpy(np.array(a)),
                         params_np)
            return {"params": p, "opt": opt.init(p)}

        tr.restore_or_init(init)
        if timer is not None:
            for _ in range(tr.step):
                timer.step()
        restored = full()["params"]
        tr.run(n_steps)
        out = full()
    return dict(out, losses=[h["loss"] for h in tr.history], step=tr.step,
                restored=restored)


def cutoff_sgd(argv, cfg=None, fit_steps=300):
    """``launch.cutoff_sgd.train`` on this rank: (the history, the final
    params as numpy)."""
    from repro_torch.launch import cutoff_sgd as cli

    tr = cli.train(cli.parser().parse_args(argv), cfg=cfg,
                   fit_steps=fit_steps)
    return tr.history, _numpy(tr.state["params"])


def several(calls):
    """Several rank programs, one after another, in one process group:
    ``calls`` is a list of ``(fn, args, kwargs)``; returns their results."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]
