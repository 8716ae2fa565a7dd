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
  * ``sp_collectives`` — the sequence collectives of ``train_sp`` and
    their gradients, ``sp_attention`` — ``attention_sp`` on each rank's
    columns, ``sp_ring_ce`` — the vocab-ring CE and its gradients,
    ``sp_ssm`` — the SSM cores (the recurrence, the conv, the sLSTM) on
    each rank's columns;
  * ``cutoff_sgd``     — ``launch.cutoff_sgd.train`` on the ranks;
  * ``several``        — several of these in one process group.

Every rank must finish: an error in one rank stops the others and raises
here.  ``init_method`` is a ``file://`` path the ranks share (no port is
taken).
"""
from __future__ import annotations

import os
import pickle
import sys
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
    # the result is written: end here, without the interpreter's teardown,
    # in which a gloo rank has now and then aborted ("terminate called
    # without an active exception") after writing a complete result
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


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
                fsdp_gather="wsc", optimizer="adamw", mode="train_fsdp",
                knobs=None):
    """``train_steps`` under ``make_layout(mesh, mode)`` (``train_fsdp``,
    or ``train_sp``) on a mesh of ``shape`` over ``axes``: the state is
    cut into this rank's shards (``launch.train.shard_state``), each step
    takes this rank's rows of the global batch (over the layout's dp
    axes: under ``train_fsdp`` the whole mesh; under ``train_sp`` the
    ranks of a model axis share their rows, and the forward takes each
    one's columns), the final state is gathered back.  ``optimizer``:
    "adamw" (fused) or "sgd" (plain; at lr 1 a step's parameters change
    by its gradient); ``knobs``: more ``perf.knobs`` (``ce_impl``,
    ``attn_halo``).  Returns (per-step metrics as floats, the final
    params as numpy, {"state_bytes": this rank's resident params, m and v
    in bytes, "collectives": the calls a step made by kind})."""
    from repro_torch import optim
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.train import (_split, gather_state,
                                          make_train_step, shard_state)
    from repro_torch.perf.knobs import use_knobs

    mesh = make_mesh(shape, axes)
    lay = shd.make_layout(mesh, mode)
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
    calls = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0,
             "all_to_all_single": 0, "batch_isend_irecv": 0}
    real = {k: getattr(dist, k) for k in calls}

    def counting(name):
        def call(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return call

    metrics, made = [], []
    with shd.use_layout(lay), use_knobs(fsdp_gather=fsdp_gather,
                                        **(knobs or {})):
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
                  stale_decay=None, n_workers=4, seq=16, batch=8,
                  mode="train_fsdp"):
    """A ``Trainer`` under a ZeRO-3 layout (``mode``: ``train_fsdp`` or
    ``train_sp``) on a mesh of ``shape`` over ``axes`` (``shape=None``:
    the one-process trainer, no layout):
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
    from repro_torch.launch.train import (Trainer, _dp, gather_state,
                                          make_train_step)

    lay = (shd.LOCAL if shape is None
           else shd.make_layout(make_mesh(shape, axes), mode))
    lead = shape is None or _dp(lay).lead
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


def _sp_layout():
    """``train_sp`` on a (1, R) ("data", "model") mesh of every rank:
    (the layout, this rank's index on the model axis)."""
    from repro_torch.dist import sharding as shd

    mesh = make_mesh((1, dist.get_world_size()), ("data", "model"))
    return shd.make_layout(mesh, "train_sp"), mesh.index(("model",))


def _grad_of(fn, inputs, cot):
    """(fn(*inputs), the inputs' gradients for the cotangent ``cot``), as
    numpy; ``inputs`` and ``cot`` are numpy."""
    xs = [torch.from_numpy(np.array(a)).requires_grad_(True)
          for a in inputs]
    y = fn(*xs)
    gs = torch.autograd.grad(y, xs, torch.from_numpy(np.array(cot)))
    return y.detach().numpy(), [g.numpy() for g in gs]


def sp_collectives(data):
    """Each sequence collective of ``dist.collectives`` on this rank's
    piece of ``data`` (numpy, the same on every rank, one cotangent a
    rank; ``tests/test_torch_sp_collectives.py`` builds it) under
    ``train_sp`` on (1, R): {name: (output, [input gradient])}."""
    from repro_torch.dist import collectives as C
    from repro_torch.dist import sharding as shd

    lay, s = _sp_layout()
    T = lay.n_shards
    x = data["x"]
    n = x.shape[1] // T
    mine = x[:, s * n:(s + 1) * n]
    rows = data["w"].shape[0] // T
    runs = {
        "gather": (lambda t: C.seq_gather(t, 1), [mine],
                   data["cot_gather"][s]),
        "act_gather": (lambda t: shd.act(t, "dp", None, None), [mine],
                       data["cot_gather"][s]),
        "act_slice": (lambda t: shd.act(t, "dp", "sp", None, seq="full"),
                      [x], data["cot_gather"][s][:, :n]),
        "ring": (C.ring_shift, [data["blocks"][s]], data["cot_ring"][s]),
        "a2a": (C.all_to_all, [data["a2a"][s]], data["cot_a2a"][s]),
        "vocab": (C.vocab_block, [data["w"][s * rows:(s + 1) * rows]],
                  data["cot_vocab"][s]),
        "sum": (C.model_sum, [data["v"][s]], data["cot_v"][s]),
        "mean": (C.model_mean, [data["v"][s]], data["cot_v"][s]),
    }
    for hops in (1, 2):
        m = min(hops, s)
        runs[f"halo{hops}"] = (lambda t, h=hops: C.halo(t, h, 1), [mine],
                               data[f"cot_halo{hops}"][s][:, :(m + 1) * n])
    out = {}
    with shd.use_layout(lay):
        for name, (fn, inputs, cot) in runs.items():
            out[name] = _grad_of(fn, inputs, cot)
    return out


def sp_attention(cases):
    """``models.attention.attention_sp`` under ``train_sp`` on (1, R): for
    each case (full numpy q (B, S, H, hd), k/v (B, Sk, KV, hd), the
    output's cotangent, ``causal``, ``window``, ``halo``), this rank's
    rows of the output and the gradients of its q, k and v columns, and
    the point-to-point batches the case made."""
    from repro_torch.dist import sharding as shd
    from repro_torch.models.attention import attention_sp
    from repro_torch.perf.knobs import use_knobs

    lay, s = _sp_layout()
    T = lay.n_shards
    out, sends = [], [0]
    real = dist.batch_isend_irecv

    def counted(ops_):
        sends[0] += 1
        return real(ops_)

    for c in cases:
        sends[0] = 0
        q, k, v = c["q"], c["k"], c["v"]
        n, nk = q.shape[1] // T, k.shape[1] // T
        qpos = torch.arange(s * n, (s + 1) * n).expand(q.shape[0], n)

        def fn(ql, kl, vl, c=c, qpos=qpos):
            return attention_sp(ql, kl, vl, qpos, causal=c["causal"],
                                window=c["window"])

        dist.batch_isend_irecv = counted
        try:
            with shd.use_layout(lay), use_knobs(attn_halo=c["halo"]):
                y, g = _grad_of(
                    fn, [q[:, s * n:(s + 1) * n], k[:, s * nk:(s + 1) * nk],
                         v[:, s * nk:(s + 1) * nk]],
                    c["cot"][:, s * n:(s + 1) * n])
        finally:
            dist.batch_isend_irecv = real
        out.append((y, g, sends[0]))
    return out


def sp_ring_ce(cases):
    """``models.model.ring_ce_sum`` under ``train_sp`` on (1, R), the
    parameters full (the vocab block is this rank's slice of the head):
    for each case (cfg, params as numpy, full x (B, S, D), labels (B, S),
    weights (B,) or None), (the sum, this rank's columns' dx, its part of
    the head's gradient, full-shaped)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.models import model as M

    lay, s = _sp_layout()
    T = lay.n_shards
    out = []
    for cfg, params_np, x, labels, weights in cases:
        params = tree.map(lambda a: torch.from_numpy(np.array(a)),
                          params_np)
        head = (params["embed"]["table"] if cfg.tie_embeddings
                else params["lm_head"]["w"]).requires_grad_(True)
        n = x.shape[1] // T
        xl = torch.from_numpy(np.array(x[:, s * n:(s + 1) * n]))
        xl.requires_grad_(True)
        lab = torch.from_numpy(np.array(labels[:, s * n:(s + 1) * n]))
        w = None if weights is None else torch.from_numpy(weights)
        with shd.use_layout(lay):
            loss = M.ring_ce_sum(cfg, params, xl, lab, w)
        dx, dh = torch.autograd.grad(loss, (xl, head))
        out.append((float(loss), dx.numpy(), dh.numpy()))
    return out


def sp_ssm(cases):
    """The SSM cores under ``train_sp`` on (1, R), each on this rank's
    columns of a full numpy case (``tests/test_torch_sp_ssm.py`` builds
    them), forward and backward against one seeded cotangent:

      * ``rec`` / ``rec_ops`` — ``ssm.linear_recurrence`` (the plain
        prefix) / ``kernels.ops.mlstm`` (the kernel's flow; the plain
        version on the CPU) of q, k, v, g, i, ``form`` their options; with
        ``heads`` q and k are (B, S, n) rows broadcast over that many
        heads, as Hymba's Mamba heads take them;
      * ``conv`` — ``ssm.causal_conv1d`` of x with weights w, b;
      * ``slstm`` — ``ssm.slstm_apply`` of x with ``params``.

    Each gives (this rank's output columns, the final state or None, the
    gradients: of each input's columns, then of each weight, this rank's
    part of it)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models import ssm

    lay, s = _sp_layout()
    T = lay.n_shards

    def local(a):
        n = a.shape[1] // T
        return torch.from_numpy(np.array(a[:, s * n:(s + 1) * n]))

    def leaf(a):
        return torch.from_numpy(np.array(a)).requires_grad_(True)

    out = []
    for c in cases:
        kind = c["kind"]
        ins = [local(c[k]).requires_grad_(True) for k in c["cols"]]
        weights = [leaf(c[k]) for k in c.get("weights", ())]
        with shd.use_layout(lay):
            if kind in ("rec", "rec_ops"):
                q, k, v, g, i = ins
                if c.get("heads"):
                    q, k = (t[:, :, None].expand(*t.shape[:2], c["heads"],
                                                 t.shape[-1]) for t in (q, k))
                fn = ssm.linear_recurrence if kind == "rec" else ops.mlstm
                y, final = fn(q, k, v, g, i, **c["form"])
            elif kind == "conv":
                y, final = ssm.causal_conv1d(ins[0], *weights), None
            else:
                params = dict(zip(c["weights"], weights))
                y, final = ssm.slstm_apply(params, ins[0], c["n_heads"])
        outs, cots = [y], [local(c["cot"])]
        # the final state: every rank's loss reads it, the last rank's
        # carries its gradient (the others' are detached)
        for t, a in zip(final or (), c.get("cot_final", ())):
            if t.requires_grad:
                outs.append(t)
                cots.append(torch.from_numpy(np.array(a)))
        grads = torch.autograd.grad(outs, ins + weights, cots)
        out.append((y.detach().numpy(),
                    None if final is None else
                    [t.detach().numpy() for t in final],
                    [g.numpy() for g in grads]))
    return out


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
