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
                compress=False, stale_decay=None):
    """``make_train_step(cfg, adamw(lr, fused=True), ...)`` under a pure
    data-parallel layout of all ranks, from ``params_np`` (a numpy tree in
    the port's layout) and a fresh optimizer state, over ``batches``: each
    a global numpy batch with its cutoff vector (``weights`` (B,) or
    ``mask`` (W,)), of which this rank takes its rows.  ``stale_decay``
    builds a ``stale_reuse`` step and carries last step's dropped mean as
    the ``Trainer`` does (weight ``decay * count``).  Returns (per-step
    metrics as floats, the final params as numpy)."""
    from repro_torch import optim
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.train import _split, make_train_step

    mesh = make_mesh((dist.get_world_size(),), ("data",))
    lay = shd.Layout(mesh=mesh, mode="train_fsdp", dp=("data",))
    opt = optim.adamw(lr, fused=True)
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
