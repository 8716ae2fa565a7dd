"""The paper's Fig. 4 loop on the port: a cutoff controller drives the CNN.

The synchronous branch of the reference's
``benchmarks/paper_figures.py:bench_fig4_convergence`` (full sync, the DMM
cutoff, the Elfving order-statistic cutoff): each iteration draws the
workers' runtimes from a simulator, asks the controller for the cutoff c,
charges the simulated clock the c-th fastest runtime, observes the step,
and takes one masked-momentum step on the CNN, each worker's sub-batch
of ``data.pipeline.SyntheticImages`` weighted by its cutoff bit.  The
validation loss is taken every ``eval_every`` steps.  Runs on the device
the params live on.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import optim, tree
from repro_torch.core.cutoff import order_stats
from repro_torch.models.cnn import cnn_loss


def make_cnn_step(opt: optim.Optimizer):
    """step(params, state, x, y, w) -> (params, state, loss): the gradient
    of the weighted CE and one update of ``opt``; the loss stays a device
    scalar."""
    def step(params, state, x, y, w):
        flat = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss = cnn_loss(tree.unflatten(params, flat), x, y, w)
        grads = torch.autograd.grad(loss, flat)
        ups, state = opt.update(tree.unflatten(params, list(grads)), state,
                                params)
        return optim.apply_updates(params, ups), state, loss.detach()
    return step


def run_cnn_cutoff(controller, timer, data, params, opt: optim.Optimizer, *,
                   n_workers: int, steps: int, batch: int,
                   eval_every: int = 10, n_valid: int = 2000) -> dict:
    """``steps`` iterations of cutoff SGD on the CNN (see module
    docstring).  Returns the (clock, validation loss) curve, the cutoffs,
    the per-step training losses (fetched once, at the end), the
    simulated clock, the final params, and each step's wall ms (host
    clock; on the card each step ends in a synchronize)."""
    device = tree.leaves(params)[0].device
    xv, yv = data.valid_set()
    xv = torch.from_numpy(xv[:n_valid]).to(device)
    yv = torch.from_numpy(yv[:n_valid]).to(device)
    per = batch // n_workers
    step = make_cnn_step(opt)
    state = opt.init(params)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    clock, curve, cutoffs, losses, wall_ms = 0.0, [], [], [], []
    for it in range(steps):
        t0 = time.perf_counter()
        times = timer.step()
        c = int(controller.predict_cutoff())
        itime = order_stats.iter_time(times, c)
        finished = times <= itime + 1e-12
        controller.observe(times, finished)
        clock += itime
        xs, ys = zip(*(data.batch(it, per, worker=w)
                       for w in range(n_workers)))
        w = np.repeat(finished.astype(np.float32), per)
        params, state, loss = step(
            params, state, torch.from_numpy(np.concatenate(xs)).to(device),
            torch.from_numpy(np.concatenate(ys)).to(device),
            torch.from_numpy(w).to(device))
        cutoffs.append(c)
        losses.append(loss)
        if (it + 1) % eval_every == 0:
            with torch.no_grad():
                curve.append((clock, float(cnn_loss(params, xv, yv))))
        sync()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    return {"curve": curve, "cutoffs": cutoffs,
            "losses": torch.stack(losses).tolist(), "clock": clock,
            "params": params, "step_wall_ms": wall_ms}
