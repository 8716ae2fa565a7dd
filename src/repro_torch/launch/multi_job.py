"""Multi-job training launcher: J Trainers through ONE multi-tenant PS.

The port of ``repro.launch.multi_job``.  Builds J seeded training jobs
over disjoint partitions of one simulated cluster
(``cluster.simulator.PartitionedSim``), admits each to a shared
:class:`repro_torch.ps.PSServer`, and runs a scheduler-driven tick loop:
every tick the policy picks which jobs the cluster services, each
serviced job runs one Trainer step (its cutoff fetched lazily from the
batched decision), and ``server.flush()`` launches ONE fused
observe+decide for the whole service set (one graph replay a bucket on
the card).

Per-job elasticity rides the existing protocol end to end: a ChurnEvent
killing workers inside partition p shrinks job p's timer view, its
Trainer resizes through ``JobHandle.resize``, the server degrades that
job to the warm Elfving fallback and refits its DMM from the surviving
window — the other J-1 jobs never leave the batched path.

Every job steps through ONE shared train step, as in the reference; its
psum worker buffers are kept one per width in use
(``launch.train.make_train_step``).  The default model is
``bench_tiny_config()`` with a head_dim of 64 (the flash kernel is built
for head_dims 64 and 128), on the card unless ``device="cpu"``
(``--device cpu``) is given.  ``--obs-dir`` writes the telemetry streams
(``repro_torch.obs``; render them with ``python -m repro_torch.obs``).

  PYTHONPATH=src python -m repro_torch.launch.multi_job [--jobs 3]
      [--ticks 40] [--policy rr|priority|spsf] [--device cpu]
      [--obs-dir DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import optim, resolve_device
from repro_torch.cluster.simulator import (ChurnEvent, PartitionedSim,
                                           paper_cluster_158, partition_ids)
from repro_torch.configs.base import bench_tiny_config
from repro_torch.core.runtime_model.api import RuntimeModel
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.train import Trainer, make_train_step
from repro_torch.models import model as M
from repro_torch.obs import ObsRun
from repro_torch.ps import PSServer, make_scheduler
from repro_torch.ps.scheduler import job_views


@dataclass
class JobRun:
    """One tenant: its Trainer, its server handle, its timer view."""
    job_id: str
    trainer: object
    handle: object
    view: object
    serviced: int = 0


def build_multi_job(n_jobs: int = 3, n_per_job: int = 8, *,
                    seed: int = 0, k_samples: int = 32,
                    fit_steps: int = 120, churn_events=(),
                    priorities=None, global_batch: int = 24,
                    refit_steps: int = 100, refit_fresh: int = 3,
                    refit_async: bool = False, metrics_every: int = 10,
                    obs=None, device=None, cfg=None, seq_len: int = 8,
                    mask_agg: str = "weights"):
    """J seeded Trainers over a partitioned paper cluster, one shared
    PSServer.  Returns (server, jobs dict, sim).

    ``cfg`` (default: the tiny config at head_dim 64), ``seq_len`` and
    ``mask_agg`` shape the jobs' training; every job's params and its
    DMM live on ``device`` (the card unless ``"cpu"``).  ``obs`` (a
    :class:`repro_torch.obs.ObsRun`) instruments the server's flush and
    every Trainer, and wraps each job's handle for decision scoring."""
    device = resolve_device(device)
    n_total = n_jobs * n_per_job
    cfg = cfg or dataclasses.replace(bench_tiny_config(), head_dim=64)
    opt = optim.adamw(3e-3, fused=True)
    # ONE step, shared by every job
    step_fn = make_train_step(cfg, opt, mask_agg=mask_agg)
    base = paper_cluster_158(seed=seed + 1, n_workers=n_total)
    sim = PartitionedSim(base, partition_ids(n_total, n_jobs),
                         events=list(churn_events))
    server = PSServer(refit_steps=refit_steps, refit_fresh=refit_fresh,
                      refit_async=refit_async, obs=obs)
    jobs: Dict[str, JobRun] = {}
    for j in range(n_jobs):
        job_id = f"job{j}"
        ids = sim.partitions[j]
        # per-job DMM fit on a seeded same-phenomenology trace at the
        # partition width (the per-job instrumentation run)
        trace = paper_cluster_158(seed=seed + 10 + j,
                                  n_workers=n_per_job).run(
            max(40, fit_steps // 3))
        rm = RuntimeModel(n_workers=n_per_job, lag=10,
                          device=device).init(seed + j)
        rm.fit(trace, steps=fit_steps, batch=8, seed=seed + j)
        handle = server.admit(
            job_id, rm, window=trace[-(rm.lag + 1):], members=ids,
            priority=(priorities[j] if priorities is not None else 0.0),
            k_samples=k_samples, seed=seed + 100 * j)
        view = sim.view(j)
        data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=seq_len,
                               global_batch=global_batch, seed=seed + j)
        ctl = obs.wrap(handle, policy=job_id) if obs is not None else handle
        tr = Trainer(step_fn=step_fn, data=data, controller=ctl,
                     timer=view, n_workers=n_per_job, mask_agg=mask_agg,
                     members=ids, metrics_every=metrics_every, obs=obs,
                     name=job_id)

        def init_fn(jj=j):
            params = M.init_model(cfg, torch.Generator().manual_seed(
                seed + jj), device=device)
            return {"params": params, "opt": opt.init(params)}

        tr.restore_or_init(init_fn)
        jobs[job_id] = JobRun(job_id=job_id, trainer=tr, handle=handle,
                              view=view)
    return server, jobs, sim


def run_ticks(server, jobs: Dict[str, JobRun], scheduler, ticks: int, *,
              capacity: Optional[int] = None, verbose: bool = False):
    """The multi-tenant hot loop: schedule -> prefetch -> serve -> flush.

    Returns per-tick service lists plus aggregate counters."""
    schedule_log: List[List[str]] = []
    serviced = {job_id: 0 for job_id in jobs}
    d0 = server.dispatches
    obs = getattr(server, "obs", None)
    for tick in range(ticks):
        span = (obs.trace.span("multi_job.tick", track="driver", tick=tick)
                if obs is not None else nullcontext())
        with span:
            order = scheduler.order(job_views(server), capacity)
            server.prefetch(order)
            for job_id in order:
                jobs[job_id].trainer.run(1)
                jobs[job_id].serviced += 1
                serviced[job_id] += 1
            server.flush()
        schedule_log.append(order)
        if verbose and (tick + 1) % 10 == 0:
            modes = {j.job_id: j.handle.mode for j in jobs.values()}
            print(f"  tick {tick + 1}: serviced={order} modes={modes}")
    if obs is not None:
        obs.drain()
    return {"schedule": schedule_log,
            "dispatches": server.dispatches - d0,
            "serviced": serviced}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--workers-per-job", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--capacity", type=int, default=None,
                    help="jobs serviced per tick (default: all)")
    ap.add_argument("--policy", default="rr",
                    choices=["rr", "priority", "spsf"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the card")
    ap.add_argument("--obs-dir", default=None,
                    help="write obs telemetry streams (spans/steps/"
                         "decisions/metrics JSONL) under this directory")
    args = ap.parse_args(argv)

    kill_at = args.ticks // 3
    back_at = 2 * args.ticks // 3
    # kill two workers of job1's partition mid-run, restore later
    victim = [args.workers_per_job + 0, args.workers_per_job + 1]
    events = [ChurnEvent(step=kill_at, kill=tuple(victim)),
              ChurnEvent(step=back_at, restore=tuple(victim))]
    print(f"=== building {args.jobs} jobs x {args.workers_per_job} workers, "
          f"churn kills {victim} at tick {kill_at} ===")
    obs = ObsRun(args.obs_dir) if args.obs_dir else None
    server, jobs, _ = build_multi_job(
        args.jobs, args.workers_per_job, seed=args.seed,
        churn_events=events if args.jobs > 1 else (), device=args.device,
        obs=obs)
    sched = make_scheduler(args.policy)
    out = run_ticks(server, jobs, sched, args.ticks,
                    capacity=args.capacity, verbose=True)
    if obs is not None:
        obs.close()
        print(f"obs streams -> {args.obs_dir} "
              f"(render: python -m repro_torch.obs {args.obs_dir})")
    print(f"=== {args.ticks} ticks, {out['dispatches']} fused dispatches "
          f"({out['dispatches'] / max(1, args.ticks):.2f}/tick) ===")
    for job_id, run in jobs.items():
        hist = run.trainer.history
        losses = [h["loss"] for h in hist[-3:]]
        print(f"  {job_id}: serviced={run.serviced} steps={len(hist)} "
              f"width={run.handle.n} mode={run.handle.mode} "
              f"last3loss={np.mean(losses):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
