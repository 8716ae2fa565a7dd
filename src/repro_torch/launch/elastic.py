"""Elastic recovery: survive losing (and regaining) workers.

The port of ``repro.launch.elastic``'s default mode, a SEEDED
degraded-capacity scenario run end to end:

  1. fit the DMM on an 8-worker paper-cluster trace and train with the
     ``ElasticController`` driving cutoffs;
  2. a churn event kills two workers mid-run (``ChurnSim``): the Trainer
     follows the width change, the controller remaps its lag window
     (survivors column-exact), and decisions route through the analytic
     Elfving fallback while the DMM refits at width 6;
  3. the workers return: a second resize back to 8, same protocol;
  4. a checkpoint written mid-churn is restored into a fresh Trainer at
     the degraded width: the controller window comes back warm
     (allclose), straggler prediction does not restart cold;
  5. a full-sync trainer runs the same schedule, and both report the
     simulated clock to the full-sync run's final loss.

The model is ``bench_tiny_config()`` with a head_dim of 64 on every
device: the flash kernel is built for head_dims 64 and 128 (the JAX
demo's tiny config has 16).  It runs on the card unless ``--device cpu``
is given (no card and no ``--device``: an error).  The reference's
``--aot`` mode (compiles on degraded TPU meshes) waits for the mesh
tooling, ROADMAP A.15.5.  ``--obs-dir`` writes the elastic trainer's
telemetry streams (``repro_torch.obs``).

  PYTHONPATH=src python -m repro_torch.launch.elastic [--steps N] [--device cpu]
      [--obs-dir DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile

import numpy as np
import torch

from repro_torch import optim, resolve_device
from repro_torch.checkpoint import store
from repro_torch.cluster.simulator import (ChurnEvent, ChurnSim,
                                           paper_cluster_158)
from repro_torch.configs.base import bench_tiny_config
from repro_torch.core.controller import ElasticController, FullSyncController
from repro_torch.core.runtime_model.api import RuntimeModel
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.dist import sharding as shd
from repro_torch.launch.train import Trainer, clock_to_loss, make_train_step
from repro_torch.models import model as M
from repro_torch.obs import ObsRun


def run_churn_demo(steps: int = 60, seed: int = 0, device=None,
                   obs=None) -> dict:
    """The seeded churn run (module docstring).  The elastic trainer
    records to ``obs`` (or an in-memory ``ObsRun``) as job ``elastic``,
    its controller wrapped for decision scoring; the full-sync baseline
    gets its own in-memory run, so each step stream holds one trajectory
    and ``clock_to_loss`` reads both."""
    device = resolve_device(device)
    cfg = dataclasses.replace(bench_tiny_config(), head_dim=64)
    n = 8
    shrink_at, recover_at = steps // 3, 2 * steps // 3

    print(f"=== fit the DMM on a {n}-worker paper-cluster trace ===")
    trace = paper_cluster_158(seed, n_workers=n).run(120)
    rm = RuntimeModel(n_workers=n, lag=10, device=device).init(seed)
    rm.fit(trace, steps=150, batch=8, seed=seed)

    def make_timer():
        return ChurnSim(paper_cluster_158(seed + 1, n_workers=n),
                        [ChurnEvent(step=shrink_at, kill=(6, 7)),
                         ChurnEvent(step=recover_at, restore=(6, 7))])

    opt = optim.adamw(3e-3, fused=True)
    step_fn = make_train_step(cfg, opt)

    def init_fn():
        params = M.init_model(cfg, torch.Generator().manual_seed(seed),
                              device=device)
        return {"params": params, "opt": opt.init(params)}

    mid = (shrink_at + recover_at) // 2   # a ckpt lands mid-churn

    def make_trainer(ctl, timer, ckpt=None, run_obs=None, name=None):
        data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=8,
                               global_batch=24, seed=seed)
        tr = Trainer(step_fn=step_fn, data=data, controller=ctl, timer=timer,
                     n_workers=timer.n_workers, ckpt_dir=ckpt,
                     ckpt_every=mid, obs=run_obs, name=name)
        return tr.restore_or_init(init_fn)

    obs_el = obs if obs is not None else ObsRun()
    obs_sync = ObsRun()

    with tempfile.TemporaryDirectory(prefix="repro_torch_elastic_") as ckpt:
        print(f"=== churn run: n {n} -> 6 at step {shrink_at}, "
              f"-> {n} at step {recover_at} ===")
        ctl = ElasticController(rm, k_samples=32, seed=seed, refit_steps=60)
        ctl.seed_window(trace[-40:])
        tr = make_trainer(obs_el.wrap(ctl, policy="elastic"), make_timer(),
                          ckpt=ckpt, run_obs=obs_el, name="elastic")
        tr.run(recover_at - 1)            # shrink fires; ckpt at width 6

        print("=== restart from the mid-churn checkpoint ===")
        saved_step = store.latest_step(ckpt)
        saved = store.restore_group(ckpt, "ctl")
        n_saved = int(saved["n"])
        ctl2 = ElasticController(rm, k_samples=32, seed=seed,
                                 refit_steps=60)
        timer2 = make_timer()
        for _ in range(saved_step):      # replay the schedule to the ckpt
            timer2.step()
        tr2 = Trainer(step_fn=step_fn, controller=ctl2,
                      data=SyntheticTokens(vocab_size=cfg.vocab_size,
                                           seq_len=8, global_batch=24,
                                           seed=seed),
                      timer=timer2, n_workers=n, ckpt_dir=ckpt)
        tr2.restore_or_init(init_fn)
        warm = np.allclose(ctl2.window_array(), saved["window"])
        print(f"  resumed at step {tr2.step}, width {tr2.n_workers} "
              f"(ckpt width {n_saved}), controller window warm: {warm}")
        if not (warm and tr2.n_workers == n_saved == 6):
            raise RuntimeError(
                f"the restart came back at width {tr2.n_workers} (ckpt "
                f"{n_saved}), window warm: {warm}")
        tr2.run(3)

        tr.run(steps - tr.step)           # recovery back to 8 workers
    widths = [h["n"] for h in tr.history]
    print(f"  widths seen: {sorted(set(widths))}; "
          f"fallback steps: {ctl.fallback_steps}")
    if not (6 in widths and 8 in widths):
        raise RuntimeError(f"churn did not fire: widths {widths}")

    print("=== full-sync baseline on the identical churn schedule ===")
    sync = make_trainer(FullSyncController(n), make_timer(),
                        run_obs=obs_sync, name="sync")
    sync.run(steps)

    target = sync.obs.steps.final_loss(window=3)
    t_el = clock_to_loss(tr.obs.steps, target)
    t_sync = clock_to_loss(sync.obs.steps, target)
    fmt = lambda v: "n/a" if v is None else f"{v:.1f}s"
    print(f"  simulated clock to sync's final loss: elastic {fmt(t_el)} "
          f"vs full-sync {fmt(t_sync)}")
    print("\nelastic degraded-capacity run OK")
    return {"widths": widths, "t_elastic": t_el, "t_sync": t_sync,
            "resumed_step": int(tr2.step), "resumed_n": int(tr2.n_workers),
            "fallback_steps": ctl.fallback_steps}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--aot", action="store_true",
                    help="the reference's mesh-level compile dry-run "
                         "(not ported: ROADMAP A.15.5)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the card")
    ap.add_argument("--obs-dir", default=None,
                    help="write obs telemetry streams (spans/steps/"
                         "decisions/metrics JSONL) under this directory")
    args = ap.parse_args(argv)
    if args.aot:
        raise NotImplementedError(
            "--aot compiles train_step on degraded TPU meshes; it waits "
            f"for {shd.WAITS_FOR['aot']}")
    obs = ObsRun(args.obs_dir) if args.obs_dir else None
    run_churn_demo(steps=args.steps, seed=args.seed, device=args.device,
                   obs=obs)
    if obs is not None:
        obs.close()
        print(f"obs streams -> {args.obs_dir} "
              f"(render: python -m repro_torch.obs {args.obs_dir})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
