"""Fault-tolerance walkthrough on the PyTorch port: crash/restart,
permanent node failure, elastic resize and detected failures.

The port's counterpart of ``examples/fault_tolerance_demo.py``:

1. Train with async checkpointing.
2. Simulate a crash; restart from the latest checkpoint (exact resume:
   the step, the simulated clock and the data cursor come back too).
3. Kill one worker permanently: the Elfving cutoff controller routes
   around it within a few steps (the paper's mechanism doubling as fault
   tolerance).
4. Elastic resize mid-run, 8 -> 6 -> 8 workers (``ChurnSim``): the SAME
   trainer keeps stepping across both membership changes, the checkpoint
   records the degraded membership, and a restarted trainer resumes from
   the newest checkpoint.
5. Failures DETECTED, not scripted: a heartbeat supervisor
   (``controlplane``) sees a crash and a hang on an 8-worker run
   (``launch.supervised.default_plan``), shrinks the membership the
   trainer follows, and restarts both workers (one after a flaky
   restart), all through ``run_supervised_trainer``.

It runs on the card (flash attention and the fused AdamW through their
Hopper kernels); the reduced config keeps qwen2-0.5b's head_dim of 64,
the smallest the flash kernel is built for.

  PYTHONPATH=src python examples/torch_fault_tolerance_demo.py

``main(device="cpu")`` runs the same phases on the CPU, through the
kernels' plain versions; the step counts of phases 1-3 and 5 are
arguments.
"""
import dataclasses
import os
import tempfile

import torch

from repro_torch import optim, resolve_device
from repro_torch.checkpoint import store
from repro_torch.cluster.simulator import ChurnEvent, ChurnSim, ClusterSim
from repro_torch.configs.base import get_config
from repro_torch.controlplane import drill_report
from repro_torch.core.controller import ElfvingController
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.supervised import (build_supervised, default_plan,
                                           run_supervised_trainer)
from repro_torch.launch.train import Trainer, make_train_step
from repro_torch.models import model as M

CKPT_EVERY = 10


class FailingCluster(ClusterSim):
    """Worker `dead` becomes a permanent straggler after step `at`."""

    def __init__(self, dead: int, at: int, **kw):
        super().__init__(**kw)
        self.dead, self.at = dead, at

    def step(self):
        t = super().step()
        if self.t >= self.at:
            t[self.dead] = 1e6  # never finishes
        return t


def make_trainer(cfg, n_workers, timer, ckpt_dir, device):
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=24, seed=0)
    opt = optim.adamw(3e-3, fused=True)
    tr = Trainer(step_fn=make_train_step(cfg, opt), data=data,
                 controller=ElfvingController(n_workers, warmup=3),
                 timer=timer, n_workers=n_workers, ckpt_dir=ckpt_dir,
                 ckpt_every=CKPT_EVERY)

    def init_fn():
        params = M.init_model(cfg, torch.Generator().manual_seed(0),
                              device=device)
        return {"params": params, "opt": opt.init(params)}

    return tr.restore_or_init(init_fn)


def main(device=None, train_steps: int = 30, resume_steps: int = 10,
         failure_steps: int = 15, supervised_steps: int = 36):
    """Phases 1-5; ``train_steps`` must be a multiple of the checkpoint
    interval (10) for phase 2 to resume where phase 1 stopped,
    ``failure_steps`` at least 10 (the worker dies at the phase's 6th
    step, and the last 5 steps are checked), and ``supervised_steps`` at
    least 32 (the hung worker's second restart lands at tick 31)."""
    device = resolve_device(device)
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              head_dim=64)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ft_") as root:
        ckpt = os.path.join(root, "run")

        print(f"=== phase 1: train {train_steps} steps with checkpoints ===")
        tr = make_trainer(cfg, 8, ClusterSim(n_workers=8, n_nodes=2, seed=1),
                          ckpt, device)
        tr.run(train_steps, verbose=True)
        loss_before = tr.history[-1]["loss"]

        print("\n=== phase 2: simulated crash; restart from checkpoint ===")
        tr2 = make_trainer(cfg, 8, ClusterSim(n_workers=8, n_nodes=2,
                                              seed=1), ckpt, device)
        print(f"resumed at step {tr2.step} (clock {tr2.sim_clock:.1f}s)")
        assert tr2.step == train_steps, (tr2.step, train_steps)
        tr2.run(resume_steps, verbose=True)
        assert tr2.history[-1]["loss"] < loss_before * 1.5

        print(f"\n=== phase 3: permanent worker failure at step "
              f"{tr2.step + 5} ===")
        tr3 = make_trainer(cfg, 8, FailingCluster(
            dead=3, at=5, n_workers=8, n_nodes=2, seed=1), ckpt, device)
        tr3.run(failure_steps, verbose=True)
        cs = [h["c"] for h in tr3.history[-8:]]
        print(f"cutoffs after failure: {cs} (controller routes around the "
              f"dead worker; iteration time stays bounded)")
        assert max(h["iter_time"] for h in tr3.history[-5:]) < 100

        print("\n=== phase 4: elastic resize 8 -> 6 -> 8 workers, "
              "mid-run ===")
        ckpt = os.path.join(root, "resize")
        churn = ChurnSim(ClusterSim(n_workers=8, n_nodes=2, seed=2),
                         [ChurnEvent(step=6, kill=(6, 7)),
                          ChurnEvent(step=14, restore=(6, 7))])
        tr4 = make_trainer(cfg, 8, churn, ckpt, device)
        tr4.run(20, verbose=True)
        widths = [h["n"] for h in tr4.history]
        print(f"worker counts over the run: {widths}")
        assert 6 in widths and widths[-1] == 8
        # the checkpoint written while degraded carries the 6-wide
        # membership
        grp = store.restore_group(ckpt, "ctl", step=10)
        print(f"step-10 checkpoint membership: n={int(grp['n'])} "
              f"members={grp['members'].tolist()}")
        assert int(grp["n"]) == 6
        tr5 = make_trainer(cfg, 8, ChurnSim(
            ClusterSim(n_workers=8, n_nodes=2, seed=3),
            [ChurnEvent(step=0, kill=(6, 7))]), ckpt, device)
        print(f"restart from the latest checkpoint: step {tr5.step}, "
              f"n_workers {tr5.n_workers}")
        tr5.run(5, verbose=True)

    print("\n=== phase 5: detected (not scripted) failures, supervised ===")
    overlay, sup, timer = build_supervised(8, default_plan(8), seed=4)
    # every transient width (8 full, 7 during a detection window) must
    # divide the global batch
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=56, seed=0)
    opt = optim.adamw(3e-3)
    tr6 = Trainer(step_fn=make_train_step(cfg, opt), data=data,
                  controller=ElfvingController(8, warmup=3), timer=timer,
                  n_workers=8)

    def init6():
        params = M.init_model(cfg, torch.Generator().manual_seed(0),
                              device=device)
        return {"params": params, "opt": opt.init(params)}

    tr6.restore_or_init(init6)
    run_supervised_trainer(tr6, sup, supervised_steps)
    rep = drill_report(sup.log.events)
    for i in rep["incidents"]:
        print(f"  {i['kind']} on worker {i['worker']} at tick "
              f"{i['fault_tick']}: detected +{i['detection_ticks']} "
              f"ticks, rejoined at {i['rejoin_tick']}")
    widths6 = sorted({h["n"] for h in tr6.history})
    print(f"widths ridden off detection alone: {widths6}")
    assert rep["n_detected"] == 2 and rep["max_detection_ticks"] <= 5
    assert widths6 == [7, 8] and tr6.history[-1]["n"] == 8
    print("\nall phases OK")
    return {"phase1": tr.history, "phase2": tr2.history,
            "phase3": tr3.history, "phase4": tr4.history,
            "restart": tr5.history, "phase5": tr6.history,
            "phase5_report": rep}


if __name__ == "__main__":
    main()
