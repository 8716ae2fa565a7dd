"""Supervised training: live fault detection driving the elastic path.

The port of ``repro.launch.supervised``.  A
:class:`~repro_torch.controlplane.supervisor.Supervisor` watches
heartbeats, turns missed deadlines into the SAME membership changes a
``ChurnSim`` would have scripted, restarts crashed workers with capped
backoff, and the port's ``Trainer.resize`` / controller remap consume the
detected reality unchanged.

Default mode runs a seeded fault storm end to end:

  1. train with a supervisor + fault injector (one crash, one hang with a
     flaky restart, one slowdown); the crash and the hang are DETECTED by
     missed heartbeats — membership shrinks, the controller remaps,
     restarts bring the workers back;
  2. replay the event log as a SCRIPTED run (ChurnSim kills at the
     detection ticks, restores at the rejoin ticks, stalls over the
     undetected windows) and check the two loss trajectories match;
  3. print the drill report (detection latency in ticks, restarts,
     evictions) off the structured event stream.

The model is ``bench_tiny_config()`` with a head_dim of 64 (as in
``launch.elastic``), so on the card its attention runs through the Hopper
flash kernel, forward and recompute backward.  It runs on the card unless
``--device cpu`` is given (no card and no ``--device``: an error).
``--obs-dir`` writes the supervisor's and the supervised trainer's
telemetry streams (``repro_torch.obs``).

  PYTHONPATH=src python -m repro_torch.launch.supervised [--steps N] [--device cpu]
      [--obs-dir DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import optim, resolve_device
from repro_torch.cluster.simulator import (ChurnEvent, ChurnSim, OverlaySim,
                                           paper_cluster_158)
from repro_torch.configs.base import bench_tiny_config
from repro_torch.controlplane.events import EventLog
from repro_torch.controlplane.faults import Fault, FaultInjector, FaultPlan
from repro_torch.controlplane.supervisor import (SimWorkerPool,
                                                 SupervisedTimer, Supervisor,
                                                 drill_report)
from repro_torch.core.controller import ElfvingController
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.train import Trainer, make_train_step
from repro_torch.models import model as M
from repro_torch.obs import ObsRun


# ---------------------------------------------------------------------------
# Wiring: overlay + injector + supervisor + Trainer.
# ---------------------------------------------------------------------------


def build_supervised(n_workers: int, plan: Optional[FaultPlan] = None, *,
                     seed: int = 0, ckpt_dir: Optional[str] = None,
                     event_path: Optional[str] = None,
                     suspect_after: int = 2, dead_after: int = 4,
                     restart_base: int = 2, restart_cap: int = 16,
                     flap_limit: int = 3, obs=None):
    """The supervised stack minus the Trainer: (overlay, supervisor, timer).

    The overlay wraps a fresh paper-cluster sim; the injector (if a plan
    is given) drives the :class:`SimWorkerPool`.  Plug ``timer`` into a
    ``Trainer`` and call ``supervisor.tick(trainer.step)`` before every
    ``run(1)`` — :func:`run_supervised_trainer` does exactly that.
    """
    overlay = OverlaySim(paper_cluster_158(seed + 1, n_workers=n_workers))
    injector = FaultInjector(plan, seed=seed) if plan is not None else None
    pool = SimWorkerPool(overlay, injector, ckpt_dir=ckpt_dir)
    log = EventLog(event_path)
    sup = Supervisor(pool, suspect_after=suspect_after,
                     dead_after=dead_after, restart_base=restart_base,
                     restart_cap=restart_cap, flap_limit=flap_limit,
                     seed=seed, log=log, obs=obs)
    return overlay, sup, SupervisedTimer(overlay, sup)


def run_supervised_trainer(trainer, supervisor: Supervisor,
                           n_steps: int) -> list:
    """Drive trainer + supervisor on one logical clock.

    The supervisor ticks BEFORE each trainer step (the ChurnSim
    convention: membership changes land before the resized step's
    runtimes are drawn), so a worker declared dead at tick t is out of
    the aggregation from step t on.
    """
    for _ in range(n_steps):
        supervisor.tick(trainer.step)
        trainer.run(1)
    return trainer.history


# ---------------------------------------------------------------------------
# Scripted replay: the event log as a ChurnSim + stall schedule.
# ---------------------------------------------------------------------------


class _ScriptedFaults:
    """Replays stall/slow commands at fixed ticks on an OverlaySim —
    the deterministic twin of a supervised run's pool, for replay."""

    def __init__(self, overlay: OverlaySim,
                 commands: Dict[int, List[tuple]]):
        self.overlay = overlay
        self.commands = commands

    @property
    def n_workers(self) -> int:
        return self.overlay.n_workers

    @property
    def t(self) -> int:
        return self.overlay.t

    def step(self) -> np.ndarray:
        for op, wid, arg in self.commands.get(self.overlay.t, ()):
            if op == "stall":
                self.overlay.stall(wid, arg)
            else:
                self.overlay.slow(wid, arg)
        return self.overlay.step()


def scripted_equivalent(events, base) -> ChurnSim:
    """Rebuild a supervised run as a scripted timer from its event log.

    Detection-tick kills, rejoin-tick restores, and the fault/restart
    stall windows become an explicit schedule over a FRESH base sim with
    the same seed — stepping this timer reproduces the supervised run's
    active-set runtime rows column-exactly (the OverlaySim contract),
    which is what makes the equivalence drill a real assertion.
    """
    commands: Dict[int, List[tuple]] = {}

    def at(tick, cmd):
        commands.setdefault(int(tick), []).append(cmd)

    churn: List[ChurnEvent] = []
    for e in events:
        if e.kind == "fault" and e.worker is not None:
            if e.data.get("fault") in ("crash", "hang"):
                at(e.tick, ("stall", e.worker, True))
            elif e.data.get("fault") == "slowdown":
                at(e.tick, ("slow", e.worker, e.data.get("factor", 4.0)))
        elif e.kind == "dead":
            churn.append(ChurnEvent(step=e.tick, kill=(e.worker,)))
        elif e.kind == "restart":
            at(e.tick, ("stall", e.worker, False))
            at(e.tick, ("slow", e.worker, 1.0))
        elif e.kind == "rejoin" and not e.data.get("false_alarm"):
            churn.append(ChurnEvent(step=e.tick, restore=(e.worker,)))
    # slowdown expiry: the sim pool clears the multiplier duration ticks
    # after the fault fired
    for e in events:
        if e.kind == "fault" and e.data.get("fault") == "slowdown":
            at(e.tick + e.data.get("duration", 20),
               ("slow", e.worker, 1.0))
    return ChurnSim(_ScriptedFaults(OverlaySim(base), commands), churn)


# ---------------------------------------------------------------------------
# Default demo / drill.
# ---------------------------------------------------------------------------


def default_plan(n_workers: int, start: int = 12) -> FaultPlan:
    """The acceptance drill's storm: 1 crash, 1 hang (+ a flaky restart
    on the hung worker), 1 slowdown — firing after the Elfving warmup so
    detection windows never overlap a full-sync cutoff."""
    w = list(range(n_workers))
    return FaultPlan([
        Fault(at=start, kind="crash", worker=w[-1]),
        Fault(at=start, kind="flaky_restart", worker=w[-2], fails=1),
        Fault(at=start + 8, kind="hang", worker=w[-2]),
        Fault(at=start + 16, kind="slowdown", worker=w[0], factor=4.0,
              duration=10),
    ])


def proc_crash_drill(run_dir: str) -> dict:
    """One real crash against three subprocess workers
    (``ProcWorkerPool``): a SIGKILL of worker 1 at tick 4, its detection
    and its restart by the supervisor.

    Ticks follow heartbeats, not a wall clock: before each tick the drill
    waits (bounded) for a new beat from every live worker, and the victim
    is killed right after its tick-4 beat landed, so on any host its last
    beat is at tick 4, it is dead at exactly 4 + dead_after (4) + 1 = 9
    and restarted restart_base (2) ticks later.  Returns the events, the
    drill report and the ticks.
    """
    from repro_torch.controlplane.supervisor import ProcWorkerPool
    victim, crash_at, ticks = 1, 4, 13
    pool = ProcWorkerPool(3, run_dir, period=0.02)
    sup = Supervisor(pool, suspect_after=2, dead_after=4, restart_base=2,
                     restart_cap=8, seed=0)
    pool.launch_all()
    try:
        for t in range(1, ticks + 1):
            pool.await_beats([w for w in pool.worker_ids()
                              if pool.proc_running(w)])
            if t == crash_at:
                pool.sigkill(victim)
                sup.log.emit(t, "fault", victim, fault="crash")
            sup.tick(t)
        running = [pool.proc_running(w) for w in pool.worker_ids()]
    finally:
        pool.shutdown()
    events = sup.log.events
    first = lambda kind: next((e.tick for e in events
                               if e.kind == kind and e.worker == victim),
                              None)
    return {"events": events, "report": drill_report(events),
            "crash_tick": crash_at, "dead_tick": first("dead"),
            "restart_tick": first("restart"), "rejoin_tick": first("rejoin"),
            "members": [int(w) for w in sup.membership()],
            "running_at_end": running}


def supervised_config():
    """``bench_tiny_config()`` at head_dim 64: the flash kernel is built
    for head_dims 64 and 128 (the reference's tiny config has 16)."""
    return dataclasses.replace(bench_tiny_config(), head_dim=64)


def run_supervised(steps: int = 60, seed: int = 0, n_workers: int = 6,
                   device=None, verbose: bool = True, obs=None) -> dict:
    """The seeded fault storm, supervised then replayed (module docstring),
    both trainers from the seeded init of ``supervised_config`` on
    ``device``.  ``obs`` instruments the supervisor and the supervised
    trainer, its controller wrapped for decision scoring (not the
    replay)."""
    device = resolve_device(device)
    cfg = supervised_config()
    opt = optim.adamw(3e-3)
    step_fn = make_train_step(cfg, opt)

    def init_fn():
        params = M.init_model(cfg, torch.Generator().manual_seed(seed),
                              device=device)
        return {"params": params, "opt": opt.init(params)}

    def make_trainer(timer):
        # global_batch = lcm(1..6) * 2: every transient width divides it
        data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=8,
                               global_batch=60, seed=seed)
        tr = Trainer(step_fn=step_fn, data=data,
                     controller=ElfvingController(n_workers),
                     timer=timer, n_workers=timer.n_workers)
        return tr.restore_or_init(init_fn)

    plan = default_plan(n_workers)
    if verbose:
        print(f"=== supervised run: {n_workers} workers, seeded storm "
              f"({len(plan.faults)} faults) on {device} ===")
    overlay, sup, timer = build_supervised(n_workers, plan, seed=seed,
                                           obs=obs)
    tr = make_trainer(timer)
    if obs is not None:
        tr.obs = obs
        tr.controller = obs.wrap(tr.controller, policy="elfving")
    run_supervised_trainer(tr, sup, steps)
    report = drill_report(sup.log.events)
    if verbose:
        for i in report["incidents"]:
            print(f"  {i['kind']} on worker {i['worker']} at tick "
                  f"{i['fault_tick']}: detected={i['detected']} "
                  f"(+{i['detection_ticks']} ticks), rejoined at "
                  f"{i['rejoin_tick']}")
        print(f"  restarts={report['restarts']} "
              f"failed={report['failed_restarts']} "
              f"evicted={report['evicted']}")

    if verbose:
        print("=== scripted replay of the detected schedule ===")
    base2 = paper_cluster_158(seed + 1, n_workers=n_workers)
    tr2 = make_trainer(scripted_equivalent(sup.log.events, base2))
    tr2.run(steps)

    losses = np.array([h["loss"] for h in tr.history])
    losses2 = np.array([h["loss"] for h in tr2.history])
    match = bool(np.allclose(losses, losses2, rtol=1e-5, atol=1e-6))
    widths = [h["n"] for h in tr.history]
    if verbose:
        print(f"  widths seen: {sorted(set(widths))}; "
              f"loss trajectories match: {match}")
        print("\nsupervised fault-storm run OK" if match
              else "\nsupervised run DIVERGED from scripted replay")
    return {"history": tr.history, "scripted_history": tr2.history,
            "report": report, "events": sup.log.events, "match": match,
            "widths": widths, "supervisor": sup}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the card")
    ap.add_argument("--obs-dir", default=None,
                    help="write obs telemetry streams (spans/steps/"
                         "decisions/metrics JSONL) under this directory")
    args = ap.parse_args(argv)
    obs = ObsRun(args.obs_dir) if args.obs_dir else None
    out = run_supervised(steps=args.steps, seed=args.seed,
                         n_workers=args.workers, device=args.device, obs=obs)
    if obs is not None:
        obs.close()
        print(f"obs streams -> {args.obs_dir} "
              f"(render: python -m repro_torch.obs {args.obs_dir})")
    return 0 if out["match"] else 1


if __name__ == "__main__":
    sys.exit(main())
