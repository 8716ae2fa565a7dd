"""Seeded, composable fault injection — every drill is reproducible.

A copy of ``repro.controlplane.faults``, over the port's checkpoint store;
the same seed gives the same storm.

A :class:`FaultPlan` is an explicit list of :class:`Fault` records (or a
seeded random "storm"); a :class:`FaultInjector` hands them out by tick
and tracks the stateful budgets (how many restart attempts a flaky
worker still fails).  The injector never touches the cluster itself —
the supervisor's worker pool applies ``crash``/``hang``/``slowdown``,
and ``corrupt_ckpt`` mutates bytes on disk — so the same plan drives
the thread-simulated pool, the subprocess pool, and the no-supervisor
baseline identically.

Fault kinds:

  ``crash``          the worker dies: no process, no heartbeats, and its
                     step never completes (runtime -> STALL) until a
                     restart lands;
  ``hang``           live process, no heartbeats, no progress — the
                     nasty one: the supervisor must KILL it before a
                     restart (a crashed process is already gone);
  ``slowdown``       runtimes multiplied by ``factor`` for ``duration``
                     ticks (heartbeats keep flowing — this is the
                     cutoff controller's job, not the supervisor's);
  ``flaky_restart``  the NEXT ``fails`` restart attempts of ``worker``
                     exit on arrival (drives backoff + the flap limit);
  ``corrupt_ckpt``   flip bytes in the latest checkpoint step's group
                     file (recovery must fall back one step).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

FAULT_KINDS = ("crash", "hang", "slowdown", "flaky_restart",
               "corrupt_ckpt")


@dataclass(frozen=True)
class Fault:
    at: int                      # tick the fault fires
    kind: str
    worker: Optional[int] = None  # None only for corrupt_ckpt
    factor: float = 4.0          # slowdown multiplier
    duration: int = 20           # slowdown ticks
    fails: int = 1               # flaky_restart: failed attempts
    group: Optional[str] = None  # corrupt_ckpt: group file (None: any)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(want one of {FAULT_KINDS})")
        if self.worker is None and self.kind != "corrupt_ckpt":
            raise ValueError(f"{self.kind} fault needs a worker id")


@dataclass
class FaultPlan:
    faults: List[Fault] = field(default_factory=list)

    def __post_init__(self):
        self.faults = sorted(self.faults, key=lambda f: (f.at, f.kind,
                                                         -1 if f.worker is
                                                         None else f.worker))

    def at_tick(self, tick: int) -> List[Fault]:
        return [f for f in self.faults if f.at == tick]

    @property
    def horizon(self) -> int:
        return max((f.at for f in self.faults), default=0)

    @classmethod
    def storm(cls, n_workers: int, n_faults: int, horizon: int, *,
              seed: int = 0,
              kinds: Sequence[str] = ("crash", "hang", "slowdown"),
              min_gap: int = 3) -> "FaultPlan":
        """A seeded random fault storm: ``n_faults`` faults over
        ``horizon`` ticks, at most one per worker (a storm is about
        breadth; stacking two faults on one worker just shadows the
        first), spaced at least ``min_gap`` ticks apart so detection
        windows don't trivially collapse into one membership event."""
        rng = np.random.default_rng(seed)
        if n_faults > n_workers:
            raise ValueError(f"storm wants {n_faults} faults over only "
                             f"{n_workers} workers (one fault per worker)")
        workers = rng.choice(n_workers, size=n_faults, replace=False)
        lo = max(1, horizon - min_gap * n_faults)
        starts = np.sort(rng.integers(1, max(2, lo), size=n_faults))
        starts = starts + np.arange(n_faults) * min_gap
        faults = [
            Fault(at=int(t), kind=str(rng.choice(list(kinds))),
                  worker=int(w),
                  factor=float(rng.uniform(2.0, 6.0)),
                  duration=int(rng.integers(5, 25)))
            for t, w in zip(starts, workers)]
        return cls(faults)


class FaultInjector:
    """Stateful dispenser for one run of a plan.

    ``fire(tick)`` returns the faults due at ``tick`` (each exactly
    once) and arms the flaky-restart budgets; the worker pool asks
    ``restart_should_fail(wid)`` at each restart attempt, which burns
    one unit of budget per call.
    """

    def __init__(self, plan: FaultPlan, *, seed: int = 0):
        self.plan = plan
        self.rng = np.random.default_rng(seed)
        self._fired: set = set()
        self._flaky_budget: Dict[int, int] = {}

    def fire(self, tick: int) -> List[Fault]:
        due = []
        for f in self.plan.at_tick(tick):
            key = (f.at, f.kind, f.worker)
            if key in self._fired:
                continue
            self._fired.add(key)
            if f.kind == "flaky_restart":
                self._flaky_budget[f.worker] = (
                    self._flaky_budget.get(f.worker, 0) + f.fails)
            due.append(f)
        return due

    def restart_should_fail(self, wid: int) -> bool:
        left = self._flaky_budget.get(wid, 0)
        if left > 0:
            self._flaky_budget[wid] = left - 1
            return True
        return False

    # -- checkpoint corruption -----------------------------------------
    def corrupt_checkpoint(self, ckpt_dir: str,
                           group: Optional[str] = None) -> Optional[str]:
        """Flip bytes in the LATEST step's ``<group>.npz`` (seeded
        offsets).  Returns the corrupted path, or None if there is no
        checkpoint to corrupt.  The recovery contract under test: the
        restore path must detect the damage (checksums), name the bad
        group, and fall back to the previous step.
        """
        from repro_torch.checkpoint import store
        step = store.latest_step(ckpt_dir)
        if step is None:
            return None
        d = os.path.join(ckpt_dir, f"step_{step:010d}")
        names = sorted(n for n in os.listdir(d) if n.endswith(".npz"))
        if group is not None:
            names = [n for n in names if n == f"{group}.npz"]
        if not names:
            return None
        path = os.path.join(d, names[int(self.rng.integers(len(names)))])
        size = os.path.getsize(path)
        # reprolint: disable=nonatomic-checkpoint-write -- deliberate corruption: this injector exists to flip bits in published checkpoints so recovery drills exercise the crc32 path
        with open(path, "r+b") as f:
            for _ in range(8):
                off = int(self.rng.integers(0, max(1, size)))
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0xFF]) if b else b"\x00")
        return path
