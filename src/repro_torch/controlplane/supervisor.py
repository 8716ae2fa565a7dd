"""The chief: launch workers, watch heartbeats, kill/restart/evict.

A copy of ``repro.controlplane.supervisor``: on the same seeds and plans
the port's supervisor emits the reference's event stream.  It is numpy
and stdlib only; what it drives (the port's ``Trainer`` through
:class:`SupervisedTimer`) runs on the card.

The :class:`Supervisor` owns one :class:`HeartbeatMonitor` and one
worker pool and advances both on a single logical clock (one ``tick``
per SGD step in simulated drills, one poll interval in subprocess
mode).  Per tick it:

  1. lets the pool apply any due (seeded) faults and deliver the
     heartbeats that actually arrived;
  2. applies the deadlines: a worker that misses ``dead_after`` ticks is
     DEAD — if its process is still alive (a hang) the supervisor KILLS
     it first, then schedules a restart;
  3. launches due restarts with capped exponential backoff + seeded
     jitter (``base * 2^failures``, capped, + U{0..jitter}); an
     incarnation that dies on arrival burns a failure, and a worker
     that fails ``flap_limit`` restarts is evicted permanently;
  4. publishes the new membership (alive + suspect) — the SAME
     global-id set a scripted ``ChurnSim`` would have produced, which
     :class:`SupervisedTimer` feeds into the unchanged
     ``Trainer.resize`` / ``ElasticController`` / ``PSServer`` paths.

Two pools share the protocol (``worker_ids`` / ``pump`` / ``start`` /
``kill`` / ``is_alive_process``):

  * :class:`SimWorkerPool` — logical-clock workers over a
    ``cluster.simulator.OverlaySim``; fully deterministic, tier-1 fast.
  * :class:`ProcWorkerPool` — real OS processes running
    ``python -m repro_torch.controlplane.worker``; heartbeats arrive through
    per-worker sidecar JSONL files, restarts spawn real incarnations
    that recover warm from the ``"ctl"`` checkpoint group by GLOBAL
    worker id.  ``chip_smoke.py``'s ``supervised`` phase sends it one
    kill -9.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from contextlib import nullcontext
from typing import Dict, List, Optional

import numpy as np

from repro_torch.controlplane.events import Event, EventLog
from repro_torch.controlplane.faults import FaultInjector
from repro_torch.controlplane.heartbeat import DEAD, HeartbeatMonitor

#: how long ``ProcWorkerPool.await_beats`` waits for a worker's beat (a
#: fresh incarnation's interpreter start included) before it fails
BEAT_TIMEOUT = 60.0


# ---------------------------------------------------------------------------
# Worker pools.
# ---------------------------------------------------------------------------


class SimWorkerPool:
    """Deterministic thread-free workers on the supervisor's clock.

    Every ``up`` worker heartbeats every tick.  Faults (via a seeded
    :class:`~repro_torch.controlplane.faults.FaultInjector`) flip workers to
    ``crashed`` (no beats, runtime stalled) or ``hung`` (no beats,
    runtime stalled, process still alive — must be killed), or apply a
    bounded ``slowdown`` (beats keep flowing; the cutoff controller owns
    that case).  Runtime effects land on the shared
    :class:`~repro_torch.cluster.simulator.OverlaySim`, so the training loop
    sees exactly the stalls the control plane is reasoning about.
    """

    def __init__(self, overlay, injector: Optional[FaultInjector] = None,
                 *, ckpt_dir: Optional[str] = None):
        self.overlay = overlay
        self.injector = injector
        self.ckpt_dir = ckpt_dir
        self.status: Dict[int, str] = {w: "up" for w
                                       in range(overlay.n_workers)}
        self._slow_until: Dict[int, int] = {}

    def worker_ids(self) -> List[int]:
        return sorted(self.status)

    def healthy_count(self, members) -> int:
        return sum(1 for w in members if self.status[int(w)] == "up")

    def _apply_fault(self, f, tick: int, log: EventLog):
        log.emit(tick, "fault", f.worker, fault=f.kind)
        if f.kind == "crash":
            self.status[f.worker] = "crashed"
            self.overlay.stall(f.worker)
        elif f.kind == "hang":
            self.status[f.worker] = "hung"
            self.overlay.stall(f.worker)
        elif f.kind == "slowdown":
            self.overlay.slow(f.worker, f.factor)
            self._slow_until[f.worker] = tick + f.duration
        elif f.kind == "corrupt_ckpt" and self.ckpt_dir:
            path = self.injector.corrupt_checkpoint(self.ckpt_dir, f.group)
            log.emit(tick, "fault", None, fault="corrupt_ckpt",
                     path=path or "")
        # flaky_restart only arms the injector's budget

    def pump(self, tick: int, monitor: HeartbeatMonitor, log: EventLog):
        if self.injector is not None:
            for f in self.injector.fire(tick):
                self._apply_fault(f, tick, log)
        for w, until in list(self._slow_until.items()):
            if tick >= until:
                self.overlay.slow(w, 1.0)
                del self._slow_until[w]
        for w in self.worker_ids():
            if self.status[w] == "up" and w in monitor._tracks:
                monitor.beat(w, tick)

    def is_alive_process(self, wid: int) -> bool:
        return self.status[wid] == "hung"

    def kill(self, wid: int):
        self.status[wid] = "crashed"
        self.overlay.stall(wid)

    def start(self, wid: int, attempt: int, tick: int,
              log: EventLog) -> bool:
        if (self.injector is not None
                and self.injector.restart_should_fail(wid)):
            return False
        self.status[wid] = "up"
        self.overlay.stall(wid, False)
        self.overlay.slow(wid, 1.0)
        self._slow_until.pop(wid, None)
        if self.ckpt_dir:
            self._emit_recover(wid, tick, log)
        return True

    def _emit_recover(self, wid: int, tick: int, log: EventLog):
        """Warm recovery by GLOBAL worker id: the restarted worker reads
        the ``"ctl"`` checkpoint group and reports which step it resumed
        from and whether its own id was in the saved membership."""
        from repro_torch.checkpoint import store
        try:
            step = store.latest_valid_step(self.ckpt_dir)
            grp = (store.restore_group(self.ckpt_dir, "ctl", step=step)
                   if step is not None else None)
        except Exception:
            grp = None
        if grp is None:
            return
        members = np.asarray(grp["members"], int)
        log.emit(tick, "recover", wid, step=int(grp["step"]),
                 warm=bool(wid in members))


class ProcWorkerPool:
    """Real subprocess workers (``python -m repro_torch.controlplane.worker``).

    Heartbeats and worker-side events arrive through per-worker sidecar
    JSONL files under ``run_dir`` (``hb_<wid>.jsonl`` /
    ``ev_<wid>.jsonl``); ``pump`` reads the new lines each tick, beats
    the monitor once per tick with fresh lines, and re-emits worker
    events (e.g. warm ``recover``) into the supervisor's log.  Faults
    are injected from OUTSIDE (the drill sends a real ``kill -9``,
    drops a hang flag file, or lets the injector fail spawns), so the
    pool only manages lifecycle.
    """

    def __init__(self, n_workers: int, run_dir: str, *,
                 period: float = 0.05,
                 ckpt_dir: Optional[str] = None,
                 injector: Optional[FaultInjector] = None):
        self.n = int(n_workers)
        self.run_dir = run_dir
        self.period = period
        self.ckpt_dir = ckpt_dir
        self.injector = injector
        os.makedirs(run_dir, exist_ok=True)
        self.procs: Dict[int, subprocess.Popen] = {}
        self._offsets: Dict[str, int] = {}

    def worker_ids(self) -> List[int]:
        return list(range(self.n))

    def healthy_count(self, members) -> int:
        return sum(1 for w in members if self.proc_running(int(w)))

    # -- lifecycle ------------------------------------------------------
    def _spawn(self, wid: int, fail: bool = False) -> subprocess.Popen:
        args = [sys.executable, "-m", "repro_torch.controlplane.worker",
                "--wid", str(wid), "--dir", self.run_dir,
                "--period", str(self.period)]
        if self.ckpt_dir:
            args += ["--ckpt", self.ckpt_dir]
        if fail:
            args += ["--fail"]
        env = dict(os.environ)
        src = os.path.join(os.path.dirname(__file__), "..", "..")
        env["PYTHONPATH"] = (os.path.abspath(src)
                             + os.pathsep + env.get("PYTHONPATH", ""))
        p = subprocess.Popen(args, env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
        self.procs[wid] = p
        return p

    def launch_all(self):
        for w in self.worker_ids():
            self._spawn(w)

    def proc_running(self, wid: int) -> bool:
        p = self.procs.get(wid)
        return p is not None and p.poll() is None

    def is_alive_process(self, wid: int) -> bool:
        return self.proc_running(wid)

    def kill(self, wid: int):
        p = self.procs.get(wid)
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()
        # a fresh incarnation must not inherit a stale hang flag
        flag = os.path.join(self.run_dir, f"hang_{wid}")
        if os.path.exists(flag):
            os.remove(flag)

    def start(self, wid: int, attempt: int, tick: int,
              log: EventLog) -> bool:
        fail = (self.injector is not None
                and self.injector.restart_should_fail(wid))
        p = self._spawn(wid, fail=fail)
        if fail:
            # the incarnation exits on arrival; reap it so the failure
            # is a real observed process exit, not an oracle
            rc = p.wait(timeout=60)
            return rc == 0
        return True

    # -- fault hooks for drills ----------------------------------------
    def sigkill(self, wid: int):
        """kill -9 the worker's live incarnation (the drill's crash)."""
        p = self.procs.get(wid)
        if p is not None and p.poll() is None:
            os.kill(p.pid, signal.SIGKILL)
            p.wait()

    def hang(self, wid: int):
        """Drop the hang flag: the worker spins alive but stops beating."""
        with open(os.path.join(self.run_dir, f"hang_{wid}"), "w") as f:
            f.write("hang\n")

    # -- heartbeat plumbing --------------------------------------------
    def await_beats(self, wids):
        """Bounded poll until each worker in ``wids`` has a complete
        heartbeat line the next :meth:`pump` will read.  A drill that
        waits for its live workers' beats before each tick, instead of
        sleeping a wall period, sees the same beats on any host.  Raises
        TimeoutError naming the workers silent for BEAT_TIMEOUT s."""
        deadline = time.monotonic() + BEAT_TIMEOUT
        waiting = {int(w) for w in wids}
        while waiting:
            for w in sorted(waiting):
                path = os.path.join(self.run_dir, f"hb_{w}.jsonl")
                if not os.path.exists(path):
                    continue
                with open(path) as f:
                    f.seek(self._offsets.get(f"hb_{w}.jsonl", 0))
                    if "\n" in f.read():
                        waiting.discard(w)
            if waiting and time.monotonic() > deadline:
                raise TimeoutError(f"workers {sorted(waiting)} sent no "
                                   f"heartbeat within {BEAT_TIMEOUT} s")
            if waiting:
                time.sleep(self.period / 4)

    def _new_lines(self, name: str) -> List[str]:
        path = os.path.join(self.run_dir, name)
        if not os.path.exists(path):
            return []
        pos = self._offsets.get(name, 0)
        with open(path) as f:
            f.seek(pos)
            chunk = f.read()
        nl = chunk.rfind("\n")
        if nl < 0:
            return []
        self._offsets[name] = pos + nl + 1
        return [ln for ln in chunk[:nl].split("\n") if ln.strip()]

    def pump(self, tick: int, monitor: HeartbeatMonitor, log: EventLog):
        for w in self.worker_ids():
            if w in monitor._tracks and self._new_lines(f"hb_{w}.jsonl"):
                monitor.beat(w, tick)
            for ln in self._new_lines(f"ev_{w}.jsonl"):
                ev = Event.from_json(ln)
                log.emit(tick, ev.kind, ev.worker, **ev.data)

    def shutdown(self):
        with open(os.path.join(self.run_dir, "stop"), "w") as f:
            f.write("stop\n")
        for p in self.procs.values():
            if p.poll() is None:
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()


# ---------------------------------------------------------------------------
# The chief.
# ---------------------------------------------------------------------------


class Supervisor:
    """Heartbeat-driven membership + restart policy over a worker pool."""

    def __init__(self, pool, *, suspect_after: int = 2, dead_after: int = 4,
                 grace: int = 0, restart_base: int = 2,
                 restart_cap: int = 16, restart_jitter: int = 0,
                 flap_limit: int = 3, seed: int = 0,
                 log: Optional[EventLog] = None, start_tick: int = 0,
                 obs=None):
        self.pool = pool
        # optional repro_torch.obs.ObsRun: tick spans are host
        # perf_counter edges + host counters only (tick() is a lint hot
        # root, and nothing here ever touches a device value)
        self.obs = obs
        self.log = log if log is not None else EventLog()
        self.monitor = HeartbeatMonitor(
            pool.worker_ids(), suspect_after=suspect_after,
            dead_after=dead_after, grace=grace, log=self.log,
            start_tick=start_tick)
        self.restart_base = int(restart_base)
        self.restart_cap = int(restart_cap)
        self.restart_jitter = int(restart_jitter)
        self.flap_limit = int(flap_limit)
        self._rng = np.random.default_rng(seed)
        self._restarts: Dict[int, dict] = {}
        self.evicted: set = set()
        self._members = self.monitor.members()
        self.log.emit(start_tick, "run", n=len(self._members),
                      phase="start")

    # -- queries --------------------------------------------------------
    def membership(self) -> np.ndarray:
        """Global worker ids currently holding a lease, ascending."""
        return self._members

    # -- the clock ------------------------------------------------------
    def tick(self, tick: int) -> bool:
        """One control-plane step; returns True if membership changed."""
        tick = int(tick)
        span = (self.obs.trace.span("supervisor.tick", track="controlplane",
                                    tick=tick)
                if self.obs is not None else nullcontext())
        with span:
            self.pool.pump(tick, self.monitor, self.log)
            for wid, _old, new in self.monitor.advance(tick):
                if new == DEAD:
                    self._on_dead(wid, tick)
            self._advance_restarts(tick)
            m = self.monitor.members()
            changed = not np.array_equal(m, self._members)
            if changed:
                self.log.emit(tick, "membership", n=len(m),
                              members=[int(w) for w in m])
                self._members = m
            if self.obs is not None:
                self.obs.metrics.counter("supervisor.ticks").inc()
                if changed:
                    self.obs.metrics.counter(
                        "supervisor.membership_changes").inc()
        return changed

    # -- restart policy -------------------------------------------------
    def _backoff(self, failures: int) -> int:
        base = min(self.restart_cap, self.restart_base * 2 ** failures)
        jitter = (int(self._rng.integers(0, self.restart_jitter + 1))
                  if self.restart_jitter else 0)
        return base + jitter

    def _on_dead(self, wid: int, tick: int):
        if self.pool.is_alive_process(wid):
            # a hang: the incarnation is alive but silent — kill it so
            # the restart below doesn't double-run the worker
            self.pool.kill(wid)
            self.log.emit(tick, "kill", wid, reason="hung")
        rec = self._restarts.get(wid, {"attempt": 0, "failures": 0})
        self._schedule(wid, tick, rec)

    def _schedule(self, wid: int, tick: int, rec: dict):
        rec["eta"] = tick + self._backoff(rec["failures"])
        self._restarts[wid] = rec

    def _advance_restarts(self, tick: int):
        for wid in sorted(self._restarts):
            rec = self._restarts[wid]
            if tick < rec["eta"]:
                continue
            rec["attempt"] += 1
            ok = self.pool.start(wid, rec["attempt"], tick, self.log)
            if ok:
                self.log.emit(tick, "restart", wid,
                              attempt=rec["attempt"],
                              failures=rec["failures"])
                self.monitor.admit(wid, tick)
                del self._restarts[wid]
                continue
            rec["failures"] += 1
            self.log.emit(tick, "restart_failed", wid,
                          attempt=rec["attempt"],
                          failures=rec["failures"])
            if rec["failures"] >= self.flap_limit:
                self.monitor.remove(wid)
                self.evicted.add(wid)
                self.log.emit(tick, "evict", wid,
                              failures=rec["failures"])
                del self._restarts[wid]
            else:
                self._schedule(wid, tick, rec)


class SupervisedTimer:
    """ChurnSim-shaped Trainer timer driven by LIVE detection.

    Implements the elastic timer protocol (``n_workers`` /
    ``active_ids`` / ``step``) over the supervisor's current membership
    and the fault overlay's runtimes — the drop-in replacement for a
    scripted ``ChurnSim`` that makes the whole existing elastic path
    (``Trainer._sync_membership`` -> ``resize`` -> controller remap) run
    off detected reality.  Drive ``supervisor.tick(t)`` BEFORE the
    trainer's step ``t`` (the ``ChurnSim`` convention: membership
    changes land before the resized step's runtimes are drawn).
    """

    def __init__(self, overlay, supervisor: Supervisor):
        self.overlay = overlay
        self.sup = supervisor

    @property
    def n_workers(self) -> int:
        return int(self.sup.membership().size)

    @property
    def active_ids(self) -> np.ndarray:
        return self.sup.membership()

    @property
    def t(self) -> int:
        return self.overlay.t

    def step(self) -> np.ndarray:
        row = self.overlay.step()
        return row[self.sup.membership()]


# ---------------------------------------------------------------------------
# Post-mortem: operational stats out of an event stream.
# ---------------------------------------------------------------------------


def drill_report(events) -> dict:
    """Detection/recovery stats from an event list (log or JSONL replay).

    Returns per-incident records and the aggregate the bench gates on:
    ``detection`` (fault tick -> dead tick, in ticks), ``recovery``
    (dead tick -> rejoin tick), ``evictions``, ``restarts`` (incl.
    failed attempts).  Faults that never produce a detection (e.g.
    slowdowns — the cutoff controller's case) are reported with
    ``detected: False``.

    Aggregation runs on the obs metrics registry (host collectors:
    ``Series``/``Counter``/``LabelSet``), which stores values at their
    original types — so the report equals the reference's, key for key
    and value for value.
    """
    faults = [e for e in events
              if e.kind == "fault" and e.worker is not None
              and e.data.get("fault") in ("crash", "hang")]
    deads = [e for e in events if e.kind == "dead"]
    rejoins = [e for e in events
               if e.kind == "rejoin" and not e.data.get("false_alarm")]
    incidents = []
    for f in faults:
        dead = next((d for d in deads
                     if d.worker == f.worker and d.tick >= f.tick), None)
        rej = (next((r for r in rejoins
                     if r.worker == f.worker and r.tick >= dead.tick),
                    None) if dead else None)
        incidents.append({
            "worker": f.worker, "kind": f.data.get("fault"),
            "fault_tick": f.tick, "detected": dead is not None,
            "dead_tick": dead.tick if dead else None,
            "detection_ticks": (dead.tick - f.tick) if dead else None,
            "rejoin_tick": rej.tick if rej else None,
            "recovery_ticks": (rej.tick - dead.tick)
            if (dead and rej) else None,
        })
    # lazy import: obs.trace imports the control plane's event layer
    from repro_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    det = reg.series("detection_ticks")
    rec = reg.series("recovery_ticks")
    for i in incidents:
        if i["detected"]:
            det.observe(i["detection_ticks"])
        if i["recovery_ticks"] is not None:
            rec.observe(i["recovery_ticks"])
    for e in events:
        if e.kind == "restart":
            reg.counter("restarts").inc()
        elif e.kind == "restart_failed":
            reg.counter("failed_restarts").inc()
        elif e.kind == "evict":
            reg.labels("evicted").add(e.worker)
    return {
        "incidents": incidents,
        "n_faults": len(faults),
        "n_detected": det.count,
        "max_detection_ticks": det.max(),
        "mean_detection_ticks": det.mean(),
        "mean_recovery_ticks": rec.mean(),
        "restarts": reg.counter("restarts").value,
        "failed_restarts": reg.counter("failed_restarts").value,
        "evicted": reg.labels("evicted").values(),
    }
