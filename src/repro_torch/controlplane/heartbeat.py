"""Deadline-driven per-worker liveness state machine.

A copy of ``repro.controlplane.heartbeat``.

Each tracked worker is ``alive``, ``suspect``, or ``dead``, judged purely
by ticks since its last heartbeat::

    alive   --[> suspect_after ticks silent]-->  suspect
    suspect --[> dead_after    ticks silent]-->  dead
    suspect --[beat]-->                          alive       (false alarm)
    dead    --[admit()]-->                       alive       (rejoin)

Determinism contract (what the property tests pin):

  * a worker whose last beat was at tick ``b`` is NEVER dead at any tick
    ``t <= b + dead_after`` — and if ``advance`` is called every tick, it
    is declared dead at EXACTLY ``b + dead_after + 1``: detection latency
    is the heartbeat deadline + 1 tick, never more;
  * ``admit`` always re-admits a dead worker (the flap limit lives in the
    supervisor, not here) and restarts its deadline clock;
  * transitions are emitted to the event log in tick order.

A worker that has never beaten since ``admit`` gets ``grace`` extra
silent ticks before deadlines apply — subprocess incarnations pay an
interpreter-startup cost far above the steady-state heartbeat period,
and a monitor without grace would declare every fresh worker dead on
arrival.  ``grace=0`` (default) keeps simulated drills exact.

Membership: ``members()`` is the not-dead tracked set (alive + suspect —
a suspect worker still holds its lease; only a detection removes it),
which is exactly what ``ChurnSim`` would have scripted and what
``Trainer.resize`` / ``ElasticController`` / ``PSServer`` consume
unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.controlplane.events import EventLog

ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"


@dataclass
class WorkerTrack:
    wid: int
    state: str
    last_beat: int          # tick of the last heartbeat (or admit)
    admitted: int           # tick of the last admit
    beaten_since_admit: bool = False


class HeartbeatMonitor:
    def __init__(self, workers, *, suspect_after: int = 2,
                 dead_after: int = 4, grace: int = 0,
                 log: Optional[EventLog] = None,
                 log_heartbeats: bool = False, start_tick: int = 0):
        if not 0 < suspect_after < dead_after:
            raise ValueError(
                f"need 0 < suspect_after < dead_after, got "
                f"{suspect_after} / {dead_after}")
        self.suspect_after = int(suspect_after)
        self.dead_after = int(dead_after)
        self.grace = int(grace)
        self.log = log if log is not None else EventLog()
        self.log_heartbeats = log_heartbeats
        self._tracks: Dict[int, WorkerTrack] = {}
        for w in workers:
            self._tracks[int(w)] = WorkerTrack(
                wid=int(w), state=ALIVE, last_beat=int(start_tick),
                admitted=int(start_tick))

    # -- queries --------------------------------------------------------
    def state(self, wid: int) -> str:
        return self._tracks[wid].state

    def members(self) -> np.ndarray:
        """Global ids currently holding a lease (alive + suspect)."""
        return np.array(sorted(t.wid for t in self._tracks.values()
                               if t.state != DEAD), int)

    def tracked(self) -> np.ndarray:
        return np.array(sorted(self._tracks), int)

    # -- transitions ----------------------------------------------------
    def beat(self, wid: int, tick: int):
        """A heartbeat arrived.  Dead workers' late beats are dropped —
        once detection has fired the membership already shrank, and the
        worker must come back through the supervisor's restart path
        (``admit``), not sneak back in."""
        t = self._tracks[wid]
        if t.state == DEAD:
            return
        t.last_beat = int(tick)
        t.beaten_since_admit = True
        if t.state == SUSPECT:
            t.state = ALIVE
            self.log.emit(tick, "rejoin", wid, false_alarm=True)
        if self.log_heartbeats:
            self.log.emit(tick, "heartbeat", wid)

    def advance(self, tick: int) -> List[Tuple[int, str, str]]:
        """Apply deadlines at ``tick``; returns [(wid, old, new), ...]."""
        tick = int(tick)
        out: List[Tuple[int, str, str]] = []
        for t in sorted(self._tracks.values(), key=lambda x: x.wid):
            if t.state == DEAD:
                continue
            silent = tick - t.last_beat
            dead_line = self.dead_after
            suspect_line = self.suspect_after
            if not t.beaten_since_admit:
                dead_line = max(dead_line, self.grace)
                suspect_line = max(suspect_line, self.grace)
            if silent > dead_line:
                old, t.state = t.state, DEAD
                self.log.emit(tick, "dead", t.wid, last_beat=t.last_beat,
                              silent_ticks=silent)
                out.append((t.wid, old, DEAD))
            elif silent > suspect_line and t.state == ALIVE:
                t.state = SUSPECT
                self.log.emit(tick, "suspect", t.wid,
                              last_beat=t.last_beat, silent_ticks=silent)
                out.append((t.wid, ALIVE, SUSPECT))
        return out

    def admit(self, wid: int, tick: int):
        """(Re-)admit a worker: a completed restart, or a brand-new id.
        Resets the deadline clock; grace applies until its first beat."""
        wid, tick = int(wid), int(tick)
        prev = self._tracks.get(wid)
        self._tracks[wid] = WorkerTrack(wid=wid, state=ALIVE,
                                        last_beat=tick, admitted=tick)
        if prev is not None and prev.state == DEAD:
            self.log.emit(tick, "rejoin", wid)

    def remove(self, wid: int):
        """Stop tracking (permanent eviction — the supervisor logs it)."""
        self._tracks.pop(int(wid), None)
