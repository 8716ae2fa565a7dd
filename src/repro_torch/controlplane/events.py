"""Structured control-plane event stream.

A copy of ``repro.controlplane.events``: the JSONL lines are byte for byte
the reference's, so each package reads the other's logs.

One JSONL line per event, append-only, so benches and dashboards can
*follow a live run* (``tail_events``) and post-mortems can replay it
(``read_events``).  Events carry a monotone ``seq``, the supervisor's
logical ``tick``, a wall-clock stamp, the event ``kind``, an optional
global ``worker`` id, and kind-specific payload fields.

The writer keeps an in-memory list too (``EventLog.events``), so
single-process runs never need a file; multi-process drills give each
worker its own sidecar file and let the supervisor merge (appends of one
short line are atomic enough on POSIX, but we never rely on that — the
reader tolerates a trailing partial line from a crashed writer).

Kinds (the full schema table lives in ``controlplane/README.md``):

  ``heartbeat``      a worker reported in (high-volume; logging optional)
  ``suspect``        deadline half-missed: alive -> suspect
  ``dead``           deadline missed: suspect -> dead (detection!)
  ``rejoin``         a restarted worker re-admitted: dead -> alive
  ``membership``     the active set changed (what Trainer.resize consumes)
  ``restart``        a new worker incarnation launched (attempt k)
  ``restart_failed`` the incarnation died on arrival (flaky restart)
  ``evict``          flap limit hit: worker permanently removed
  ``kill``           supervisor killed a hung-but-live worker
  ``recover``        a worker/chief resumed warm from a checkpoint
  ``fault``          the (seeded) injector fired a fault
  ``decision``       a cutoff decision (optional, high-volume)
  ``run``            run-level marker (start/stop/summary)
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional

EVENT_KINDS = (
    "heartbeat", "suspect", "dead", "rejoin", "membership", "restart",
    "restart_failed", "evict", "kill", "recover", "fault",
    "decision",
    "run",
)


@dataclass(frozen=True)
class Event:
    seq: int
    tick: int
    kind: str
    worker: Optional[int] = None
    wall: float = 0.0
    data: dict = field(default_factory=dict)

    def to_json(self) -> str:
        rec = {"seq": self.seq, "tick": self.tick, "kind": self.kind,
               "wall": round(self.wall, 6)}
        if self.worker is not None:
            rec["worker"] = self.worker
        rec.update(self.data)
        return json.dumps(rec, sort_keys=True)

    @staticmethod
    def from_json(line: str) -> "Event":
        rec = json.loads(line)
        data = {k: v for k, v in rec.items()
                if k not in ("seq", "tick", "kind", "wall", "worker")}
        return Event(seq=int(rec["seq"]), tick=int(rec["tick"]),
                     kind=rec["kind"], worker=rec.get("worker"),
                     wall=float(rec.get("wall", 0.0)), data=data)


class EventLog:
    """Append-only event sink: in-memory list + optional JSONL file.

    ``emit`` assigns a monotone ``seq`` and enforces tick monotonicity —
    the control plane is a single logical clock, and an out-of-order
    tick is a caller's bug the stream's consumers (the drill assertions,
    the bench latency math) must be able to rule out.

    ``KINDS`` is the kind registry ``emit`` validates against.
    Subclasses with their own vocabulary (``obs.trace.ObsLog``) override
    it and inherit the seq/tick/JSONL machinery unchanged; the
    ``event-kind-drift`` lint rule walks every registry it knows about.
    """

    KINDS = EVENT_KINDS

    def __init__(self, path: Optional[str] = None, *,
                 clock: Callable[[], float] = time.time):
        self.path = path
        self.events: List[Event] = []
        self._seq = 0
        self._last_tick: Optional[int] = None
        self._clock = clock
        self._fh = open(path, "a", buffering=1) if path else None

    def emit(self, tick: int, kind: str, worker: Optional[int] = None,
             **data) -> Event:
        kinds = type(self).KINDS
        if kind not in kinds:
            raise ValueError(f"unknown event kind {kind!r} "
                             f"(want one of {kinds})")
        tick = int(tick)
        if self._last_tick is not None and tick < self._last_tick:
            raise ValueError(
                f"event tick went backwards: {tick} after {self._last_tick}"
                f" (the control plane runs on one monotone logical clock)")
        self._last_tick = tick
        ev = Event(seq=self._seq, tick=tick, kind=kind, worker=worker,
                   wall=self._clock(), data=dict(data))
        self._seq += 1
        self.events.append(ev)
        if self._fh is not None:
            self._fh.write(ev.to_json() + "\n")
        return ev

    def of_kind(self, *kinds: str) -> List[Event]:
        return [e for e in self.events if e.kind in kinds]

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path: str) -> List[Event]:
    """Parse a whole JSONL event file; a trailing partial line (crashed
    writer) is ignored, a malformed FULL line raises."""
    out: List[Event] = []
    with open(path) as f:
        content = f.read()
    for i, line in enumerate(content.split("\n")):
        if not line.strip():
            continue
        complete = content.endswith("\n") or i < content.count("\n")
        try:
            out.append(Event.from_json(line))
        except (json.JSONDecodeError, KeyError):
            if complete:
                raise
            # partial trailing line: the writer died mid-append
    return out


def tail_events(path: str, *, poll: float = 0.05,
                stop: Optional[Callable[[], bool]] = None,
                timeout: Optional[float] = None) -> Iterator[Event]:
    """Follow a (possibly still-growing) JSONL event file.

    Yields each complete event exactly once, in file order.  Partial
    lines are buffered until their newline arrives.  Terminates when
    ``stop()`` returns True AND the file is drained, or after
    ``timeout`` seconds without a new event.
    """
    buf = ""
    last_new = time.monotonic()
    # open lazily: the writer may not have created the file yet
    fh = None
    try:
        while True:
            if fh is None:
                if os.path.exists(path):
                    fh = open(path)
                else:
                    time.sleep(poll)
                    if timeout and time.monotonic() - last_new > timeout:
                        return
                    continue
            chunk = fh.read()
            if chunk:
                buf += chunk
                last_new = time.monotonic()
                while "\n" in buf:
                    line, buf = buf.split("\n", 1)
                    if line.strip():
                        yield Event.from_json(line)
                continue
            if stop is not None and stop():
                return
            if timeout and time.monotonic() - last_new > timeout:
                return
            time.sleep(poll)
    finally:
        if fh is not None:
            fh.close()
