"""Span tracer + obs event streams (the telemetry wire format).

The port of ``repro.obs.trace``.  ``ObsLog`` subclasses the port's
``controlplane.events.EventLog``: the same append-only JSONL lines, the
same strictly monotone ``seq``, the same torn-tail-tolerant reader
(``controlplane.events.read_events``), with its own kind vocabulary
(``OBS_KINDS``, identical to the reference's: the ``event-kind-drift``
lint rule keys its registries by name).  Obs streams are written by
several components whose logical clocks interleave (three trainers
behind one server, a supervisor beside a trainer), so the event ``tick``
is a per-stream monotone record index (``ObsLog.autotick``) and the
component's clock (SGD step, server tick, job id) travels in the payload.

Spans are host edges only: ``time.perf_counter()`` at enter and exit,
nothing else.  A span around a launch measures the launch (PyTorch
queues the kernels and returns), never adds a synchronize.  Nesting is
lexical (a context manager), the depth is recorded, and
:func:`chrome_trace` renders the stream as Chrome ``chrome://tracing`` /
Perfetto "X" (complete) events with one thread row per ``track``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import List, Optional

from repro_torch.controlplane.events import EventLog

OBS_KINDS = (
    "run",        # run-level marker: start / end + registry summary
    "span",       # one completed tracer span (host perf_counter edges)
    "step",       # one trainer step record (the obs step stream)
    "decision",   # one scored cutoff decision (quality layer)
    "metrics",    # one drained device collector payload
)


class ObsLog(EventLog):
    """An ``EventLog`` speaking the obs vocabulary.

    ``autotick`` hands out the per-stream monotone tick; callers pass it
    straight to ``emit`` so the inherited monotonicity check holds by
    construction while component clocks ride in the payload."""

    KINDS = OBS_KINDS

    def __init__(self, path: Optional[str] = None, *, clock=time.time):
        super().__init__(path, clock=clock)
        self._auto = 0

    def autotick(self) -> int:
        t = self._auto
        self._auto += 1
        return t


class Tracer:
    """Nested spans with tick/step/job attribution.

    ``span`` is a context manager; enter and exit take ``perf_counter``
    stamps on the host and the completed span (name, offset ``ts_us``
    from the tracer's start, ``dur_us``, nesting ``depth``, a ``track``
    for timeline rows, and any attribution kwargs under a nested
    ``attrs`` dict, so component clocks named ``tick``/``step`` never
    collide with the EventLog wire fields) lands in ``self.spans`` and,
    when a log is attached, on the ``spans.jsonl`` stream.
    """

    def __init__(self, log: Optional[ObsLog] = None):
        self._t0 = time.perf_counter()
        self._depth = 0
        self._log = log
        self.spans: List[dict] = []

    @contextmanager
    def span(self, name: str, *, track: str = "main", **attrs):
        self._depth += 1
        depth = self._depth
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._depth -= 1
            rec = {"name": name, "track": track,
                   "ts_us": (t0 - self._t0) * 1e6,
                   "dur_us": (t1 - t0) * 1e6, "depth": depth,
                   "attrs": attrs}
            self.spans.append(rec)
            if self._log is not None:
                self._log.emit(self._log.autotick(), "span", **rec)


def chrome_trace(spans) -> dict:
    """Render span records (dicts or ``Event.data`` payloads) as a
    Chrome-trace / Perfetto JSON document.

    Every span becomes a ``ph: "X"`` complete event; tracks map to
    thread rows (with ``thread_name`` metadata) so the viewer nests spans
    by time containment per track."""
    tracks: dict = {}
    events = []
    for s in spans:
        track = s.get("track", "main")
        tid = tracks.setdefault(track, len(tracks))
        args = dict(s.get("attrs") or {}, depth=s.get("depth", 1))
        events.append({"name": s["name"], "ph": "X", "pid": 0, "tid": tid,
                       "ts": s["ts_us"], "dur": s["dur_us"], "args": args})
    meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
             "args": {"name": track}} for track, tid in tracks.items()]
    # stable render: metadata first, then spans in start order
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}
