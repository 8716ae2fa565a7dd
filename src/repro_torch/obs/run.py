"""ObsRun: one run's telemetry (streams, registry, tracer, recorder).

The port of ``repro.obs.run``.  An ``ObsRun`` is the one object drivers
attach (``Trainer(obs=...)``, ``PSServer(obs=...)``,
``Supervisor(obs=...)``, ``ServeEngine(obs=...)``).  With ``dir=None``
everything stays in memory (callers read ``obs.steps.records``); with a
directory, four JSONL streams are written with the
``controlplane.events`` conventions:

  ``spans.jsonl``      tracer spans            (kind ``span``)
  ``steps.jsonl``      trainer step records    (kind ``step``)
  ``decisions.jsonl``  scored cutoff decisions (kind ``decision``)
  ``metrics.jsonl``    drained device collectors + run markers
                       (kinds ``metrics`` / ``run``)

``drain`` is the only point that reads the device (see
``obs/metrics.py`` and ``obs/quality.py``); drivers call it where they
already fetch (the Trainer's ``metrics_every`` boundary), and ``close``
drains one final time and ends the streams.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.quality import DecisionRecorder, QualityController
from repro_torch.obs.trace import ObsLog, Tracer


class StepStream:
    """The run's step trajectory: ONE recorder shared by every consumer.

    The Trainer forwards each history record here as it drains (the loss
    already a host float), so drivers read ``(clock, loss)`` trajectories
    from ``obs.steps``; ``launch.train.clock_to_loss`` accepts this object
    through its ``records`` attribute."""

    def __init__(self, log: Optional[ObsLog] = None):
        self.records: List[dict] = []
        self._log = log

    def on_step(self, rec: dict, job: Optional[str] = None):
        self.records.append(rec)
        if self._log is not None:
            data = {k: rec[k] for k in
                    ("step", "clock", "c", "n", "iter_time", "loss")
                    if k in rec}
            if job is not None:
                data["job"] = job
            self._log.emit(self._log.autotick(), "step", **data)

    def __len__(self) -> int:
        return len(self.records)

    def losses(self) -> list:
        return [r["loss"] for r in self.records]

    def final_loss(self, window: int = 3) -> float:
        """Mean loss over the last ``window`` steps."""
        if not self.records:
            raise ValueError("step stream is empty")
        return float(np.mean([r["loss"] for r in self.records[-window:]]))

    def total_clock(self) -> float:
        if not self.records:
            raise ValueError("step stream is empty")
        return float(self.records[-1]["clock"])


class ObsRun:
    """Everything one run records; see the module docstring."""

    def __init__(self, dir: Optional[str] = None):
        self.dir = dir
        if dir is not None:
            os.makedirs(dir, exist_ok=True)

        def _log(fname: str) -> ObsLog:
            return ObsLog(os.path.join(dir, fname) if dir else None)

        self._span_log = _log("spans.jsonl")
        self._step_log = _log("steps.jsonl")
        self._dec_log = _log("decisions.jsonl")
        self._meta_log = _log("metrics.jsonl")
        self.trace = Tracer(log=self._span_log)
        self.steps = StepStream(log=self._step_log)
        self.metrics = MetricsRegistry()
        self.decisions = DecisionRecorder(log=self._dec_log)
        self._closed = False
        self._meta_log.emit(self._meta_log.autotick(), "run", phase="start")

    def wrap(self, controller, policy: str = "policy") -> QualityController:
        """Wrap any controller for decision-quality scoring; the wrapped
        controller's decisions are identical to the bare one's."""
        return QualityController(controller, self.decisions, policy)

    def drain(self):
        """Score pending decisions and fetch fresh device collectors: the
        run's ONLY device reads.  Call at metrics boundaries."""
        self.decisions.flush()
        for payload in self.metrics.drain():
            self._meta_log.emit(self._meta_log.autotick(), "metrics",
                                **payload)

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.drain()
        self._meta_log.emit(self._meta_log.autotick(), "run", phase="end",
                            summary=self.metrics.summary())
        for log in (self._span_log, self._step_log, self._dec_log,
                    self._meta_log):
            log.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
