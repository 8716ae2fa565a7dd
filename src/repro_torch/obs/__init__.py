"""Telemetry: the port of ``repro.obs``, the zero-sync telemetry spine.

Device metric rings written in place, host-edge span tracing, and
decision-quality scoring for every cutoff policy; ``ObsRun`` ties them to
four JSONL streams and ``python -m repro_torch.obs`` renders them.  The
reference's ``src/repro/obs/README.md`` holds the contracts (ring drain
rules, span schema, calibration definitions); ``obs/quality.py`` says
where the port's sample snapshot departs from the reference's lazy
handle.
"""
from repro_torch.obs.metrics import (Counter, Gauge, LabelSet,
                                     MetricHistogram, MetricRing,
                                     MetricsRegistry, Series)
from repro_torch.obs.quality import (DecisionRecorder, QualityController,
                                     score_decision)
from repro_torch.obs.run import ObsRun, StepStream
from repro_torch.obs.trace import OBS_KINDS, ObsLog, Tracer, chrome_trace

__all__ = [
    "Counter", "Gauge", "LabelSet", "MetricHistogram", "MetricRing",
    "MetricsRegistry", "Series", "DecisionRecorder", "QualityController",
    "score_decision", "ObsRun", "StepStream", "OBS_KINDS", "ObsLog",
    "Tracer", "chrome_trace",
]
