"""Metrics registry: the host collectors of ``repro.obs.metrics``.

:class:`Counter`, :class:`Gauge`, :class:`Series` and :class:`LabelSet`
are plain-python bookkeeping (``+=`` on ints), copies of the reference's,
and therefore safe inside reprolint hot roots (``Supervisor.tick``,
``PSServer.flush``): they never touch a device value.
``controlplane.supervisor.drill_report`` aggregates on them.

The device collectors (the metric ring and the histogram, written in
place on the device and read only at a drain) are ROADMAP A.14:
:meth:`MetricsRegistry.ring` and :meth:`MetricsRegistry.histogram` raise.
"""
from __future__ import annotations

from typing import Dict, Sequence


class Counter:
    """Host-side monotone counter (safe in lint hot roots)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, by: int = 1):
        self.value += by


class Gauge:
    """Host-side last-value gauge."""

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v):
        self.value = v


class Series:
    """Host-side value list with summary stats.

    Values are stored as given (ints stay ints), so aggregates like
    ``max`` round-trip bit-identically through JSON — the property
    ``Supervisor.drill_report`` relies on."""

    def __init__(self, name: str):
        self.name = name
        self.values: list = []

    def observe(self, v):
        self.values.append(v)

    @property
    def count(self) -> int:
        return len(self.values)

    def max(self):
        return max(self.values) if self.values else None

    def mean(self):
        return sum(self.values) / len(self.values) if self.values else None


class LabelSet:
    """Host-side set of labels (e.g. evicted worker ids)."""

    def __init__(self, name: str):
        self.name = name
        self._seen: set = set()

    def add(self, label):
        self._seen.add(label)

    def values(self) -> list:
        return sorted(self._seen)


class MetricsRegistry:
    """Get-or-create registry over the host collector kinds."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._series: Dict[str, Series] = {}
        self._labels: Dict[str, LabelSet] = {}

    def ring(self, name: str, columns: Sequence[str], cap: int = 256):
        raise NotImplementedError(
            "device metric rings are not ported yet (ROADMAP A.14: obs/*)")

    def histogram(self, name: str, edges: Sequence[float]):
        raise NotImplementedError(
            "device histograms are not ported yet (ROADMAP A.14: obs/*)")

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def series(self, name: str) -> Series:
        s = self._series.get(name)
        if s is None:
            s = self._series[name] = Series(name)
        return s

    def labels(self, name: str) -> LabelSet:
        lbl = self._labels.get(name)
        if lbl is None:
            lbl = self._labels[name] = LabelSet(name)
        return lbl

    def summary(self) -> dict:
        """Host-only snapshot: counters, gauges, series stats and label
        sets (the reference's keys; ``rings`` stays empty until the
        device collectors are ported)."""
        return {
            "counters": {n: c.value for n, c in self._counters.items()},
            "gauges": {n: g.value for n, g in self._gauges.items()},
            "series": {n: {"count": s.count, "max": s.max(),
                           "mean": s.mean()}
                       for n, s in self._series.items()},
            "labels": {n: lbl.values() for n, lbl in self._labels.items()},
            "rings": {},
        }
