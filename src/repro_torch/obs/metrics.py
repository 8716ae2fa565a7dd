"""Metrics registry: device rings that never sync the hot path, and host
collectors.

The port of ``repro.obs.metrics``.  Two halves, split by WHERE the value
lives:

* **Device collectors** (:class:`MetricRing`, :class:`MetricHistogram`)
  accumulate in place.  A value that is a tensor (the step's ``loss``
  straight out of the train step) is written into a preallocated f32
  buffer on its own device by a copy kernel and is never fetched; a
  python or numpy number goes into a host mirror of the same shape, so
  recording it costs no pageable host-to-device copy.  The two halves
  are merged at :meth:`MetricsRegistry.drain`, the ``metrics_every``
  boundary where the Trainer already fetches its losses, and only there.
* **Host collectors** (:class:`Counter`, :class:`Gauge`, :class:`Series`,
  :class:`LabelSet`) are plain-python bookkeeping (``+=`` on ints), copies
  of the reference's, and therefore safe inside reprolint hot roots
  (``Supervisor.tick``, ``PSServer.flush``): they never touch a device
  value.  ``controlplane.supervisor.drill_report`` aggregates on them.

Ring drain contract (the reference's, held by ``tests/test_torch_obs.py``
against it):

* rows come back OLDEST-FIRST, exactly the rows pushed since the last
  drain;
* a ring that overflowed between drains drops the OLDEST rows (it keeps
  the most recent ``cap``) and the payload counts them (``dropped``);
* ``drain`` is the only operation that reads the device buffer.  The head
  (``pushed % cap``) and the push count live on the host, which is how
  ``dropped`` is computed without a sync.

This module imports no other ``repro_torch.obs`` module: the control
plane reaches it while ``obs.trace`` is importing the control plane.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class MetricRing:
    """A (cap, k) f32 ring of metric rows; see the module docstring for
    the drain contract.

    Each cell lives in one of two buffers: the device ring (a tensor
    value, written in place by a copy kernel) or the host mirror (a
    python or numpy number).  ``_on_dev`` records which, per cell, so the
    drain merges them.  The device ring is allocated at the first tensor
    push, on that tensor's device."""

    def __init__(self, name: str, columns: Sequence[str], cap: int = 256):
        if cap < 1:
            raise ValueError(f"ring cap must be >= 1, got {cap}")
        self.name = name
        self.columns = tuple(columns)
        self.cap = int(cap)
        shape = (self.cap, len(self.columns))
        self._host = np.zeros(shape, np.float32)
        self._on_dev = np.zeros(shape, bool)
        self._ring: Optional[torch.Tensor] = None
        self._pushed = 0          # host-side: the head is pushed % cap
        self._drained = 0

    def push(self, vals):
        """Record one row (a tuple matching ``columns``).  Tensor values
        are copied on their device; nothing is fetched."""
        if len(vals) != len(self.columns):
            raise ValueError(f"ring {self.name!r} wants "
                             f"{len(self.columns)} values, got {len(vals)}")
        row = self._pushed % self.cap
        for j, v in enumerate(vals):
            on_dev = isinstance(v, torch.Tensor)
            if on_dev:
                if self._ring is None:
                    self._ring = torch.zeros(self._host.shape,
                                             dtype=torch.float32,
                                             device=v.device)
                with torch.no_grad():
                    self._ring[row, j].copy_(v)
            else:
                self._host[row, j] = v
            self._on_dev[row, j] = on_dev
        self._pushed += 1

    @property
    def pushed(self) -> int:
        return self._pushed

    def drain(self) -> Optional[dict]:
        """Fetch the rows pushed since the last drain (oldest first).

        Returns ``None`` when nothing was pushed.  Overflow drops the
        oldest rows and reports how many (``dropped``)."""
        fresh = self._pushed - self._drained
        if fresh == 0:
            return None
        dropped = max(0, fresh - self.cap)
        take = fresh - dropped
        w = self._host
        if self._on_dev.any():
            w = np.where(self._on_dev, self._ring.cpu().numpy(), w)
        head = self._pushed % self.cap
        rows = np.roll(w, -head, axis=0)[self.cap - take:]
        self._drained = self._pushed
        return {"name": self.name, "columns": list(self.columns),
                "rows": rows.tolist(), "pushed": self._pushed,
                "dropped": dropped}


class MetricHistogram:
    """Fixed-edge f32 histogram (``searchsorted`` left, as
    ``jnp.searchsorted``).  A tensor sample is binned and scatter-added on
    its device; a python number on the host.  The drain adds the two."""

    def __init__(self, name: str, edges: Sequence[float]):
        self.name = name
        self._edges = np.asarray(edges, np.float32)
        self._host = np.zeros(len(self._edges) + 1, np.float32)
        self._dev: Optional[tuple] = None   # (edges, counts, one) tensors
        self._added = 0
        self._drained = 0

    def add(self, x):
        if isinstance(x, torch.Tensor):
            if self._dev is None:
                f32 = dict(dtype=torch.float32, device=x.device)
                self._dev = (torch.tensor(self._edges, **f32),
                             torch.zeros(self._host.shape, **f32),
                             torch.ones(1, **f32))
            edges, counts, one = self._dev
            with torch.no_grad():
                i = torch.searchsorted(edges, x.reshape(1).to(torch.float32))
                counts.index_add_(0, i, one)
        else:
            self._host[np.searchsorted(self._edges, np.float32(x))] += 1.0
        self._added += 1

    def drain(self) -> Optional[dict]:
        if self._added == self._drained:
            return None
        self._drained = self._added
        counts = self._host
        if self._dev is not None:
            counts = counts + self._dev[1].cpu().numpy()
        return {"name": self.name, "edges": self._edges.tolist(),
                "counts": counts.tolist(), "added": self._added}


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
    """Get-or-create registry over every collector kind.

    One registry per :class:`~repro_torch.obs.ObsRun`; the run drains the
    device collectors at ``metrics_every`` boundaries and serializes the
    payloads to the ``metrics.jsonl`` stream."""

    def __init__(self):
        self._rings: Dict[str, MetricRing] = {}
        self._hists: Dict[str, MetricHistogram] = {}
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._series: Dict[str, Series] = {}
        self._labels: Dict[str, LabelSet] = {}

    def ring(self, name: str, columns: Sequence[str],
             cap: int = 256) -> MetricRing:
        r = self._rings.get(name)
        if r is None:
            r = self._rings[name] = MetricRing(name, columns, cap)
        elif r.columns != tuple(columns):
            raise ValueError(f"ring {name!r} re-registered with different "
                             f"columns {tuple(columns)} != {r.columns}")
        return r

    def histogram(self, name: str,
                  edges: Sequence[float]) -> MetricHistogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = MetricHistogram(name, edges)
        return h

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

    def drain(self) -> List[dict]:
        """Fetch every device collector with fresh data (the ONLY reader
        of device buffers: call at metrics boundaries, never per step)."""
        out = []
        for r in self._rings.values():
            p = r.drain()
            if p is not None:
                out.append(dict(p, collector="ring"))
        for h in self._hists.values():
            p = h.drain()
            if p is not None:
                out.append(dict(p, collector="histogram"))
        return out

    def summary(self) -> dict:
        """Host-only snapshot (no device fetch): counters, gauges, series
        stats, label sets, and per-ring push accounting."""
        return {
            "counters": {n: c.value for n, c in self._counters.items()},
            "gauges": {n: g.value for n, g in self._gauges.items()},
            "series": {n: {"count": s.count, "max": s.max(),
                           "mean": s.mean()}
                       for n, s in self._series.items()},
            "labels": {n: lbl.values() for n, lbl in self._labels.items()},
            "rings": {n: {"pushed": r.pushed, "cap": r.cap}
                      for n, r in self._rings.items()},
        }
