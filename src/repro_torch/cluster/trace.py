"""Trace record/replay — the paper's 'instrument the cluster once' step.

A copy of ``repro.cluster.trace`` (numpy only), so the port never imports
the JAX package.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union

import numpy as np


def save_trace(path: str, times: np.ndarray, meta: Optional[dict] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, times=np.asarray(times, np.float32),
                        **{f"meta_{k}": v for k, v in (meta or {}).items()})


def load_trace(path: str, with_meta: bool = False
               ) -> Union[np.ndarray, Tuple[np.ndarray, dict]]:
    """Load a recorded trace.

    ``with_meta=True`` also returns the ``meta_*`` entries ``save_trace``
    wrote (prefixes stripped, 0-d arrays unwrapped to python scalars) —
    previously these were silently dropped on load.
    """
    with np.load(path) as z:
        times = np.asarray(z["times"], np.float64)
        if not with_meta:
            return times
        meta = {}
        for k in z.files:
            if k.startswith("meta_"):
                v = z[k]
                meta[k[len("meta_"):]] = v.item() if v.ndim == 0 else v
        return times, meta


class TraceReplay:
    """Replays a recorded trace with the ClusterSim interface.

    ``times`` is one (T, n) array, or a list of such segments whose widths
    may differ — the recorded form of a run whose worker set changed
    (``ChurnSim``).  ``n_workers`` always reflects the width of the row the
    NEXT ``step()`` returns.  With ``loop=False`` an exhausted replay
    raises ``IndexError`` (a bare ``StopIteration`` — the old behavior —
    is swallowed silently inside generators and for-loops).
    """

    def __init__(self, times, loop: bool = True):
        if isinstance(times, (list, tuple)):
            segs = [np.asarray(t, np.float64) for t in times]
        else:
            segs = [np.asarray(times, np.float64)]
        if not segs or any(s.ndim != 2 or s.shape[0] == 0 for s in segs):
            raise ValueError("TraceReplay needs non-empty (T, n) segments")
        self.segments: List[np.ndarray] = segs
        # flat view for width-uniform traces (the common, recorded case)
        widths = {s.shape[1] for s in segs}
        self.times = (np.concatenate(segs) if len(widths) == 1 else None)
        self.loop = loop
        self.t = 0          # steps served so far (ClusterSim-compatible)
        self._seg = 0
        self._row = 0

    @property
    def n_workers(self) -> int:
        seg = min(self._seg, len(self.segments) - 1)
        return self.segments[seg].shape[1]

    def step(self) -> np.ndarray:
        if self._seg >= len(self.segments):
            raise IndexError(
                f"TraceReplay exhausted after {self.t} steps (loop=False)")
        seg = self.segments[self._seg]
        out = seg[self._row]
        self._row += 1
        if self._row >= seg.shape[0]:
            self._row = 0
            self._seg += 1
            if self._seg >= len(self.segments) and self.loop:
                self._seg = 0
        self.t += 1
        return out

    def run(self, n_steps: int) -> np.ndarray:
        return np.stack([self.step() for _ in range(n_steps)])
