"""Decision-quality layer: score every cutoff decision against hindsight.

The port of ``repro.obs.quality``.  ``QualityController`` rides the
straggler-policy wrappers' delegation protocol
(``core.controller._PolicyWrapper``), so any policy (dmm, sync, static,
firstk, anytime, stale, a server's job handle) can be wrapped and reports
the same record schema.  On the hot path it only buffers: the cutoff
just decided, the realized times row, and a copy of the predictive
sample cloud the inner controller already drew.  All arithmetic happens
at drain time (:meth:`DecisionRecorder.flush`), where the sample clouds
come to the host in one copy beside the Trainer's own metric fetch.

The copy is where the port departs from the reference.  The reference
keeps a lazy handle (``predicted_samples``): a JAX decision returns a
fresh array, so the handle stays valid.  The port's controllers write
their samples IN PLACE (the device state's ``samples``, a bucket's
output block), so a handle read at drain would score every decision of
a ``metrics_every`` window with the last one's samples, and on the card
would race the next decision's replay.  So the wrapper asks the inner
controller for ``snapshot_samples()`` (``core.controller.snapshot``): a
device-to-device copy issued on the stream that produced the samples,
which orders the next replay there after it, with an event that orders
the drain's read after the copy.

Per-decision record (``decisions.jsonl``, kind ``decision``):

======================= ====================================================
``policy, step, n``     attribution
``c``                   the cutoff actually used (mask popcount)
``iter_time``           realized x_(c): the slowest included worker
``oracle_c``            hindsight-optimal cutoff (``order_stats.oracle_cutoff``)
``regret``              relative throughput regret vs the oracle, in [0, 1]
``idle_frac``           included workers' wait for x_(c), as a fraction of
                        the c * x_(c) worker-seconds the step paid for
``discard_frac``        1 - (sum of contributions) / n: what the straggler
                        policy threw away (0 under full sync; partial under
                        anytime, which contributes microbatch fractions)
``pred_iter``           E[x_(c)] under the predictive samples (None for
                        sample-less policies: sync / static / firstk)
``residual``            pred_iter - iter_time (None without samples)
``cov50, cov90``        realized x_(c) inside the empirical 50% / 90%
                        predictive interval of x_(c) (None without samples)
======================= ====================================================
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.controller import _PolicyWrapper
from repro_torch.core.cutoff import order_stats
from repro_torch.obs.trace import ObsLog

_EPS = 1e-12


def score_decision(entry: dict) -> dict:
    """Score one buffered decision; ``entry["samples"]`` must already be
    host-resident (``DecisionRecorder.flush`` batches the fetch)."""
    times = np.asarray(entry["times"], np.float64)
    mask = np.asarray(entry["mask"], bool)
    n = int(times.shape[0])
    c_used = int(mask.sum())
    iter_time = float(times[mask].max())
    contrib_fn = entry.get("contrib_fn")
    if contrib_fn is not None:
        contrib = np.asarray(contrib_fn(times, c_used), np.float64)
    else:
        contrib = mask.astype(np.float64)
    idle = float(np.sum(iter_time - times[mask])
                 / max(c_used * iter_time, _EPS))
    discard = float(1.0 - contrib.sum() / n)
    c_star = order_stats.oracle_cutoff(times)
    tp = c_used / max(iter_time, _EPS)
    tp_star = c_star / max(order_stats.iter_time(times, c_star), _EPS)
    regret = float(max(0.0, (tp_star - tp) / max(tp_star, _EPS)))
    rec = {"policy": entry["policy"], "step": entry["step"], "n": n,
           "c": c_used, "iter_time": iter_time, "oracle_c": c_star,
           "regret": regret, "idle_frac": idle, "discard_frac": discard,
           "pred_iter": None, "residual": None, "cov50": None,
           "cov90": None}
    samples = entry.get("samples")
    if samples is not None:
        s = np.sort(np.asarray(samples, np.float64), axis=1)
        col = s[:, min(c_used, s.shape[1]) - 1]   # K draws of x_(c)
        lo50, hi50 = np.quantile(col, [0.25, 0.75])
        lo90, hi90 = np.quantile(col, [0.05, 0.95])
        rec["pred_iter"] = float(col.mean())
        rec["residual"] = float(col.mean() - iter_time)
        rec["cov50"] = bool(lo50 <= iter_time <= hi50)
        rec["cov90"] = bool(lo90 <= iter_time <= hi90)
    return rec


def _fetch_samples(entries: List[dict]):
    """Every pending tensor sample cloud to the host: ONE copy a device.

    A snapshot taken on another stream is read only after its event (the
    current stream waits on it, no host wait); the blocking copy to the
    host then finishes every read before the snapshots are freed."""
    by_dev: Dict[torch.device, List[dict]] = {}
    for e in entries:
        event = e.pop("event", None)
        s = e.get("samples")
        if isinstance(s, torch.Tensor):
            if event is not None:
                torch.cuda.current_stream(s.device).wait_event(event)
            by_dev.setdefault(s.device, []).append(e)
    for group in by_dev.values():
        flat = torch.cat([e["samples"].reshape(-1).to(torch.float32)
                          for e in group]).cpu().numpy()
        at = 0
        for e in group:
            shape = tuple(e["samples"].shape)
            size = int(np.prod(shape))
            e["samples"] = flat[at:at + size].reshape(shape)
            at += size


class DecisionRecorder:
    """Buffers decision entries on the hot path, scores them at drain.

    ``record`` appends a dict and returns: no device access, no numpy
    math.  ``flush`` fetches every pending sample cloud (the drain
    boundary's one read), scores, appends to ``records``, and streams each
    record to ``decisions.jsonl`` when a log is attached."""

    def __init__(self, log: Optional[ObsLog] = None):
        self._pending: List[dict] = []
        self.records: List[dict] = []
        self._log = log

    def record(self, entry: dict):
        self._pending.append(entry)

    def flush(self) -> List[dict]:
        batch, self._pending = self._pending, []
        _fetch_samples(batch)
        fresh = []
        for entry in batch:
            rec = score_decision(entry)
            fresh.append(rec)
            if self._log is not None:
                self._log.emit(self._log.autotick(), "decision", **rec)
        self.records.extend(fresh)
        return fresh


class QualityController(_PolicyWrapper):
    """Observing wrapper: delegates every decision to ``inner`` and
    buffers (c, times, samples copy) for drain-time scoring.

    Transparency contract (held by the obs bit-exactness tests): the
    wrapped controller makes identical decisions.  The wrapper consumes
    no randomness and mutates no inner state; its only device work is the
    snapshot copy (module docstring).  Unknown attributes forward to
    ``inner``, so the Trainer's duck-typed policy probes
    (``contribution``, ``stale_decay``, ``mode``, ``hold``) and the
    checkpoint's controller group (``_step``, ``window_array``,
    ``seed_window``) see the wrapped policy unchanged."""

    def __init__(self, inner, recorder: DecisionRecorder,
                 policy: str = "policy"):
        super().__init__(inner)
        self._recorder = recorder
        self.policy = policy
        self._pending: Optional[dict] = None
        self._decisions = 0

    def __getattr__(self, name):
        if name == "inner":            # guard: not set yet during __init__
            raise AttributeError(name)
        return getattr(self.inner, name)

    def predict_cutoff(self) -> int:
        c = self.inner.predict_cutoff()
        self._decisions += 1
        snap = self._inner_call("snapshot_samples")
        samples, event = snap if snap is not None else (None, None)
        self._pending = {"step": self._decisions, "c": int(c),
                         "samples": samples, "event": event}
        return c

    def observe(self, times, finished_mask=None):
        p, self._pending = self._pending, None
        if p is not None:
            t = np.array(times, np.float64, copy=True)
            mask = (np.ones(t.shape, bool) if finished_mask is None
                    else np.array(finished_mask, bool, copy=True))
            p.update(policy=self.policy, times=t, mask=mask,
                     contrib_fn=getattr(self.inner, "contribution", None))
            self._recorder.record(p)
        return self.inner.observe(times, finished_mask)
