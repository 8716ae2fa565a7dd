"""Render a recorded run: timeline + calibration report from artifacts.

The port of ``repro.obs.report``.  Everything here reads the JSONL
streams an :class:`~repro_torch.obs.ObsRun` wrote (no live objects, no
device) through the torn-tail-tolerant ``controlplane.events.read_events``
reader, so a crashed run's artifacts still render; the reference's
streams read the same.  ``python -m repro_torch.obs <dir>`` is the CLI.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from repro_torch.controlplane.events import Event, read_events
from repro_torch.obs.trace import chrome_trace

STREAMS = ("spans", "steps", "decisions", "metrics")


def load_run(dir: str) -> Dict[str, List[Event]]:
    """Read every stream present under ``dir`` (absent files -> [])."""
    out: Dict[str, List[Event]] = {}
    for stream in STREAMS:
        path = os.path.join(dir, f"{stream}.jsonl")
        out[stream] = read_events(path) if os.path.exists(path) else []
    return out


def _records(events_or_dicts) -> List[dict]:
    return [e.data if isinstance(e, Event) else e for e in events_or_dicts]


def calibration_report(decisions) -> Dict[str, dict]:
    """Per-policy decision-quality aggregates from ``decision`` records.

    Coverage rates are frequencies of the per-step booleans: a calibrated
    predictive distribution shows ``coverage50`` ~ 0.5 and ``coverage90``
    ~ 0.9; policies without samples (sync/static/firstk) report ``None``
    there but still report regret/idle/discard."""
    by_policy: Dict[str, List[dict]] = {}
    for r in _records(decisions):
        by_policy.setdefault(r["policy"], []).append(r)
    out: Dict[str, dict] = {}
    for policy, recs in sorted(by_policy.items()):
        scored = [r for r in recs if r.get("cov50") is not None]

        def mean(key, rs):
            return float(np.mean([r[key] for r in rs])) if rs else None

        def frac(key):
            return (float(np.mean([bool(r[key]) for r in scored]))
                    if scored else None)

        out[policy] = {
            "decisions": len(recs),
            "scored": len(scored),
            "mean_regret": mean("regret", recs),
            "mean_idle_frac": mean("idle_frac", recs),
            "mean_discard_frac": mean("discard_frac", recs),
            "mean_abs_residual": (float(np.mean(
                [abs(r["residual"]) for r in scored])) if scored else None),
            "coverage50": frac("cov50"),
            "coverage90": frac("cov90"),
        }
    return out


def timeline_summary(spans) -> List[dict]:
    """Aggregate span records per (track, name): count, total/mean µs."""
    agg: Dict[tuple, dict] = {}
    for s in _records(spans):
        key = (s.get("track", "main"), s["name"])
        a = agg.setdefault(key, {"track": key[0], "name": key[1],
                                 "count": 0, "total_us": 0.0,
                                 "depth": s.get("depth", 1)})
        a["count"] += 1
        a["total_us"] += float(s["dur_us"])
    rows = sorted(agg.values(), key=lambda a: (a["track"], -a["total_us"]))
    for a in rows:
        a["mean_us"] = a["total_us"] / a["count"]
    return rows


def run_chrome_trace(run: Dict[str, List[Event]]) -> dict:
    return chrome_trace(_records(run["spans"]))


def _fmt(v, pat="{:.3f}") -> str:
    return "-" if v is None else pat.format(v)


def render(run: Dict[str, List[Event]]) -> str:
    """The CLI's text report: where the time went, then how well the
    decisions were made."""
    lines: List[str] = []
    steps = _records(run["steps"])
    lines.append(f"== run: {len(steps)} step records, "
                 f"{len(run['spans'])} spans, "
                 f"{len(run['decisions'])} decisions ==")
    if steps:
        first, last = steps[0], steps[-1]
        lines.append(f"   loss {first['loss']:.4f} -> {last['loss']:.4f} "
                     f"over {last['clock']:.1f}s simulated clock")

    rows = timeline_summary(run["spans"])
    if rows:
        lines.append("\n-- timeline (per span, by total time) --")
        lines.append(f"{'track':<12} {'span':<28} {'count':>6} "
                     f"{'total ms':>10} {'mean us':>10}")
        for a in rows:
            pad = "  " * (max(int(a["depth"]), 1) - 1)
            lines.append(f"{a['track']:<12} {pad + a['name']:<28} "
                         f"{a['count']:>6} {a['total_us'] / 1e3:>10.2f} "
                         f"{a['mean_us']:>10.1f}")

    cal = calibration_report(run["decisions"])
    if cal:
        lines.append("\n-- decision quality (per policy) --")
        lines.append(f"{'policy':<10} {'steps':>6} {'regret':>8} "
                     f"{'idle':>7} {'discard':>8} {'|resid|':>8} "
                     f"{'cov50':>6} {'cov90':>6}")
        for policy, r in cal.items():
            lines.append(
                f"{policy:<10} {r['decisions']:>6} "
                f"{_fmt(r['mean_regret']):>8} "
                f"{_fmt(r['mean_idle_frac']):>7} "
                f"{_fmt(r['mean_discard_frac']):>8} "
                f"{_fmt(r['mean_abs_residual']):>8} "
                f"{_fmt(r['coverage50'], '{:.2f}'):>6} "
                f"{_fmt(r['coverage90'], '{:.2f}'):>6}")
        lines.append("(calibrated predictive quantiles: cov50 ~ 0.50, "
                     "cov90 ~ 0.90)")

    mets = [e for e in run["metrics"] if e.kind == "metrics"]
    if mets:
        lines.append("\n-- drained device collectors --")
        for e in mets:
            d = e.data
            if d.get("collector") == "ring":
                lines.append(f"ring {d['name']}: {len(d['rows'])} rows "
                             f"({d['pushed']} pushed, "
                             f"{d['dropped']} dropped)")
            else:
                lines.append(f"histogram {d['name']}: "
                             f"{sum(d['counts']):.0f} samples")
    return "\n".join(lines)
