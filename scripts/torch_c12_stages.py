"""Where the multi-tenant server's window leaves its controller's (C.12).

Runs on the card.  At J = 1, n = 158 (``chip_smoke.py``'s ps_parity_158
setting: a ``RuntimeModel(158, lag=20)`` fitted 30 steps on
``paper_cluster_158(seed=0).run(60)``, k_samples 32, 100 ticks of
``paper_cluster_158(seed=7)``), it drives a ``CutoffController`` and a
``PSServer`` job on the same model and, every tick, replays both decision
bodies eagerly on the controller's ring, head and key, stage by stage;
prints one JSON line with each stage's largest difference, the first
stage that differs, the ring divided by the norm scale as a python float
against a tensor, how far one ulp of the predictive mean moves an imputed
entry, and the live windows' differences by observed and imputed entry.

    PYTHONPATH=src python3 scripts/torch_c12_stages.py
"""
from __future__ import annotations

import contextlib
import json
import math
import sys

import numpy as np
import torch


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


C12_STAGES = ("window", "h_left", "h_right", "z_T", "trans_mu", "trans_std",
              "z_next", "emit_mu", "emit_std", "samples", "sorted", "omega",
              "pred_mu", "pred_std", "iter")


@contextlib.contextmanager
def _stage_taps(rec):
    """Record the decision body's stages into ``rec`` while it runs
    eagerly: the normalized window and the guide's RNN sweeps, z_T, the
    transition's and the emission's moments (with z_next), and the sorted
    samples.  The module attributes the body calls through are wrapped
    and put back."""
    from repro_torch.core.cutoff import order_stats as O
    from repro_torch.core.runtime_model import dmm as D
    from repro_torch.core.runtime_model import guide as G

    taps = ((G, "guide_sample_broadcast",
             lambda a, o: {"window": a[1], "z_T": o}),
            (G, "_shifted_sweeps",
             lambda a, o: {"h_left": o[0], "h_right": o[1]}),
            (D, "transition",
             lambda a, o: {"trans_mu": o[0], "trans_std": o[1]}),
            (D, "emission",
             lambda a, o: {"z_next": a[1], "emit_mu": o[0],
                           "emit_std": o[1]}),
            (O, "_cutoff_from_sorted", lambda a, o: {"sorted": a[0]}),
            (O, "_cutoff_from_sorted_ragged", lambda a, o: {"sorted": a[0]}))
    saved = []
    for mod, name, pick in taps:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def tapped(*a, _fn=fn, _pick=pick, **kw):
            out = _fn(*a, **kw)
            rec.update({k: v.detach().clone()
                        for k, v in _pick(a, out).items()
                        if k not in rec})  # the decision's first call
            return out
        setattr(mod, name, tapped)
    try:
        yield rec
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _c12_replay(torch, rm, bucket, ring, head, key, k_samples, lo):
    """The controller's decision body and the bucket's (J = 1) on the SAME
    ring, head and key, eagerly on the default stream, every stage
    recorded: {"single", "ragged"} dicts of flattened f64 tensors."""
    from repro_torch.core.cutoff.eps import OMEGA_FLOOR
    from repro_torch.core.runtime_model.api import RuntimeModel

    params, scales, widths, los = bucket.stacked()
    sync = torch.cuda.synchronize if ring.is_cuda else (lambda: None)
    sync()
    runs = {}
    for kind in ("single", "ragged"):
        with torch.no_grad(), _stage_taps({}) as rec:
            if kind == "single":
                out = RuntimeModel._decide_core(rm.params, ring, head, key,
                                                rm.norm_scale, k_samples, lo)
            else:
                out = RuntimeModel._decide_core(
                    params, ring[None], head[None], key[None], scales,
                    k_samples, los, width=widths)
        s = rec["sorted"]
        cs = torch.arange(1, s.shape[-1] + 1, dtype=s.dtype, device=s.device)
        rec["omega"] = torch.mean(cs / torch.clamp(s, min=OMEGA_FLOOR),
                                  dim=-2)
        rec.update(cutoff=out[0], samples=out[1], pred_mu=out[2],
                   pred_std=out[3], iter=out[4])
        runs[kind] = {k: v.reshape(-1).double() for k, v in rec.items()}
    sync()
    return runs


def _c12_diagnose(torch, rm, ref, srv, h, sim, k_samples, steps):
    """C.12: where the server's window leaves the controller's on the card.

    Drives the J = 1, n = 158 pair (the controller ``ref`` and the server
    job ``h`` on the same model) over ``steps`` ticks, as ps_parity_158
    does, and at every tick:

      * replays both decision bodies on the CONTROLLER's ring, head and
        key (``_c12_replay``) and takes each stage's largest |single -
        ragged|, absolute and relative to the stage's largest |value|
        (the eager single body is checked bit-equal to the controller's
        graph);
      * divides the ring by the norm scale as a python float (a product
        with the reciprocal on the card) and as a tensor (true division),
        the two ways the decision bodies divided it before C.12's repair;
      * feeds the replay's predictive moments, and the same with the mean
        one ulp up, with this tick's times, mask and imputation uniforms,
        through the censored imputation: how far one ulp of moment noise
        moves an imputed entry;
      * compares the two live windows entry by entry, knowing which
        entries were imputed (the step's mask was False there).

    Returns the cutoffs, censored steps and the findings."""
    from repro_torch.core import controller as C
    from repro_torch.core.cutoff import censoring, order_stats
    from repro_torch.core.runtime_model.api import colwise_uniform

    n, cap = rm.n_workers, rm.lag + 1
    lo = order_stats.min_frac_floor(n, ref.min_frac)
    bucket = next(iter(srv._buckets.values()))
    names = C12_STAGES + ("cutoff",)
    stage_err = dict.fromkeys(names, 0.0)
    stage_rel = dict.fromkeys(names, 0.0)
    graph_eq, argsort_rows, first_tick = True, 0, {}
    scalar_divide_differ = 0
    amp = {"d_mu": 0.0, "d_imputed": 0.0, "n_imputed": 0}
    masks = [np.ones(n, bool)] * cap       # the seeded rows: observed
    win = {"first_tick_over_1e-6": None, "max_observed": 0.0,
           "max_imputed": 0.0, "entries_over_1e-5": 0,
           "imputed_over_1e-5": 0, "entries_over_1e-4": 0,
           "imputed_over_1e-4": 0}
    cutoffs, censored = [], 0
    for step in range(steps):
        c = (ref.predict_cutoff(), h.predict_cutoff())
        check(c[0] == c[1], f"ps_parity_158 step {step}: cutoffs {c} "
              f"(controller, server)")
        cutoffs.append(c[0])
        ref._wait()
        st = ref._st
        ring, head = st["ring"].clone(), st["head"].clone()
        key = st["obs"][2 * n:2 * n + 2].to(torch.int64)
        runs = _c12_replay(torch, rm, bucket, ring, head, key, k_samples,
                           lo)
        one, rag = runs["single"], runs["ragged"]
        graph_eq &= bool(torch.equal(one["pred_mu"],
                                     st["mu"].reshape(-1).double()))
        # the cause, alone: the ring over the python float, as CUDA
        # computes it (a product with the reciprocal), against the ring
        # over the same scale as a tensor (true division)
        scale_t = torch.full((), rm.norm_scale, dtype=ring.dtype,
                             device=ring.device)
        scalar_divide_differ = max(scalar_divide_differ, int(
            (ring / rm.norm_scale != ring / scale_t).sum()))
        for name in names:
            d = float((one[name] - rag[name]).abs().max())
            stage_err[name] = max(stage_err[name], d)
            stage_rel[name] = max(stage_rel[name], d / max(
                float(rag[name].abs().max()), 1e-30))
            if d > 0 and name not in first_tick:
                first_tick[name] = step
        K = k_samples
        argsort_rows += int((torch.argsort(one["samples"].reshape(K, n), 1)
                             != torch.argsort(rag["samples"].reshape(K, n),
                                              1)).any(1).sum())
        t = sim.step()
        mask = t <= order_stats.iter_time(t, c[0]) + 1e-12
        if not mask.all():
            censored += 1
            dev = ring.device
            tt = torch.as_tensor(t, dtype=torch.float32, device=dev)
            mm = torch.as_tensor(mask, device=dev)
            u = colwise_uniform(torch.as_tensor(
                np.asarray(C._impute_key(ref.seed, ref._step), np.int64),
                device=dev), n)
            cut = torch.max(torch.where(mm, tt, -math.inf))
            mu, std = one["pred_mu"].float(), one["pred_std"].float()
            mu_up = torch.nextafter(mu, torch.full_like(mu, math.inf))
            rows = [censoring.impute_censored_torch(tt, mm, m, std, cut, u)
                    for m in (mu, mu_up)]
            amp["d_imputed"] = max(amp["d_imputed"], float(
                (rows[0] - rows[1]).abs().max()))
            amp["d_mu"] = max(amp["d_mu"], float((mu_up - mu).max()))
            amp["n_imputed"] += int((~mask).sum())
        ref.observe(t, mask)
        h.observe(t, mask)
        check(srv.flush() == 1, f"ps_parity_158 step {step}: flush")
        masks = masks[1:] + [mask]
        d = np.abs(h.window_array() - ref.window_array())
        imputed = ~np.stack(masks)
        if win["first_tick_over_1e-6"] is None and d.max() > 1e-6:
            win["first_tick_over_1e-6"] = step
        win["max_observed"] = max(win["max_observed"],
                                  float(d[~imputed].max()))
        if imputed.any():
            win["max_imputed"] = max(win["max_imputed"],
                                     float(d[imputed].max()))
    for tol in ("1e-5", "1e-4"):
        over = d > float(tol)
        win[f"entries_over_{tol}"] = int(over.sum())
        win[f"imputed_over_{tol}"] = int((over & imputed).sum())
    return cutoffs, censored, {
        "stage_max_abs_err": stage_err, "stage_max_rel_err": stage_rel,
        "first_stage_differing": next(
            (s for s in C12_STAGES if stage_err[s] > 0), None),
        "first_stage_over_1e-6": next(
            (s for s in C12_STAGES if stage_err[s] > 1e-6), None),
        "first_tick_differing_by_stage": first_tick,
        "eager_single_equals_graph": graph_eq,
        "ring_entries_scalar_vs_tensor_divide_differing":
            scalar_divide_differ, "ring_entries": n * cap,
        "argsort_rows_differing": argsort_rows,
        "imputation": amp, "window": win}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.cluster.simulator import paper_cluster_158
    from repro_torch.core.controller import CutoffController
    from repro_torch.core.runtime_model.api import RuntimeModel
    from repro_torch.ps import PSServer

    trace = paper_cluster_158(seed=0).run(60)
    rm = RuntimeModel(158, lag=20, device="cuda").init(0)
    rm.fit(trace, steps=30, batch=8, seed=0)
    ref = CutoffController(rm, k_samples=32, seed=0)
    ref.seed_window(trace)
    srv = PSServer()
    h = srv.admit("job0", rm, window=trace, k_samples=32, seed=0)
    cutoffs, censored, c12 = _c12_diagnose(
        torch, rm, ref, srv, h, paper_cluster_158(seed=7), 32, 100)
    print(json.dumps({"phase": "ps_c12_stages", "device":
                      torch.cuda.get_device_name(0), "steps": 100,
                      "distinct_cutoffs": len(set(cutoffs)),
                      "censored_steps": censored, **c12}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
