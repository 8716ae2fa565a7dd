"""Multi-tenant parameter-server demo on the PyTorch port: J jobs, one
batched decision path.

The port's counterpart of ``examples/multi_job_demo.py``.  Three tiny
training jobs share one simulated 24-worker cluster (8 workers each).  A
single PSServer decides all three jobs' cutoffs in ONE launch per tick
(one CUDA graph replay on the card); mid-run a churn event kills two of
job1's workers and the per-job elastic protocol (Elfving fallback + DMM
refit) absorbs it while the other jobs stay on the batched path.  Then
the same jobs re-run under capacity pressure (2 of 3 serviced per tick)
to show the scheduler policies' throughput trade-offs.

It runs on the card unless ``device="cpu"`` is given (the tiny config at
head_dim 64, the smallest the flash kernel is built for).

  PYTHONPATH=src python examples/torch_multi_job_demo.py [--device cpu]

``main(device="cpu", ticks=..., fit_steps=...)`` runs a smaller version.
"""
import argparse

import numpy as np

from repro_torch.cluster.simulator import ChurnEvent
from repro_torch.launch.multi_job import build_multi_job, run_ticks
from repro_torch.ps import make_scheduler


def main(device=None, ticks: int = 36, fit_steps: int = 120,
         refit_steps: int = 60):
    kill_at, back_at = ticks // 3, 2 * ticks // 3
    common = dict(seed=0, fit_steps=fit_steps, refit_steps=refit_steps,
                  priorities=[0.0, 1.0, 2.0], device=device)

    print("=== phase 1: 3 jobs x 8 workers, one PSServer, round-robin ===")
    events = [ChurnEvent(step=kill_at, kill=(8, 9)),
              ChurnEvent(step=back_at, restore=(8, 9))]
    server, jobs, _ = build_multi_job(3, 8, churn_events=events, **common)
    out = run_ticks(server, jobs, make_scheduler("rr"), ticks, verbose=True)
    print(f"  {ticks} ticks -> {out['dispatches']} fused launches "
          f"({out['dispatches'] / ticks:.2f}/tick for 3 jobs; a looped "
          f"design pays 3/tick)")
    for job_id, run in jobs.items():
        losses = [h["loss"] for h in run.trainer.history[-3:]]
        print(f"  {job_id}: steps={len(run.trainer.history)} "
              f"width={run.handle.n} mode={run.handle.mode} "
              f"loss={np.mean(losses):.4f}")
    if jobs["job1"].handle.n != 8:
        raise RuntimeError("job1 should have recovered its 8 workers")
    phase1 = {"dispatches": out["dispatches"],
              "widths": {j: r.handle.n for j, r in jobs.items()},
              "modes": {j: r.handle.mode for j, r in jobs.items()}}

    print("\n=== phase 2: capacity 2 of 3 — scheduler policy spread ===")
    phase2 = {}
    for policy in ("rr", "priority", "spsf"):
        server, jobs, _ = build_multi_job(3, 8, **common)
        out = run_ticks(server, jobs, make_scheduler(policy), ticks,
                        capacity=2)
        total = sum(out["serviced"].values())
        clock = {j: round(r.trainer.sim_clock, 1) for j, r in jobs.items()}
        print(f"  {policy:8s}: serviced={out['serviced']} "
              f"(total {total}), per-job sim clock={clock}")
        phase2[policy] = out["serviced"]
    print("\nround-robin spreads service evenly; priority starves job0; "
          "spsf packs the most total steps into predicted-fast jobs.")
    return {"phase1": phase1, "phase2": phase2}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the card")
    main(device=ap.parse_args().device)
