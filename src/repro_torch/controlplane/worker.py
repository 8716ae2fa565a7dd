"""Subprocess worker payload: heartbeat until told otherwise.

``python -m repro_torch.controlplane.worker --wid N --dir RUNDIR --period S``

A copy of ``repro.controlplane.worker``, over the port's checkpoint store.

The loop appends one JSON line per heartbeat to ``RUNDIR/hb_N.jsonl``
and worker-side events to ``RUNDIR/ev_N.jsonl`` (the supervisor's
:class:`~repro_torch.controlplane.supervisor.ProcWorkerPool` tails both).
Control surface, all file-based so a drill can poke it from outside:

  ``RUNDIR/hang_N``   exists -> stop heartbeating but STAY ALIVE (the
                      supervisor must notice the silence and kill -9 us);
  ``RUNDIR/stop``     exists -> exit 0 cleanly (drill teardown);
  ``--fail``          exit 1 immediately (a flaky restart incarnation).

With ``--ckpt DIR`` the worker opens the checkpoint store on startup
and emits a ``recover`` event naming the step it warm-started from and
whether its OWN global id was in the saved membership — the drill's
proof that restore is by global worker id, not by rank.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _append(path: str, rec: dict):
    with open(path, "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")
        f.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wid", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--period", type=float, default=0.05)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--fail", action="store_true")
    args = ap.parse_args(argv)

    if args.fail:
        return 1

    wid = args.wid
    hb = os.path.join(args.dir, f"hb_{wid}.jsonl")
    ev = os.path.join(args.dir, f"ev_{wid}.jsonl")
    hang_flag = os.path.join(args.dir, f"hang_{wid}")
    stop_flag = os.path.join(args.dir, "stop")

    if args.ckpt:
        try:
            from repro_torch.checkpoint import store
            step = store.latest_valid_step(args.ckpt)
            grp = (store.restore_group(args.ckpt, "ctl", step=step)
                   if step is not None else None)
        except Exception:
            grp = None
        if grp is not None:
            members = [int(w) for w in grp["members"]]
            _append(ev, {"seq": 0, "tick": 0, "kind": "recover",
                         "worker": wid, "wall": time.time(),
                         "step": int(grp["step"]),
                         "warm": wid in members})

    n = 0
    while True:
        if os.path.exists(stop_flag):
            return 0
        if not os.path.exists(hang_flag):
            _append(hb, {"wid": wid, "n": n, "wall": time.time()})
            n += 1
        time.sleep(args.period)


if __name__ == "__main__":
    sys.exit(main())
