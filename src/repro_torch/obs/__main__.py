"""CLI: render a recorded run's timeline + calibration report.

  PYTHONPATH=src python -m repro_torch.obs OBS_DIR [--chrome trace.json]

Reads only the JSONL artifacts an ``--obs-dir`` run wrote; ``--chrome``
also exports the span stream as Chrome-trace/Perfetto JSON (open it in
``chrome://tracing`` or Perfetto's UI).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import report as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    ap.add_argument("obs_dir", help="directory an --obs-dir run wrote")
    ap.add_argument("--chrome", metavar="OUT.json", default=None,
                    help="also export spans as a Chrome-trace JSON file")
    args = ap.parse_args(argv)

    run = R.load_run(args.obs_dir)
    if not any(run.values()):
        print(f"no obs streams found under {args.obs_dir}",
              file=sys.stderr)
        return 1
    print(R.render(run))
    if args.chrome:
        doc = R.run_chrome_trace(run)
        with open(args.chrome, "w") as f:
            json.dump(doc, f)
        print(f"\nchrome trace -> {args.chrome} "
              f"({len(doc['traceEvents'])} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
