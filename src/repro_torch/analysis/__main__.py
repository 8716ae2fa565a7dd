"""CLI: ``python -m repro_torch.analysis [paths...] [options]``.

Exit codes: 0 clean (or advisory mode), 1 findings under ``--strict``
(or a failed audit), 2 usage errors.  ``--audit`` runs the capture audit
on the card (``capture_audit``) and writes its report; with no card it
raises.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint for the port: contract linter + capture "
                    "audit")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint (default: the port's own, "
                         "from the working directory)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any finding (CI mode; default is "
                         "report-only)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--select", action="append", default=None,
                    metavar="RULE", help="run only these rule ids")
    ap.add_argument("--audit", action="store_true",
                    help="run the capture audit on the card instead of "
                         "linting")
    ap.add_argument("--out", default="ANALYSIS_torch.json",
                    help="audit report path (with --audit)")
    args = ap.parse_args(argv)

    if args.audit:
        from repro_torch.analysis.capture_audit import write_report

        report = write_report(args.out)
        for e in report["entries"]:
            status = "ok" if e["ok"] else "FAIL"
            print(f"audit {status}: {e['name']}: {e['how']}, "
                  f"{e['n_kernels']} kernels of {e['n_nodes']} nodes, in "
                  f"place {e['in_place']['effective']}"
                  + (f", errors {e['errors']}" if e["errors"] else ""))
        print(f"wrote {args.out}")
        return 0 if report["ok"] else 1

    from repro_torch.analysis import (all_rules, default_paths, lint_paths,
                                      render_json, render_text, rule_ids)

    rules = all_rules()
    if args.select:
        known = rule_ids()
        bad = [r for r in args.select if r not in known]
        if bad:
            print(f"unknown rule(s): {', '.join(bad)}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.id in set(args.select)]
    paths = args.paths or default_paths(os.getcwd())
    findings = lint_paths(paths, rules=rules)
    if args.format == "json":
        sys.stdout.write(render_json(findings, {"paths": paths}))
    else:
        print(render_text(findings))
    if findings and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
