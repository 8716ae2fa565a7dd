"""The port lints clean under its own reprolint, and ANALYSIS_torch.json
stays honest.

Two guards, the port's counterparts of ``tests/test_lint_clean.py``.
First: ``repro_torch.analysis`` over the port's own paths (its default
set) finds NOTHING — every violation is fixed or carries a reasoned
suppression.  Second: the committed ``ANALYSIS_torch.json`` (the capture
audit's report from the card) keeps its schema, covers the registry of
``capture_audit`` entry for entry, and says every entry captured (or ran)
with no sync and updated in place.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.analysis import default_paths, lint_paths
from repro_torch.analysis.capture_audit import ENTRY_NAMES, SCHEMA_VERSION

REPO = Path(__file__).resolve().parent.parent


def test_port_lints_clean():
    paths = default_paths(REPO)
    assert any(p.endswith("chip_smoke.py") for p in paths)
    assert any("/src/repro_torch" in p for p in paths)
    findings = lint_paths(paths, root=str(REPO))
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)


def test_analysis_torch_json_committed_and_schema():
    path = REPO / "ANALYSIS_torch.json"
    assert path.exists(), ("ANALYSIS_torch.json not committed (run "
                           "`python -m repro_torch.analysis --audit` on "
                           "the card)")
    doc = json.loads(path.read_text())
    assert set(doc) == {"version", "torch_version", "device", "ok",
                        "entries"}
    assert doc["version"] == SCHEMA_VERSION
    assert doc["ok"] is True
    assert isinstance(doc["torch_version"], str) and doc["device"]
    entries = {e["name"]: e for e in doc["entries"]}
    assert list(entries) == list(ENTRY_NAMES)
    for name, e in entries.items():
        assert set(e) == {"name", "how", "n_kernels", "n_nodes", "errors",
                          "sync_free", "in_place", "ok"}, name
        assert e["ok"] is True and e["sync_free"] is True, name
        assert e["errors"] == [], name
        d = e["in_place"]
        assert set(d) == {"expected", "n_leaves", "n_in_place",
                          "effective"}, name
        assert d["expected"] is True and d["effective"] is True, name
        assert d["n_in_place"] == d["n_leaves"] > 0, name
        if e["how"] == "captured":
            assert e["n_nodes"] >= e["n_kernels"] and e["n_nodes"] > 0, name
        else:
            assert e["how"] == "run" and name.startswith("train_step"), name
