"""repro_torch.analysis: the port's contract linter (reprolint) and its
capture audit on the card.

The port's counterpart of ``repro.analysis``, its own copy (the port
imports nothing of the JAX package).  Run it as::

    PYTHONPATH=src python -m repro_torch.analysis --strict   # lint
    PYTHONPATH=src python -m repro_torch.analysis --audit    # card only

The default paths are the port's: ``src/repro_torch``,
``tests/test_torch_*.py``, ``chip_smoke.py``, ``examples/torch_*.py`` and
``scripts/torch_*.py``.  The rules carry the reference's seven ids, so one
pragma serves both linters.
"""
from repro_torch.analysis.core import (Finding, Project, Rule, discover,
                                       render_json, render_text, run_rules)
from repro_torch.analysis.rules import all_rules, rule_ids

__all__ = ["Finding", "Project", "Rule", "discover", "render_json",
           "render_text", "run_rules", "all_rules", "rule_ids",
           "lint_paths", "default_paths"]

#: what the port's linter reads when given no paths (globs from the root)
DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py", "chip_smoke.py",
                 "examples/torch_*.py", "scripts/torch_*.py")


def default_paths(root):
    """The port's files under ``root``, DEFAULT_PATHS expanded."""
    from pathlib import Path

    root = Path(root)
    out = []
    for pat in DEFAULT_PATHS:
        out.extend(str(p) for p in sorted(root.glob(pat)))
    return out


def lint_paths(paths, root=None, rules=None):
    """Lint ``paths`` and return the (suppression-filtered) findings."""
    project = discover(paths, root=root, known_rules=rule_ids())
    return run_rules(project, rules if rules is not None else all_rules())
