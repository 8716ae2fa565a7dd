"""twin-epsilon-drift: numeric guards shared across backend twins.

The port's counterpart of the reference rule.  The cutoff math ships as
pairs — a float64 numpy reference and an f32 torch twin
(``order_stats``, ``censoring``, ``_normal``: ``f`` / ``f_torch``) —
that must produce IDENTICAL seeded cutoff sequences.  A clip or epsilon
constant typed inline in one twin ("1e-9" here, "1e-8" there after a
refactor) silently splits the two distributions; the parity suites only
catch it when a seed happens to land inside the gap.

The rule finds module-level ``f`` / ``f_torch`` pairs and flags any
inline float literal with 0 < |v| < 1e-3 in either body: epsilons in
twins must be hoisted to a shared, backend-neutral named constant
(``core/cutoff/eps.py``) that both read.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.callgraph import _walk_own_scope
from repro_torch.analysis.core import Finding, Project, Rule

TWIN_SUFFIX = "_torch"
EPS_MAX = 1e-3


class TwinEpsilonDrift(Rule):
    id = "twin-epsilon-drift"
    doc = ("clip/epsilon constants in f/f_torch backend twins must be "
           "shared named constants, not inline literals")

    def run(self, project: Project) -> Iterable[Finding]:
        for f in project.files:
            if f.tree is None:
                continue
            fns: Dict[str, ast.AST] = {}
            for node in ast.walk(f.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fns.setdefault(node.name, node)
            twins: List[Tuple[str, ast.AST]] = []
            for name, node in fns.items():
                if name.endswith(TWIN_SUFFIX):
                    base = name[:-len(TWIN_SUFFIX)]
                    if base in fns:
                        twins.append((name, node))
                        twins.append((base, fns[base]))
            for name, node in sorted(twins, key=lambda t: t[1].lineno):
                for n in _walk_own_scope(node):
                    if not (isinstance(n, ast.Constant)
                            and isinstance(n.value, float)):
                        continue
                    v = abs(n.value)
                    if 0.0 < v < EPS_MAX:
                        yield Finding(
                            f.rel, n.lineno, n.col_offset, self.id,
                            f"inline epsilon {n.value!r} in backend twin "
                            f"`{name}`: hoist it to a shared named "
                            f"constant both twins read "
                            f"(core/cutoff/eps.py) so the f64 and f32 "
                            f"paths can never drift apart")
