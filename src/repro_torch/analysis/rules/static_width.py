"""static-argnum-width: one CUDA graph a bucket, not one a width.

The port's counterpart of the reference rule.  The reference flags a
per-job width made a static jit argument: one compilation per distinct
width, where the ragged contract promises ONE program a bucket.  The
port's programs are CUDA graphs kept in caches keyed by what changes
their shapes; a cache keyed by a width-like value (``n``, ``width``,
``n_workers``, ``lo``, ``n_pad``, ...) captures one graph per distinct
width, and a mixed-width tick then pays J captures where the ragged
contract promises one.

The rule flags a store ``<...>graphs[key] = ...`` (any subscripted name
ending in ``graphs``) whose key — a tuple literal, or a name bound to one
in the same function — holds a width-like name or attribute.  The
single-job controller deliberately keys its graphs by its width and
``lo`` (recaptured only on an elastic resize, never per tick): that site
carries a pragma explaining exactly that.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional

from repro_torch.analysis.callgraph import _walk_own_scope
from repro_torch.analysis.core import Finding, Project, Rule, dotted_name

WIDTH_NAMES = {"n", "width", "n_workers", "lo", "n_pad", "n_real",
               "n_max", "n_cols"}


def _width_elem(key: ast.AST) -> Optional[str]:
    elts = key.elts if isinstance(key, ast.Tuple) else [key]
    for e in elts:
        if isinstance(e, ast.Name) and e.id in WIDTH_NAMES:
            return e.id
        if isinstance(e, ast.Attribute) and e.attr in WIDTH_NAMES:
            return dotted_name(e) or e.attr
    return None


class StaticArgnumWidth(Rule):
    id = "static-argnum-width"
    doc = "graph caches are keyed by bucket, not by a job's width or lo"

    def run(self, project: Project) -> Iterable[Finding]:
        for f in project.files:
            if f.tree is None:
                continue
            for fn in ast.walk(f.tree):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                tuples: Dict[str, ast.AST] = {}
                for n in _walk_own_scope(fn):
                    if (isinstance(n, ast.Assign) and len(n.targets) == 1
                            and isinstance(n.targets[0], ast.Name)
                            and isinstance(n.value, ast.Tuple)):
                        tuples[n.targets[0].id] = n.value
                for n in _walk_own_scope(fn):
                    if not isinstance(n, ast.Assign):
                        continue
                    for t in n.targets:
                        if not (isinstance(t, ast.Subscript)
                                and (dotted_name(t.value) or "").endswith(
                                    "graphs")):
                            continue
                        key = t.slice
                        if isinstance(key, ast.Name) and key.id in tuples:
                            key = tuples[key.id]
                        w = _width_elem(key)
                        if w is not None:
                            yield Finding(
                                f.rel, n.lineno, n.col_offset, self.id,
                                f"graph cache keyed by width-like `{w}`: "
                                f"one capture per distinct value — pad to "
                                f"the bucket and mask in the graph (the "
                                f"ragged contract)")
