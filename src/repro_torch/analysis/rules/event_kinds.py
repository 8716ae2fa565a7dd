"""event-kind-drift (the port's copy): the event vocabulary has exactly one
source of truth per stream family.

``controlplane/events.py`` declares ``EVENT_KINDS`` and ``obs/trace.py``
declares ``OBS_KINDS``; ``EventLog.emit`` validates against the class's
registry at runtime.  Drift still creeps in two ways that runtime
validation cannot catch: (a) an emit site with a NEW literal kind that
was never registered only explodes when that code path runs (often
mid-drill), and (b) a registered kind nobody emits anymore is dead
vocabulary that dashboards and drills keep matching on.  This rule
closes both directions statically: every literal ``kind`` at an
``*.emit(tick, kind, ...)`` call site must be registered in SOME
registry, and every kind registered in ANY registry must appear at some
emit site in the linted tree.  (Emit sites are not attributed to a
specific log class statically, so a kind living in both registries —
e.g. ``"run"`` — is fine, and an emit is flagged only when NO registry
knows it.)  Dynamic kinds (``log.emit(tick, ev.kind, ...)``) are
skipped — the runtime check owns those.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.core import Finding, Project, Rule, const_str_elems

REGISTRY_NAMES = ("EVENT_KINDS", "OBS_KINDS")


class EventKindDrift(Rule):
    id = "event-kind-drift"
    doc = ("every literal kind= emitted anywhere appears in an EVENT_KINDS/"
           "OBS_KINDS registry, and vice versa")

    def run(self, project: Project) -> Iterable[Finding]:
        registries: Dict[str, Set[str]] = {}
        reg_where: Dict[str, Tuple[str, int]] = {}
        kind_lines: Dict[str, Dict[str, int]] = {}
        emits: List[Tuple[str, int, int, str]] = []
        for f in project.files:
            if f.tree is None:
                continue
            for node in ast.walk(f.tree):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id in REGISTRY_NAMES):
                    name = node.targets[0].id
                    kinds = const_str_elems(node.value)
                    if kinds is not None:
                        registries[name] = set(kinds)
                        reg_where[name] = (f.rel, node.lineno)
                        lines = kind_lines.setdefault(name, {})
                        if isinstance(node.value, (ast.Tuple, ast.List)):
                            for e in node.value.elts:
                                lines[e.value] = e.lineno
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                if not (isinstance(fn, ast.Attribute) and fn.attr == "emit"):
                    continue
                kind_node: Optional[ast.AST] = None
                if len(node.args) >= 2:
                    kind_node = node.args[1]
                for kw in node.keywords:
                    if kw.arg == "kind":
                        kind_node = kw.value
                if (isinstance(kind_node, ast.Constant)
                        and isinstance(kind_node.value, str)):
                    emits.append((f.rel, node.lineno, node.col_offset,
                                  kind_node.value))
        if not registries:
            return
        union: Set[str] = set()
        for kinds in registries.values():
            union |= kinds
        names = " / ".join(sorted(registries))
        emitted = {k for _, _, _, k in emits}
        for rel, line, col, kind in emits:
            if kind not in union:
                yield Finding(
                    rel, line, col, self.id,
                    f"emit of unregistered kind '{kind}': add it to "
                    f"{names} (or fix the typo) — the runtime check "
                    f"would reject this at drill time, not review time")
        if emits:
            for name in sorted(registries):
                where = reg_where[name]
                for kind in sorted(registries[name] - emitted):
                    yield Finding(
                        where[0],
                        kind_lines.get(name, {}).get(kind, where[1]),
                        0, self.id,
                        f"registered kind '{kind}' in {name} is never "
                        f"emitted with a literal anywhere in the linted "
                        f"tree: dead vocabulary, or an emit site the "
                        f"registry has drifted from")
