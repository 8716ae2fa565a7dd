"""donation-after-use: a handle to a graph's buffer is dead after a replay.

The reference's rule guards JAX's donated buffers.  The port updates in
place instead: a CUDA graph owns its static buffers (its outputs, the
state it steps) and every ``replay()`` writes them again.  A name that
holds a view of such a buffer, bound before a replay and read after it,
reads the NEXT replay's values, not the ones it was bound to (the fault
class of ROADMAP C.13: a lazy handle to a buffer the next replay
overwrites).  The contract is clone-or-rebind:

    with torch.cuda.graph(g):
        out = step(state)            # the graph's output: read it freely
    g.replay()
    first = out                      # a handle to the buffer ...
    keep = out.clone()               # ... and a copy of it
    g.replay()
    use(keep)                        # OK
    use(first)                       # BAD: `first` is replay 2's values

A handle is a name bound, outside a capture block and after a replay of
its graph (a snapshot of that replay's result), to an alias
expression (a name, attribute or subscript chain, optionally through
view methods such as ``view``/``reshape``/``narrow``) rooted at a name
bound inside a ``with torch.cuda.graph(...)`` block or at an object
whose ``.replay()`` this scope calls (``g.state.logits``).  A binding
through ``.clone()`` (or any other call) is a copy, not a handle.

The pass is the reference's per-scope, statement-ordered dataflow: each
statement (1) checks reads against the dead set, (2) kills the handles
bound before it when it replays a graph, (3) revives names it (re)binds.
Findings therefore depend only on the def-use order of statements, not
their absolute positions (pinned by a hypothesis property in the tests).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.callgraph import is_graph_capture
from repro_torch.analysis.core import Finding, Project, Rule, dotted_name

#: tensor methods that return a view of their input (a handle stays one)
VIEW_METHODS = {"view", "reshape", "narrow", "expand", "t", "transpose",
                "permute", "squeeze", "unsqueeze", "flatten", "select",
                "view_as", "detach", "contiguous"}


def _alias_root(expr: ast.AST) -> Optional[str]:
    """The dotted root of an alias expression (a Name / Attribute /
    Subscript chain, through view methods), or None for a fresh value."""
    node = expr
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr in VIEW_METHODS):
            node = node.func.value
        elif isinstance(node, ast.Attribute):
            d = dotted_name(node)
            if d is not None:
                return d
            node = node.value
        elif isinstance(node, ast.Name):
            return node.id
        else:
            return None


def _replayed(stmt: ast.stmt) -> Set[str]:
    """Dotted objects whose ``.replay()`` the statement calls."""
    out = set()
    for n in ast.walk(stmt):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "replay"):
            d = _alias_root(n.func.value)
            if d:
                out.add(d)
    return out


class _Scope:
    """One function (or module) body, analyzed statement by statement."""

    def __init__(self, rule: Rule, rel: str, body: Sequence[ast.stmt]):
        self.rule = rule
        self.rel = rel
        self.body = body
        self.outputs: Dict[str, str] = {}       # bound in a capture: graph
        self.graphs: Set[str] = set()           # objects replayed here
        self.handles: Dict[str, Tuple[str, int]] = {}  # -> (graph, line)
        self.dead: Dict[str, Tuple[int, int]] = {}     # -> (bound, replay)
        self.findings: List[Finding] = []

    def _statements(self) -> Iterable[Tuple[ast.stmt, Optional[str]]]:
        """Flatten compound statements, skipping nested def/class; each
        with the graph whose capture block it sits in, if any."""
        stack: List[Tuple[ast.stmt, Optional[str]]] = [
            (s, None) for s in self.body][::-1]
        while stack:
            s, cap = stack.pop()
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            yield s, cap
            inner = cap
            for item in getattr(s, "items", None) or []:
                if is_graph_capture(item.context_expr):
                    args = item.context_expr.args
                    inner = (_alias_root(args[0]) if args else None) or "?"
            for fld in ("body", "orelse", "finalbody"):
                sub = getattr(s, fld, None)
                if sub:
                    stack.extend((x, inner) for x in reversed(sub))
            for h in getattr(s, "handlers", []) or []:
                stack.extend((x, cap) for x in reversed(h.body))

    @staticmethod
    def _stores(stmt: ast.stmt) -> Set[str]:
        out: Set[str] = set()
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.For):
            targets = [stmt.target]
        elif isinstance(stmt, ast.With):
            targets = [i.optional_vars for i in stmt.items
                       if i.optional_vars is not None]
        elif isinstance(stmt, ast.Delete):
            targets = list(stmt.targets)
        for t in targets:
            for n in ast.walk(t):
                d = dotted_name(n)
                if d:
                    out.add(d)
        return out

    @staticmethod
    def _reads(stmt: ast.stmt) -> Iterable[Tuple[str, ast.AST]]:
        skip: Set[int] = set()
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                for n in ast.walk(t):
                    skip.add(id(n))
        for n in ast.walk(stmt):
            if id(n) in skip:
                continue
            if isinstance(n, (ast.Name, ast.Attribute)) and isinstance(
                    getattr(n, "ctx", None), ast.Load):
                d = dotted_name(n)
                if d:
                    yield d, n

    def _owner(self, root: Optional[str]) -> Optional[str]:
        """The graph that owns the buffer an alias rooted at ``root``
        views: a capture's output's graph, or a replayed object."""
        if root is None:
            return None
        for name in (root, root.split(".")[0]):
            if name in self.outputs:
                return self.outputs[name]
        return next((g for g in sorted(self.graphs)
                     if root == g or root.startswith(g + ".")), None)

    def run(self) -> List[Finding]:
        stmts = list(self._statements())
        for s, _ in stmts:
            self.graphs |= _replayed(s)
        replayed_so_far: Set[str] = set()
        for stmt, in_capture in stmts:
            # 1) reads of dead handles
            flagged: Set[str] = set()
            for name, node in self._reads(stmt):
                hit = next((dn for dn in self.dead
                            if name == dn or name.startswith(dn + ".")),
                           None)
                if hit and hit not in flagged:
                    flagged.add(hit)
                    bound, replay = self.dead[hit]
                    self.findings.append(Finding(
                        self.rel, node.lineno, node.col_offset, self.rule.id,
                        f"`{name}` is a handle to a graph's buffer bound "
                        f"on line {bound} and read after the replay on "
                        f"line {replay} overwrote it; `.clone()` it before "
                        f"the replay or bind it again after"))
            # 2) a replay kills the handles of its graph bound before it
            replayed = _replayed(stmt)
            for name, (graph, bound) in list(self.handles.items()):
                if graph in replayed:
                    self.dead[name] = (bound, stmt.lineno)
            replayed_so_far |= replayed
            # 3) (re)bindings
            stores = self._stores(stmt)
            for name in stores:
                self.dead.pop(name, None)
                self.handles.pop(name, None)
                for k in [k for k in self.dead if k.startswith(name + ".")]:
                    self.dead.pop(k)
            if in_capture is not None:
                for name in stores:
                    self.outputs[name] = in_capture
            elif (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                  and isinstance(stmt.targets[0], ast.Name)):
                graph = self._owner(_alias_root(stmt.value))
                if graph is not None and graph in replayed_so_far:
                    self.handles[stmt.targets[0].id] = (graph, stmt.lineno)
        return self.findings


class DonationAfterUse(Rule):
    id = "donation-after-use"
    doc = ("a handle to a CUDA graph's buffer may not be read after a "
           "later replay() in the same scope without a clone")

    def run(self, project: Project) -> Iterable[Finding]:
        for f in project.files:
            if f.tree is None:
                continue
            yield from _Scope(self, f.rel, f.tree.body).run()
            for node in ast.walk(f.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield from _Scope(self, f.rel, node.body).run()
