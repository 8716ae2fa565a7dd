"""Lightweight intraprocedural call graph over a lint project (the port's).

Good enough to answer ONE question: which functions are reachable from
the hot roots?  The roots are the reference's ``HOT_METHODS``
(``CutoffController.observe``, ``PSServer.flush``, ``Supervisor.tick``),
anything marked ``# reprolint: hot-path``, and, in place of the
reference's jit bodies, every function called inside a ``with
torch.cuda.graph(...)`` block: a graph's body runs once, at capture, and a
sync there breaks the capture.  Resolution is conservative — a call that
cannot be resolved simply adds no edge — so reachability
under-approximates and the host-sync rule never flags code it cannot
prove hot.

Resolved call forms: bare names (nested defs first, then module scope,
then from-imports), ``self.method`` (own class, then single-level bases
defined in the same file), ``alias.attr`` where ``alias`` is an imported
module that is part of the project, and, inside a graph's block only,
``obj.method`` where one class of the module defines ``method`` (the
graph of a step object: ``state.step()``).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import Project, SourceFile, dotted_name

#: (class, method) pairs that are hot roots by contract, wherever they
#: are defined (so lint fixtures can declare them too).
HOT_METHODS = {("CutoffController", "observe"),
               ("PSServer", "flush"),
               ("Supervisor", "tick")}

FuncKey = Tuple[str, str]          # (file rel, qualname)


@dataclass
class FuncInfo:
    key: FuncKey
    node: ast.AST                  # FunctionDef / AsyncFunctionDef
    lineno: int
    is_graph: bool = False         # called inside a CUDA graph's capture
    is_hot_root: bool = False
    uses_torch: bool = False       # touches torch -> result smells device
    calls: List[ast.Call] = field(default_factory=list)
    graph_calls: List[ast.Call] = field(default_factory=list)


@dataclass
class _ModuleIndex:
    file: SourceFile
    funcs: Dict[str, FuncInfo] = field(default_factory=dict)
    # local name -> dotted module ('np' -> 'numpy')
    mod_aliases: Dict[str, str] = field(default_factory=dict)
    # local name -> (dotted module, attr)  (from-imports)
    from_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    bases: Dict[str, List[str]] = field(default_factory=dict)


def is_graph_capture(node: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` (or ``cuda.graph(...)``): a with-item
    whose block is captured into a CUDA graph."""
    return (isinstance(node, ast.Call)
            and (dotted_name(node.func) or "").endswith("cuda.graph"))


def _walk_own_scope(fn_node: ast.AST):
    """Walk a function body without descending into nested def/class
    scopes; lambda bodies DO belong to the enclosing scope."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _torch_roots(mod: _ModuleIndex) -> Set[str]:
    """Local names bound to torch or one of its modules (``torch``,
    ``F`` for torch.nn.functional, ...)."""
    out = {a for a, m in mod.mod_aliases.items()
           if m == "torch" or m.startswith("torch.")}
    out |= {a for a, (m, _) in mod.from_imports.items()
            if m == "torch" or m.startswith("torch.")}
    return out


class CallGraph:
    def __init__(self):
        self.modules: Dict[str, _ModuleIndex] = {}
        self.funcs: Dict[FuncKey, FuncInfo] = {}
        self.edges: Dict[FuncKey, Set[FuncKey]] = {}

    # -- construction -------------------------------------------------

    @classmethod
    def build(cls, project: Project) -> "CallGraph":
        g = cls()
        for f in project.files:
            if f.tree is None:
                continue
            g.modules[f.rel] = g._index_module(f)
        for rel, mod in g.modules.items():
            for info in mod.funcs.values():
                g.funcs[info.key] = info
        for rel, mod in g.modules.items():
            g._resolve_module(project, mod)
        return g

    def _index_module(self, f: SourceFile) -> _ModuleIndex:
        mod = _ModuleIndex(file=f)
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod.mod_aliases[a.asname or a.name.split(".")[0]] = \
                        a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    mod.from_imports[a.asname or a.name] = (node.module,
                                                            a.name)
        torch_roots = _torch_roots(mod)

        def collect_fn(node, qual_prefix, cls_name):
            qual = (qual_prefix + "." if qual_prefix else "") + node.name
            info = FuncInfo(key=(f.rel, qual), node=node, lineno=node.lineno)
            if cls_name and (cls_name, node.name) in HOT_METHODS:
                info.is_hot_root = True
            marker_lines = {node.lineno, node.lineno - 1}
            if node.decorator_list:
                marker_lines.add(node.decorator_list[0].lineno - 1)
            if marker_lines & f.hot_path_lines:
                info.is_hot_root = True
            mod.funcs[qual] = info
            for sub in _walk_own_scope(node):
                if isinstance(sub, ast.Call):
                    info.calls.append(sub)
                if (isinstance(sub, ast.With)
                        and any(is_graph_capture(i.context_expr)
                                for i in sub.items)):
                    for stmt in sub.body:
                        info.graph_calls.extend(
                            n for n in [stmt, *_walk_own_scope(stmt)]
                            if isinstance(n, ast.Call))
                name = dotted_name(sub)
                if name and name.split(".")[0] in torch_roots:
                    info.uses_torch = True
            # nested defs: own scopes, resolvable as '<outer>.<name>'
            for sub in node.body:
                _walk_defs(sub, qual, cls_name)

        def _walk_defs(node, qual_prefix, cls_name):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                collect_fn(node, qual_prefix, cls_name)
            elif isinstance(node, ast.ClassDef):
                mod.bases[node.name] = [
                    b for b in (dotted_name(x) for x in node.bases) if b]
                for sub in node.body:
                    _walk_defs(sub, node.name, node.name)
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                for sub in ast.iter_child_nodes(node):
                    _walk_defs(sub, qual_prefix, cls_name)

        for node in f.tree.body:
            _walk_defs(node, "", None)
        return mod

    def _resolve_module(self, project: Project, mod: _ModuleIndex) -> None:
        for qual, info in mod.funcs.items():
            targets: Set[FuncKey] = set()
            for call in info.calls:
                t = self._resolve_call(project, mod, qual, call)
                if t is not None:
                    targets.add(t)
            for call in info.graph_calls:
                t = (self._resolve_call(project, mod, qual, call)
                     or self._resolve_by_method(mod, call))
                if t is not None:
                    self.funcs[t].is_graph = True
            self.edges[info.key] = targets

    @staticmethod
    def _resolve_by_method(mod: _ModuleIndex,
                           call: ast.Call) -> Optional[FuncKey]:
        """``obj.method()`` where exactly one class of the module defines
        ``method``."""
        if not isinstance(call.func, ast.Attribute):
            return None
        hits = [i.key for q, i in mod.funcs.items()
                if q.count(".") == 1 and q.split(".")[1] == call.func.attr
                and q.split(".")[0] in mod.bases]
        return hits[0] if len(hits) == 1 else None

    def _resolve_call(self, project: Project, mod: _ModuleIndex,
                      caller_qual: str, call: ast.Call) -> Optional[FuncKey]:
        func = call.func
        # bare name: nested def of the caller, then module scope, then
        # a from-import into a project module
        if isinstance(func, ast.Name):
            name = func.id
            nested = caller_qual + "." + name
            if nested in mod.funcs:
                return mod.funcs[nested].key
            if name in mod.funcs:
                return mod.funcs[name].key
            if name in mod.from_imports:
                target_mod, attr = mod.from_imports[name]
                return self._lookup(project, target_mod, attr)
            return None
        if isinstance(func, ast.Attribute):
            base = func.value
            # self.method()
            if isinstance(base, ast.Name) and base.id == "self":
                cls = caller_qual.split(".")[0]
                for c in [cls] + mod.bases.get(cls, []):
                    q = c + "." + func.attr
                    if q in mod.funcs:
                        return mod.funcs[q].key
                return None
            # module_alias.func()
            name = dotted_name(base)
            if name is None:
                return None
            target_mod = mod.mod_aliases.get(name)
            if target_mod is None and name in mod.from_imports:
                m, attr = mod.from_imports[name]
                target_mod = m + "." + attr     # from pkg import module
            if target_mod is not None:
                return self._lookup(project, target_mod, func.attr)
        return None

    def _lookup(self, project: Project, module: str,
                attr: str) -> Optional[FuncKey]:
        f = project.modules.get(module)
        if f is None or f.rel not in self.modules:
            return None
        funcs = self.modules[f.rel].funcs
        if attr in funcs:
            return funcs[attr].key
        return None

    # -- queries ------------------------------------------------------

    def hot_roots(self) -> Set[FuncKey]:
        return {k for k, i in self.funcs.items()
                if i.is_graph or i.is_hot_root}

    def reachable(self, roots: Set[FuncKey]) -> Set[FuncKey]:
        seen = set(roots)
        stack = list(roots)
        while stack:
            k = stack.pop()
            for t in self.edges.get(k, ()):
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return seen

    def device_returning_names(self, project: Project,
                               rel: str) -> Set[str]:
        """Names usable in module ``rel`` whose call result smells
        device-resident: project functions that touch torch (a port
        function returns tensors) or run under a graph."""
        mod = self.modules.get(rel)
        if mod is None:
            return set()
        out: Set[str] = set()
        for qual, info in mod.funcs.items():
            if info.is_graph or info.uses_torch:
                out.add(qual.split(".")[-1])
        for name, (m, attr) in mod.from_imports.items():
            key = self._lookup(project, m, attr)
            if key is not None:
                info = self.funcs[key]
                if info.is_graph or info.uses_torch:
                    out.add(name)
        return out
