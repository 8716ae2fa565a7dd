"""host-sync-in-hot-path: no host/device synchronization on hot paths.

The port's counterpart of the reference rule, with torch's idioms.  It
takes the call graph's hot roots (``CutoffController.observe``,
``PSServer.flush``, ``Supervisor.tick``, every function called inside a
``with torch.cuda.graph(...)`` block, and anything marked ``# reprolint:
hot-path``), computes reachability, and flags inside that set:

* unconditionally: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``.to("cpu")`` / ``.to(device="cpu")``, ``torch.cuda.synchronize`` and
  any ``.synchronize()`` (a stream's, an event's) — these wait for the
  card or copy off it, whatever their argument;
* conversions — ``float()`` / ``int()`` / ``bool()`` / ``np.asarray()``
  / ``np.array()`` — only when the argument is *device-tainted*: derived
  from a ``torch.*`` call (not the host queries such as ``torch.finfo``,
  nor a factory given no device),
  a tensor method of a tainted value, a call to a port function that
  touches torch, or (inside a graph's body) any parameter.  Host-side
  bookkeeping like ``int(tick)`` never flags.

The designated fetches (the engine's one copy of the ids, the
controller's read of its pinned buffers after the event it recorded)
carry reasoned suppressions.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from repro_torch.analysis.callgraph import _torch_roots, _walk_own_scope
from repro_torch.analysis.core import Finding, Project, Rule, dotted_name

UNCONDITIONAL_ATTRS = {"item", "cpu", "tolist", "numpy", "synchronize"}
UNCONDITIONAL_CALLS = {"torch.cuda.synchronize"}
CONVERSION_BUILTINS = {"float", "int", "bool"}
NUMPY_CONVERSIONS = {"asarray", "array"}
#: torch calls that answer on the host and return no tensor
HOST_QUERIES = {"finfo", "iinfo", "device", "Size", "is_tensor",
                "is_grad_enabled", "is_inference_mode_enabled",
                "get_default_dtype", "Generator", "Stream", "Event",
                "is_available", "device_count", "current_device",
                "current_stream", "get_device_properties",
                "get_device_name"}
#: tensor factories: a tensor on the host unless given a device
FACTORIES = {"tensor", "as_tensor", "zeros", "ones", "empty", "full",
             "arange", "linspace", "eye", "from_numpy"}


def _ref_names(expr: ast.AST) -> Set[str]:
    """Every Name / dotted-attribute chain referenced in ``expr``."""
    out: Set[str] = set()
    for n in ast.walk(expr):
        d = dotted_name(n)
        if d:
            out.add(d)
        if isinstance(n, ast.Name):
            out.add(n.id)
    return out


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` or ``x.to(device="cpu")``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    args = list(call.args[:1]) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


class _FnScanner:
    """Per-function taint pass + sync-op scan."""

    def __init__(self, rule, mod, info, numpy_aliases, device_names,
                 origin):
        self.rule = rule
        self.mod = mod
        self.info = info
        self.numpy_aliases = numpy_aliases
        self.device_names = device_names
        self.torch_roots = _torch_roots(mod)
        self.origin = origin
        self.tainted: Set[str] = set()
        if info.is_graph:
            args = info.node.args
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                self.tainted.add(a.arg)
            if args.vararg:
                self.tainted.add(args.vararg.arg)

    def _is_taint_source(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        d = dotted_name(node.func)
        if d is None:
            return False
        parts = d.split(".")
        if parts[0] in self.torch_roots and len(parts) > 1:
            if parts[-1] in FACTORIES:
                return any(k.arg == "device" for k in node.keywords)
            return parts[-1] not in HOST_QUERIES
        if d in self.device_names:
            return True
        # self.method() where the method touches torch or runs in a graph
        if parts[0] == "self" and len(parts) == 2:
            cls = self.info.key[1].split(".")[0]
            m = self.mod.funcs.get(cls + "." + parts[1])
            if m is not None and (m.is_graph or m.uses_torch):
                return True
        return False

    def _expr_tainted(self, expr: ast.AST) -> bool:
        if _ref_names(expr) & self.tainted:
            return True
        return any(self._is_taint_source(n) for n in ast.walk(expr))

    def _propagate(self) -> None:
        assigns: List[Tuple[int, ast.AST, ast.AST]] = []
        for n in _walk_own_scope(self.info.node):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    assigns.append((n.lineno, t, n.value))
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                if n.value is not None:
                    assigns.append((n.lineno, n.target, n.value))
            elif isinstance(n, ast.For):
                assigns.append((n.lineno, n.target, n.iter))
        assigns.sort(key=lambda x: x[0])
        # two passes ~= fixpoint for loop-carried taint
        for _ in range(2):
            changed = False
            for _, target, value in assigns:
                if not self._expr_tainted(value):
                    continue
                for t in ast.walk(target):
                    d = dotted_name(t)
                    if d and d not in self.tainted:
                        self.tainted.add(d)
                        changed = True
            if not changed:
                break

    def scan(self) -> Iterable[Finding]:
        self._propagate()
        rel = self.info.key[0]
        where = (f"`{self.info.key[1]}` (hot via {self.origin})"
                 if self.origin != self.info.key[1]
                 else f"`{self.info.key[1]}`")
        for n in _walk_own_scope(self.info.node):
            if not isinstance(n, ast.Call):
                continue
            d = dotted_name(n.func)
            if (isinstance(n.func, ast.Attribute)
                    and n.func.attr in UNCONDITIONAL_ATTRS
                    and not n.args and d not in UNCONDITIONAL_CALLS):
                yield Finding(
                    rel, n.lineno, n.col_offset, self.rule.id,
                    f"`.{n.func.attr}()` in {where} waits for the card or "
                    f"copies off it on the hot path")
                continue
            if d in UNCONDITIONAL_CALLS or _to_cpu(n):
                yield Finding(
                    rel, n.lineno, n.col_offset, self.rule.id,
                    f"`{d}` in {where}: a sync or a copy to the host on "
                    f"the hot path")
                continue
            conv = None
            if (isinstance(n.func, ast.Name)
                    and n.func.id in CONVERSION_BUILTINS):
                conv = n.func.id
            elif (isinstance(n.func, ast.Attribute)
                    and n.func.attr in NUMPY_CONVERSIONS
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id in self.numpy_aliases):
                conv = f"{n.func.value.id}.{n.func.attr}"
            if conv and n.args and self._expr_tainted(n.args[0]):
                yield Finding(
                    rel, n.lineno, n.col_offset, self.rule.id,
                    f"`{conv}(...)` of a device value in {where} waits "
                    f"for the card; keep it on the device or fetch once at "
                    f"the designated point")


class HostSyncInHotPath(Rule):
    id = "host-sync-in-hot-path"
    doc = ("no .item()/.cpu()/.tolist()/.numpy()/synchronize or "
           "float()/int() of a device value reachable from the hot roots")

    def run(self, project: Project) -> Iterable[Finding]:
        g = project.callgraph
        roots = g.hot_roots()
        # provenance: nearest root a function was first reached from
        origin: Dict[Tuple[str, str], str] = {}
        stack = []
        for r in sorted(roots):
            origin[r] = g.funcs[r].key[1]
            stack.append(r)
        while stack:
            k = stack.pop()
            for t in sorted(g.edges.get(k, ())):
                if t not in origin:
                    origin[t] = origin[k]
                    stack.append(t)
        for key in sorted(origin):
            info = g.funcs[key]
            mod = g.modules[key[0]]
            numpy_aliases = {a for a, m in mod.mod_aliases.items()
                             if m == "numpy"}
            device_names = g.device_returning_names(project, key[0])
            yield from _FnScanner(self, mod, info, numpy_aliases,
                                  device_names, origin[key]).scan()
