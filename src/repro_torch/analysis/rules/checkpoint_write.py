"""nonatomic-checkpoint-write (the port's copy): checkpoint bytes move
only via the store.

``checkpoint/store.py`` owns the tmp/rename publish protocol (write
``tmp.<step>`` → park final as ``stale`` → rename tmp into place →
drop stale) and the per-group crc32 manifest; a direct ``open(...,
"w")`` or ``os.rename`` under a checkpoint directory bypasses both the
crash-window guarantees and the checksums.  This rule taints names
derived from checkpoint paths (parameters/variables mentioning
``ckpt``/``checkpoint``, string literals with ``step_``/``manifest``/
``.npz``/``tmp.``/``stale``) and flags mutating filesystem calls on
tainted arguments.  ``checkpoint/store.py`` itself is exempt — it IS
the protocol.

Deliberate corruption (fault injection, crash-window tests) is expected
to carry a ``disable=`` pragma naming why.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set, Tuple

from repro_torch.analysis.core import Finding, Project, Rule, dotted_name
from repro_torch.analysis.callgraph import _walk_own_scope

WRITE_CALLS = {"os.rename", "os.replace", "os.remove", "os.unlink",
               "shutil.move", "shutil.rmtree", "shutil.copy",
               "shutil.copytree", "np.savez", "np.savez_compressed",
               "numpy.savez", "numpy.savez_compressed"}
PATH_TOKENS = ("ckpt", "checkpoint")
STR_TOKENS = ("step_", "manifest", ".npz", "tmp.", "stale")
EXEMPT_SUFFIX = "checkpoint/store.py"


def _token_name(name: str) -> bool:
    low = name.lower()
    return any(t in low for t in PATH_TOKENS)


def _expr_seeds_taint(expr: ast.AST, tainted: Set[str]) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Name):
            if n.id in tainted or _token_name(n.id):
                return True
        elif isinstance(n, ast.Attribute):
            d = dotted_name(n)
            if d and (d in tainted or _token_name(n.attr)):
                return True
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            if any(t in n.value for t in STR_TOKENS):
                return True
    return False


def _scan_scope(rule: Rule, rel: str, fn_node: ast.AST,
                params: List[str]) -> Iterable[Finding]:
    tainted: Set[str] = {p for p in params if _token_name(p)}
    assigns: List[Tuple[int, ast.AST, ast.AST]] = []
    for n in _walk_own_scope(fn_node):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                assigns.append((n.lineno, t, n.value))
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            if n.value is not None:
                assigns.append((n.lineno, n.target, n.value))
    assigns.sort(key=lambda x: x[0])
    for _ in range(2):
        changed = False
        for _, target, value in assigns:
            if not _expr_seeds_taint(value, tainted):
                continue
            for t in ast.walk(target):
                d = dotted_name(t)
                if d and d not in tainted:
                    tainted.add(d)
                    changed = True
        if not changed:
            break
    for n in _walk_own_scope(fn_node):
        if not isinstance(n, ast.Call):
            continue
        d = dotted_name(n.func)
        hit = None
        if d in WRITE_CALLS and n.args:
            if any(_expr_seeds_taint(a, tainted) for a in n.args):
                hit = d
        elif (isinstance(n.func, ast.Name) and n.func.id == "open"
                and n.args and _expr_seeds_taint(n.args[0], tainted)):
            mode = ""
            if len(n.args) >= 2 and isinstance(n.args[1], ast.Constant):
                mode = str(n.args[1].value)
            for kw in n.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = str(kw.value.value)
            if any(c in mode for c in "wax+"):
                hit = f"open(..., {mode!r})"
        if hit:
            yield Finding(
                rel, n.lineno, n.col_offset, rule.id,
                f"`{hit}` touches a checkpoint path directly; route "
                f"writes through `repro_torch.checkpoint.store` (tmp/rename "
                f"publish + crc32 manifest) so crash windows and "
                f"corruption stay recoverable")


class NonatomicCheckpointWrite(Rule):
    id = "nonatomic-checkpoint-write"
    doc = ("writes under a store path must route through the tmp/rename "
           "protocol in checkpoint/store.py")

    def run(self, project: Project) -> Iterable[Finding]:
        for f in project.files:
            if f.tree is None or f.rel.endswith(EXEMPT_SUFFIX):
                continue
            for node in ast.walk(f.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    a = node.args
                    params = [x.arg for x in
                              a.posonlyargs + a.args + a.kwonlyargs]
                    yield from _scan_scope(self, f.rel, node, params)
