"""colwise-rng: width-shaped draws must be column-wise.

The port's counterpart of the reference rule.  A block draw like
``R.normal(key, (K, n))`` consumes the threefry counter stream in
row-major order, so the same key at width n and padded width n_pad > n
yields DIFFERENT values in the shared columns — a padded bucket job
could never reproduce its standalone controller's samples, breaking the
ragged dispatch's bit-exactness.  Every width-shaped draw on the
decision/imputation path must route through ``api.colwise_normal`` /
``api.colwise_uniform`` (``core/runtime_model/api.py``: column i a
function of (key, i) alone).

Heuristic: flag raw ``normal``/``uniform`` draws of the ``jax.random``
twin (``repro_torch.random``, however imported) and ``torch.rand`` /
``randn`` / ``randint`` / ``normal`` calls whose shape expression
references a width-like name (``n``, ``width``, ``n_workers``,
``n_pad``, ...) or ``<width-carrier>.shape``.  Draws shaped by latent
dims (``(k_samples, zd)``) are allowed — they are per-sample, not
per-worker.  Scope: functions reachable from the hot roots (the decision
path and every graph body); model/param init is out of scope.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from repro_torch.analysis.callgraph import _walk_own_scope
from repro_torch.analysis.core import Finding, Project, Rule, dotted_name

TWIN_MODULE = "repro_torch.random"
RAW_DRAWS = {"normal", "uniform", "truncated_normal"}
TORCH_DRAWS = {"rand", "randn", "randint", "normal"}
WIDTH_NAMES = {"n", "width", "n_workers", "n_pad", "n_real", "n_max",
               "n_cols", "ring_width"}
WIDTH_CARRIERS = {"times", "ring", "rings", "window", "mask", "obs",
                  "x_next", "samples", "emu", "estd", "x_window", "xw"}


def _is_raw_draw(call: ast.Call, mod) -> Optional[str]:
    """The draw's dotted name if ``call`` is a raw twin or torch draw."""
    d = dotted_name(call.func)
    if d is None:
        return None
    parts = d.split(".")
    fn = parts[-1]
    if len(parts) == 2:
        base = parts[0]
        if fn in TORCH_DRAWS and mod.mod_aliases.get(base) == "torch":
            return d
        if fn in RAW_DRAWS and (
                mod.mod_aliases.get(base) == TWIN_MODULE
                or mod.from_imports.get(base) == ("repro_torch", "random")):
            return d
    if len(parts) == 1 and fn in RAW_DRAWS:
        fi = mod.from_imports.get(fn)
        if fi is not None and fi[0] == TWIN_MODULE:
            return d
    return None


def _shape_args(call: ast.Call, draw: str) -> List[ast.AST]:
    """The expressions that give a draw its shape: the twin's ``shape``
    (its second argument), torch's size arguments."""
    kw = [k.value for k in call.keywords if k.arg in ("shape", "size")]
    if draw.split(".")[0] != "torch" or draw.endswith(".normal"):
        return kw or call.args[1:2]
    if draw.endswith(".randint"):
        return kw or call.args[-1:]
    return kw or list(call.args)


def _width_ref(shape: ast.AST) -> Optional[str]:
    for n in ast.walk(shape):
        if isinstance(n, ast.Name) and n.id in WIDTH_NAMES:
            return n.id
        if isinstance(n, ast.Attribute):
            if n.attr in WIDTH_NAMES:
                return dotted_name(n) or n.attr
            if (n.attr == "shape" and isinstance(n.value, ast.Name)
                    and n.value.id in WIDTH_CARRIERS):
                return f"{n.value.id}.shape"
    return None


class ColwiseRng(Rule):
    id = "colwise-rng"
    doc = ("decision/imputation paths draw via api.colwise_normal/"
           "colwise_uniform, never width-shaped raw repro_torch.random "
           "or torch.rand* draws")

    def run(self, project: Project) -> Iterable[Finding]:
        g = project.callgraph
        hot = g.reachable(g.hot_roots())
        for key in sorted(hot):
            info = g.funcs[key]
            rel = key[0]
            if rel.endswith("runtime_model/api.py"):
                continue        # the colwise implementation itself
            mod = g.modules[rel]
            for n in _walk_own_scope(info.node):
                if not isinstance(n, ast.Call):
                    continue
                draw = _is_raw_draw(n, mod)
                if draw is None:
                    continue
                ref = next((r for r in map(_width_ref, _shape_args(n, draw))
                            if r is not None), None)
                if ref is not None:
                    fn = draw.split(".")[-1]
                    col = "normal" if fn in ("randn", "normal") else "uniform"
                    yield Finding(
                        rel, n.lineno, n.col_offset, self.id,
                        f"raw `{draw}` shaped by `{ref}` in "
                        f"`{key[1]}`: width-shaped draws are not stable "
                        f"under padding — use `api.colwise_{col}` so "
                        f"column i depends only on (key, i)")
