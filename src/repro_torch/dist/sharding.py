"""Layouts: how logical axes (dp / sp / tp) map onto mesh axes per mode
(the port's ``repro.dist.sharding``).

  * ``Layout``       — frozen description of one execution mode on one
    mesh: the mesh axes carrying data-parallel batch shards (``dp``), the
    one axis carrying the model sharding (``model_axis``), and how the
    sequence (``seq_axis``) and feature (``tp_axis``) dims are split.
  * ``LOCAL``        — the no-mesh layout: one process, every helper a no-op.
  * ``make_layout``  — mode -> Layout, by the reference's rules:
      - ``train_sp``:   batch over the dp axes, sequence over "model",
        params ZeRO-3 over "model";
      - ``train_fsdp``: batch over the WHOLE mesh, params ZeRO-3 over
        "model";
      - ``decode_tp``:  batch over dp, features over "model", KV caches
        sequence-sharded over "model".
  * ``use_layout`` / ``layout`` — the active layout, a context variable.
  * ``placement(tree, lay, stacked_paths=...)`` — the ZeRO-3 placement rule
    of the reference's ``named_sharding``: for each leaf, the dim sharded
    over the model axis, or None.

A mesh is anything with ``axis_names`` and ``shape`` by axis name: the
port's ``launch.mesh.Mesh`` over a process group (what the train step
runs on), or a shape-only mesh (the reference's ``AbstractMesh`` in the
tests).

The port runs the data-parallel part: a layout whose model axis has one
shard, in mode ``train_fsdp`` (or a hand-built pure-dp ``Layout``, as the
reference's ``tests/sharded/mask_agg_check.py`` builds).  ZeRO-3 over the
model axis, ``train_sp`` and ``decode_tp`` raise by name
(:func:`require_data_parallel`); nothing falls back to one process.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

MODES = ("local", "train_sp", "train_fsdp", "decode_tp")

#: what each unported part of a layout waits for (ROADMAP A.15's slices)
WAITS_FOR = {
    "model": "ROADMAP A.15.2 (ZeRO-3 over the model axis, state_shardings "
             "and zero1)",
    "train_sp": "ROADMAP A.15.3 (train_sp: sequence parallelism, the ring "
                "CE and ssm.py's train_sp branches)",
    "decode_tp": "ROADMAP A.15.4 (decode_tp: tensor-parallel decode with "
                 "cache_pspec)",
    "aot": "ROADMAP A.15.5 (the AOT mesh tooling: make_production_mesh, "
           "inputs, dryrun, hillclimb, --aot)",
}


@dataclass(frozen=True)
class Layout:
    """One execution mode's logical-axis -> mesh-axis map."""
    mesh: Any = None
    mode: str = "local"
    dp: Tuple[str, ...] = ()            # axes sharding the batch dim
    model_axis: Optional[str] = None    # the model axis (FSDP / SP / TP)
    seq_axis: Optional[str] = None      # axis sharding the sequence dim
    tp_axis: Optional[str] = None       # axis sharding feature dims

    @property
    def dp_size(self) -> int:
        """Number of data-parallel shards (1 under LOCAL)."""
        if self.mesh is None or not self.dp:
            return 1
        size = 1
        for a in self.dp:
            size *= self.mesh.shape[a]
        return size

    @property
    def n_shards(self) -> int:
        """Size of the model axis (1 under LOCAL)."""
        if self.mesh is None or self.model_axis is None:
            return 1
        return self.mesh.shape[self.model_axis]

    def axis(self, kind: Optional[str]):
        """Logical kind -> mesh axis name(s): "dp" -> tuple (or None when
        empty), "sp"/"tp" -> single axis name or None, None -> None."""
        if kind is None:
            return None
        if kind == "dp":
            return self.dp if self.dp else None
        if kind == "sp":
            return self.seq_axis
        if kind == "tp":
            return self.tp_axis
        raise ValueError(f"unknown logical axis kind {kind!r}")

    def dp_for(self, batch_size: int):
        """dp axes if they divide ``batch_size``, else None (replicate)."""
        if not self.dp or batch_size % self.dp_size != 0:
            return None
        return self.dp


LOCAL = Layout()


def make_layout(mesh, mode: str) -> Layout:
    """The Layout for ``mode`` on ``mesh``.

    The model axis is the mesh axis named "model" (the last axis as
    fallback); every other axis is data-parallel.  ``mesh=None`` returns
    LOCAL whatever the mode.
    """
    if mesh is None:
        return LOCAL
    if mode not in MODES or mode == "local":
        raise ValueError(f"unknown layout mode {mode!r} (want one of "
                         f"{MODES[1:]})")
    names = tuple(mesh.axis_names)
    model = "model" if "model" in names else names[-1]
    others = tuple(a for a in names if a != model)
    if mode == "train_sp":
        return Layout(mesh=mesh, mode=mode, dp=others, model_axis=model,
                      seq_axis=model, tp_axis=None)
    if mode == "train_fsdp":
        return Layout(mesh=mesh, mode=mode, dp=names, model_axis=model,
                      seq_axis=None, tp_axis=None)
    return Layout(mesh=mesh, mode=mode, dp=others, model_axis=model,
                  seq_axis=None, tp_axis=model)


def require_data_parallel(lay: Layout, what: str) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item that ``what``
    waits for under ``lay``: ``train_sp``, ``decode_tp``, or a model axis
    of more than one shard; or, for anything but a :class:`Layout` (the
    reference's own, say), that the port runs none.  LOCAL and pure
    data-parallel layouts pass."""
    if not isinstance(lay, Layout):
        raise NotImplementedError(
            f"{what} takes a repro_torch.dist.sharding.Layout; a "
            f"{type(lay).__name__} is not a layout the port runs")
    if lay.mesh is None:
        return
    if lay.mode in ("train_sp", "decode_tp"):
        raise NotImplementedError(
            f"{what} under a {lay.mode} layout is not ported yet: it waits "
            f"for {WAITS_FOR[lay.mode]}")
    if lay.n_shards > 1:
        raise NotImplementedError(
            f"{what} with {lay.n_shards} shards on the model axis "
            f"{lay.model_axis!r} is not ported yet: it waits for "
            f"{WAITS_FOR['model']}")


# ---------------------------------------------------------------------------
# The active layout (a context variable).
# ---------------------------------------------------------------------------


_layout_var: contextvars.ContextVar[Layout] = contextvars.ContextVar(
    "repro_torch_layout", default=LOCAL)


def layout() -> Layout:
    """The active Layout (LOCAL when none was installed)."""
    return _layout_var.get()


@contextlib.contextmanager
def use_layout(lay: Layout):
    """Install ``lay`` as the active layout; the previous one comes back on
    exit (nesting-safe)."""
    tok = _layout_var.set(lay)
    try:
        yield lay
    finally:
        _layout_var.reset(tok)


# ---------------------------------------------------------------------------
# The ZeRO-3 placement rule.
# ---------------------------------------------------------------------------


def _map_with_path(fn, node, path=()):
    if isinstance(node, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(node))
    return fn("/".join(path), node)


def placement(tree, lay: Layout, *, stacked_paths: Sequence[str] = ()):
    """For each leaf of a parameter tree, the dim sharded over
    ``lay.model_axis`` (an int), or None (replicated): the rule of the
    reference's ``named_sharding``.

    ZeRO-3: the first dim whose size is at least the model axis's and
    divisible by it; dim 0 normally, from dim 1 for leaves under a
    ``stacked_paths`` prefix (their dim 0 is the reference's scan repeats
    dim).  ``decode_tp`` prefers the LAST such dim (feature tensor
    parallelism).  Under LOCAL every leaf is None.  Leaves may be tensors
    (the meta device included) or anything with a ``shape``; paths join
    dict keys and list indices with "/".
    """
    stacked_paths = tuple(stacked_paths)
    m = lay.model_axis if lay.mesh is not None else None
    tp = lay.n_shards

    def dim_for(path, leaf):
        if m is None:
            return None
        shape = tuple(leaf.shape)
        stacked = any(path == s or path.startswith(s + "/")
                      for s in stacked_paths)
        dims = list(range(1 if stacked else 0, len(shape)))
        if lay.mode == "decode_tp":
            dims = dims[::-1]
        for i in dims:
            if shape[i] >= tp and shape[i] % tp == 0:
                return i
        return None

    return _map_with_path(dim_for, tree)
