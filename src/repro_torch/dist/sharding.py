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
  * ``shard_plan(tree, lay, zero1=...)`` — a :class:`ShardPlan`: each
    leaf's placement, this rank's slice, and its columns in the
    shard-major flat order of the ZeRO-3 gradient buffers.
  * ``use_weight(tree)`` — the use-site gather of ZeRO-3-sharded weights
    (identity unless a train step's gather is active), ``use_shard(tree)``
    — this rank's ZeRO-3 slice of each leaf, used where it lies (the
    vocab ring's block, expert parallelism's bank), ``remat`` — a block
    run so that its gathered weights are gathered again in the backward
    instead of kept, and ``act(x, dp, sp, tp, seq=...)`` — the
    activation constraint: the identity, except that under ``train_sp``
    it gathers or slices the sequence as asked.
  * ``seq_parallel`` / ``seq_span`` / ``seq_shard`` / ``seq_last`` —
    whether the active layout splits the sequence over the model axis,
    this rank's columns of a full sequence, and whether they are its last.

A mesh is anything with ``axis_names`` and ``shape`` by axis name: the
port's ``launch.mesh.Mesh`` over a process group (what the train step
runs on), or a shape-only mesh (the reference's ``AbstractMesh`` in the
tests).

The port runs ``train_fsdp``: the batch over the whole mesh and, when the
layout names a model axis (``make_layout`` always does), the parameters
and moments ZeRO-3 over it (``launch.train``, ``dist.collectives.Zero3``);
a hand-built ``Layout`` without a model axis is pure data parallelism.
It runs ``train_sp`` too: the batch over the dp axes, the sequence over
the model axis and the parameters ZeRO-3 over it.  Under ``train_sp``
every activation a rank holds is its own columns of the sequence (the
model's forward takes them from the full batch it is given): ``act``
says by its ``seq`` argument whether a tensor is that slice or the full
sequence, and never guesses it from a shape; every arch runs there, the
SSM blocks through the reference's prefix, halo and gathered scan
(``models.ssm``).  ``decode_tp`` raises by name
(:func:`require_data_parallel`); nothing falls back to one process.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

from torch.utils.checkpoint import checkpoint

from repro_torch.tree import leaves as tree_leaves

MODES = ("local", "train_sp", "train_fsdp", "decode_tp")

#: what each unported part of a layout waits for (ROADMAP A.15's slices)
WAITS_FOR = {
    # ported: ZeRO-3 over the model axis under train_fsdp, with zero1
    "model": "ROADMAP A.15.2 (ZeRO-3 over the model axis, state_shardings "
             "and zero1; ported for train_fsdp)",
    # ported: the sequence over the model axis, K/V gathered, the vocab
    # ring, the MoE all-to-all, the halo, and (A.15.3b) the SSM branches
    "train_sp": "ROADMAP A.15.3 (train_sp: sequence parallelism, the ring "
                "CE and the MoE all-to-all; ported, the SSM archs in "
                "A.15.3b)",
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


def is_zero3(lay) -> bool:
    """True for a layout whose parameters are ZeRO-3 over a model axis:
    ``train_fsdp`` or ``train_sp`` on a mesh with a model axis (of any
    size, 1 included: every collective still runs)."""
    return (isinstance(lay, Layout) and lay.mesh is not None
            and lay.mode in ("train_fsdp", "train_sp")
            and lay.model_axis is not None)


def seq_parallel(lay=None) -> bool:
    """True when ``lay`` (default: the active layout) splits the sequence
    over its model axis: ``train_sp`` on a mesh."""
    lay = layout() if lay is None else lay
    return (isinstance(lay, Layout) and lay.mesh is not None
            and lay.mode == "train_sp" and lay.model_axis is not None)


def require_data_parallel(lay: Layout, what: str) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item that ``what``
    waits for under ``lay``: ``decode_tp``; or, for anything but a
    :class:`Layout` (the reference's own, say), that the port runs none.
    LOCAL, pure data-parallel layouts, ``train_fsdp`` with a model axis of
    any size (ZeRO-3) and ``train_sp`` pass."""
    if not isinstance(lay, Layout):
        raise NotImplementedError(
            f"{what} takes a repro_torch.dist.sharding.Layout; a "
            f"{type(lay).__name__} is not a layout the port runs")
    if lay.mesh is None:
        return
    if lay.mode == "decode_tp":
        raise NotImplementedError(
            f"{what} under a {lay.mode} layout is not ported yet: it waits "
            f"for {WAITS_FOR[lay.mode]}")


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


def _leaf_paths(node, path=()):
    """Every leaf's path, in ``repro_torch.tree.leaves`` order (dict keys
    sorted)."""
    if isinstance(node, dict):
        return [p for k in sorted(node)
                for p in _leaf_paths(node[k], path + (str(k),))]
    if isinstance(node, (list, tuple)):
        return [p for i, v in enumerate(node)
                for p in _leaf_paths(v, path + (str(i),))]
    return ["/".join(path)]


# ---------------------------------------------------------------------------
# The shard plan: each leaf's slice and its columns in shard-major order.
# ---------------------------------------------------------------------------


def _row_major(shape):
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


@dataclass(frozen=True)
class LeafPlan:
    """One leaf of a :class:`ShardPlan`."""
    path: str
    shape: Tuple[int, ...]   # the full leaf's
    dim: Optional[int]       # sharded over the model axis here; None:
    #                          replicated
    wide: bool               # zero1: its moments also split over "data"
    offset: int              # its first column in its run (ShardPlan)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclass(frozen=True)
class ShardPlan:
    """Where every leaf of a parameter tree lies under a ZeRO-3 layout.

    T is the model axis's size and D the "data" axis's under zero1 (else
    1).  A leaf sharded on dim k splits there into T slices; the rank at
    index s on the model axis holds slice s.  With zero1, a leaf whose
    dim k T·D divides is *wide*: its moments split into T·D pieces, and
    the rank at (s, d) holds piece s·D + d, the d-th part of its slice
    (the reference's ``(model, "data")`` spec, model major).  A leaf with
    no such dim is replicated.

    A full (N,) gradient buffer is shard-major: T blocks of ``block``
    columns, block s holding slice s of every sharded leaf (first D runs
    of ``wide`` columns, run d holding piece s·D + d of every wide leaf,
    then ``narrow`` columns holding slice s of the other sharded leaves),
    then the replicated leaves whole.  So a reduce-scatter of the blocks
    hands each rank its slices in one contiguous piece, and one of its D
    runs its zero1 pieces.  Each leaf's ``offset`` is its first column in
    its run (wide, narrow or replicated).
    """
    leaves: Tuple[LeafPlan, ...]
    n_shards: int            # T
    n_data: int              # D
    shard: int               # s: this rank's index on the model axis
    data: int                # d: its index on "data" (0 without zero1)
    wide: int                # columns of one run of wide pieces
    narrow: int              # columns of the other slices in a block
    replicated: int          # columns of the replicated leaves
    zero1: bool = False

    @property
    def block(self) -> int:
        return self.n_data * self.wide + self.narrow

    @property
    def size(self) -> int:
        """N, the columns of a full buffer."""
        return self.n_shards * self.block + self.replicated

    def _parts(self, leaf):
        return (self.n_shards, self.n_data) if leaf.wide else (
            self.n_shards,)

    def slice_shape(self, i, moments=False) -> Tuple[int, ...]:
        """Leaf i's shape on a rank: its slice, or (``moments``) its
        moments' piece; the whole leaf when replicated."""
        leaf = self.leaves[i]
        if leaf.dim is None:
            return leaf.shape
        shape = list(leaf.shape)
        shape[leaf.dim] //= (math.prod(self._parts(leaf)) if moments
                             else self.n_shards)
        return tuple(shape)

    def slice_of(self, i, full, moments=False):
        """This rank's slice of the full leaf ``full`` (a view), or its
        moments' piece (``moments``)."""
        leaf = self.leaves[i]
        if leaf.dim is None:
            return full
        n = leaf.shape[leaf.dim] // self.n_shards
        start = self.shard * n
        if moments and leaf.wide:
            n //= self.n_data
            start += self.data * n
        return full.narrow(leaf.dim, start, n)

    def columns(self, i, row):
        """Leaf i's columns in the flat row ``row`` (N,), as a view: the
        leaf's shape (replicated) or, for a sharded leaf, its shape with
        dim k split into (T, n) or, when wide, (T, D, n) — a strided view
        of T (T·D) runs, which :meth:`split` of the full leaf matches."""
        leaf = self.leaves[i]
        if leaf.dim is None:
            a = self.n_shards * self.block + leaf.offset
            return row[a:a + leaf.size].view(leaf.shape)
        k, parts = leaf.dim, self._parts(leaf)
        piece = list(leaf.shape)
        piece[k] //= math.prod(parts)
        st = _row_major(piece)
        jumps = (self.block, self.wide) if leaf.wide else (self.block,)
        size = leaf.shape[:k] + parts + (piece[k],) + leaf.shape[k + 1:]
        stride = st[:k] + jumps + (st[k],) + st[k + 1:]
        base = leaf.offset if leaf.wide else (self.n_data * self.wide
                                              + leaf.offset)
        return row.as_strided(size, stride, row.storage_offset() + base)

    def split(self, i, x):
        """The full leaf ``x`` viewed in :meth:`columns`' shape."""
        leaf = self.leaves[i]
        if leaf.dim is None:
            return x
        parts = self._parts(leaf)
        return x.unflatten(leaf.dim, parts + (
            leaf.shape[leaf.dim] // math.prod(parts),))

    def local(self, i, wide, narrow, replicated):
        """Leaf i's part of a rank's reduced buffers, as a view shaped
        like its moments' piece: ``wide`` (its run of wide pieces),
        ``narrow`` (its other slices) or ``replicated``."""
        leaf = self.leaves[i]
        src = (replicated if leaf.dim is None
               else wide if leaf.wide else narrow)
        shape = self.slice_shape(i, moments=True)
        return src[leaf.offset:leaf.offset + math.prod(shape)].view(shape)

    def axes(self, i, model_axis, moments=False):
        """Leaf i's (dim, mesh axes), or None when replicated: the
        reference's ``state_shardings`` spec."""
        leaf = self.leaves[i]
        if leaf.dim is None:
            return None
        if moments and leaf.wide:
            return leaf.dim, (model_axis, "data")
        return leaf.dim, (model_axis,)


def shard_plan(tree, lay: Layout, *, zero1: bool = False,
               stacked_paths: Sequence[str] = ()) -> ShardPlan:
    """The :class:`ShardPlan` of a parameter tree (any leaves with a
    ``shape``: tensors, the meta device's, JAX's shape structs) under
    ``lay``: :func:`placement`'s dims, and with ``zero1`` the reference's
    ``widen`` rule (the moments of a leaf sharded on dim k also split
    over "data" where T·D divides dim k).  Under LOCAL or a layout without
    a model axis every leaf is replicated.  The reference cannot place
    zero1's moments where the model axis is "data" itself (a spec names
    an axis once); that raises ``ValueError`` here too."""
    dims = tree_leaves(placement(tree, lay, stacked_paths=stacked_paths))
    shapes = [tuple(int(n) for n in x.shape) for x in tree_leaves(tree)]
    mesh, m = lay.mesh, lay.model_axis
    T = lay.n_shards
    D = (mesh.shape["data"] if zero1 and mesh is not None
         and "data" in lay.dp else 1)
    leaves, runs = [], {"wide": 0, "narrow": 0, "replicated": 0}
    for path, shape, k in zip(_leaf_paths(tree), shapes, dims):
        wide = (zero1 and mesh is not None and k is not None
                and shape[k] % (T * D) == 0)
        if wide and m == "data":
            raise ValueError(
                f"zero1 under {lay.mode} on {dict(mesh.shape)}: the moments "
                f"of {path!r} would split over ('data', 'data'); the model "
                f"axis is 'data' itself (the reference's NamedSharding "
                f"refuses a spec that names an axis twice)")
        run = ("replicated" if k is None else "wide" if wide else "narrow")
        leaves.append(LeafPlan(path, shape, k, bool(wide), runs[run]))
        n = math.prod(shape)
        runs[run] += (n if k is None else n // (T * D) if wide else n // T)
    index = getattr(mesh, "index", None)
    s = index((m,)) if callable(index) and m is not None else 0
    d = index(("data",)) if callable(index) and D > 1 else 0
    return ShardPlan(tuple(leaves), T, D, int(s), int(d), runs["wide"],
                     runs["narrow"], runs["replicated"], bool(zero1))


# ---------------------------------------------------------------------------
# Use sites: the weights' gather, the block remat, the activation rule.
# ---------------------------------------------------------------------------


_gather_var: contextvars.ContextVar[Optional[Callable]] = (
    contextvars.ContextVar("repro_torch_gather", default=None))


@contextlib.contextmanager
def gathering(fn: Callable):
    """Install ``fn`` (tree, local -> the tree with its ZeRO-3 shards
    gathered, or with ``local`` used where they lie) as :func:`use_weight`'s
    gather and :func:`use_shard`'s; a ZeRO-3 train step installs its
    ``dist.collectives.Zero3`` session around its forward and backward."""
    tok = _gather_var.set(fn)
    try:
        yield fn
    finally:
        _gather_var.reset(tok)


def use_weight(tree):
    """The reference's use-site gather of ZeRO-3-sharded weights: ``tree``
    with every shard the active gather knows replaced by its full weight,
    all of them in one gather (one collective a block).  The identity
    when no gather is active (LOCAL, pure data parallelism, serving) and
    for leaves that are not shards (already gathered, or replicated)."""
    fn = _gather_var.get()
    return tree if fn is None else fn(tree, False)


def use_shard(tree):
    """This rank's ZeRO-3 slice of every leaf of ``tree``, used where it
    lies: the vocab ring's block of the head and expert parallelism's
    bank under ``train_sp``.  Inside a ZeRO-3 step the leaves are the
    shards, and each one's gradient, which is its slice's whole gradient,
    reaches its slice of the full-shaped gradient (zeros elsewhere), so
    the step's reduce-scatter hands it to this rank unsummed.  Outside
    one the leaves are full and this is their slice on
    :func:`placement`'s dim (a view; autograd pads its gradient with
    zeros); a replicated leaf is kept whole.  The identity under a layout
    without a model axis."""
    fn = _gather_var.get()
    if fn is not None:
        return fn(tree, True)
    lay = layout()
    if lay.mesh is None or lay.model_axis is None:
        return tree
    dims = placement(tree, lay)
    T, s = lay.n_shards, lay.mesh.index((lay.model_axis,))

    def cut(x, k):
        if k is None:
            return x
        n = x.shape[k] // T
        return x.narrow(k, s * n, n)

    return _zip_map(cut, tree, dims)


def _zip_map(fn, node, other):
    if isinstance(node, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_zip_map(fn, v, o) for v, o in zip(node, other))
    return fn(node, other)


def remat(fn, *args):
    """``fn(*args)``; while a gather is active, under activation
    checkpointing: the block's gathered weights and activations go after
    its forward and are made again, the gather included, in the backward,
    so a rank holds one or two blocks gathered at a time (the reference
    rematerializes each layer too).  The recompute runs in a copy of the
    caller's context variables (the gather, the layout, the knobs): the
    backward may run on another thread."""
    if _gather_var.get() is None:
        return fn(*args)
    snap = contextvars.copy_context()

    def run(*a):
        return snap.copy().run(fn, *a)

    return checkpoint(run, *args, use_reentrant=False)


def seq_span(S: int, lay=None) -> Tuple[int, int]:
    """(start, length): this rank's columns of a full sequence of ``S``
    under ``train_sp`` (rank s of T on the model axis holds ``[s S/T,
    (s+1) S/T)``); ``(0, S)`` under every other layout.  ``S`` must
    divide by T: anything else raises ``ValueError`` naming both."""
    lay = layout() if lay is None else lay
    if not seq_parallel(lay):
        return 0, S
    T = lay.n_shards
    if S % T:
        raise ValueError(f"train_sp splits the sequence over the "
                         f"{lay.model_axis!r} axis's {T} ranks: a length of "
                         f"{S} does not divide by {T}")
    n = S // T
    return lay.mesh.index((lay.model_axis,)) * n, n


def seq_last(lay=None) -> bool:
    """False on a ``train_sp`` rank whose columns are not the sequence's
    last, True elsewhere: the rank that carries the gradient of a state
    every rank holds whole (the reference's ``psum`` of the last shard's)."""
    lay = layout() if lay is None else lay
    if not seq_parallel(lay):
        return True
    return lay.mesh.index((lay.model_axis,)) == lay.n_shards - 1


def seq_shard(x, dim: int = 1):
    """This rank's columns of ``x``'s full sequence dim ``dim`` under
    ``train_sp`` (a view), ``x`` itself under every other layout."""
    if not seq_parallel():
        return x
    return x.narrow(dim, *seq_span(x.shape[dim]))


def act(x, dp=None, sp=None, tp=None, *, seq: str = "local"):
    """The reference's activation constraint on dims (batch, seq,
    feature).

    The identity under LOCAL and ``train_fsdp``: each rank already holds
    only its own batch rows, whole, which is what the constraint asks
    there.  Under ``train_sp`` the caller says what ``x``'s dim 1 is:
    ``seq="local"`` (this rank's columns, what every activation of the
    model is) or ``seq="full"`` (the whole sequence).  ``sp="sp"`` then
    keeps a local ``x`` and takes this rank's columns of a full one;
    ``sp=None`` keeps a full ``x`` and gathers a local one over the model
    axis (its backward a reduce-scatter).  ``decode_tp`` splits the
    features across ranks: it raises by name."""
    if seq not in ("local", "full"):
        raise ValueError(f"act: seq={seq!r}, want 'local' or 'full'")
    lay = layout()
    if lay.mesh is None:
        return x
    require_data_parallel(lay, "an activation constraint")
    if not seq_parallel(lay):
        return x
    if sp == "sp":
        return x if seq == "local" else seq_shard(x, 1)
    if seq == "full":
        return x
    from repro_torch.dist import collectives   # collectives imports this
    return collectives.seq_gather(x, 1)
