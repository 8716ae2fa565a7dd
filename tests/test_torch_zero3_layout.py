"""Port vs JAX package on the CPU: ZeRO-3's placement and shard plan.

``launch.train.state_shardings`` (params, m, v, mu and ef; ``zero1`` off
and on) against the reference's ``state_shardings`` on the shape-only
meshes (2, 4), (1, 2) and (2, 2) ("data", "model") and (8,) ("data",)
(``jax.sharding.AbstractMesh``, which both packages read), over the
full-size qwen2-0.5b tree and every registered arch's reduced tree: the
reference's scan-stacked leaf is matched to the port's per-layer leaves,
its repeats dim dropped.  Then ``dist.sharding.ShardPlan`` on a small
hand-built tree with a leaf sharded on dim 0, one on dim 1 and a
replicated one: a full gradient written into its shard-major columns,
the plain masked sum, and the split per shard equal the natural-order
sum's slices bit for bit, with and without zero1's pieces; the
``WorkerGrads`` of a plan; the use-site helpers outside a ZeRO-3 step.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import all_archs
from repro.configs.base import get_config as jget
from repro.dist import sharding as jshd
from repro.launch import train as JT
from repro.models import model as JM
from repro_torch import tree
from repro_torch.configs.base import get_config as tget
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch import train as TT
from repro_torch.models import model as TM
from repro_torch.perf.knobs import knobs, use_knobs

MESHES = [((2, 4), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((8,), ("data",))]
ARCHS = sorted(all_archs())


def _spec(ns, stacked):
    """A reference NamedSharding -> (dim, mesh axes) of the port's
    per-layer leaf, or None."""
    if ns is None:
        return None
    for i, ax in enumerate(ns.spec):
        if ax is not None:
            axes = ax if isinstance(ax, tuple) else (ax,)
            return (i - 1 if stacked else i), tuple(axes)
    return None


def _unstack(specs, segments):
    """A reference segments list of NamedShardings -> one entry a layer,
    in the port's order, each spec's repeats dim dropped."""
    out = []
    for seg, sp in zip(TM.build_segments(specs), segments):
        for _ in range(seg.repeats):
            for c in sp:
                out.append(jax.tree.map(
                    lambda ns, st=seg.repeats > 1: _spec(ns, st), c))
    return out


def _as_port(tc, jtree):
    """A reference tree of NamedShardings shaped like its params -> the
    port's structure, leaves (dim, axes) or None."""
    flat = lambda t: jax.tree.map(lambda ns: _spec(ns, False), t)  # noqa
    out = {k: flat(v) for k, v in jtree.items()
           if k not in ("segments", "encoder")}
    out["layers"] = _unstack(TM.layer_specs(tc), jtree["segments"])
    if "encoder" in jtree:
        enc = jtree["encoder"]
        out["encoder"] = dict(
            {k: flat(v) for k, v in enc.items() if k != "segments"},
            layers=_unstack(TM.encoder_layer_specs(tc), enc["segments"]))
    return out


def _leaves(t):
    return jax.tree.leaves(t, is_leaf=lambda x: x is None
                           or isinstance(x, tuple))


def _check_state_shardings(jc, tc, shape, axes, zero1):
    mesh = AbstractMesh(shape, axes)
    jlay, tlay = (jshd.make_layout(mesh, "train_fsdp"),
                  shd.make_layout(mesh, "train_fsdp"))
    jparams = jax.eval_shape(lambda: JM.init_model(jc,
                                                   jax.random.PRNGKey(0)))
    tparams = TM.init_model(tc, None, device="meta")
    if zero1 and axes == ("data",):
        # the model axis is "data" itself: neither places zero1's moments
        with pytest.raises(Exception, match="data"):
            JT.state_shardings(jc, jparams, jlay, zero1=True, has_ef=True)
        with pytest.raises(ValueError, match="'data', 'data'"):
            TT.state_shardings(tc, tparams, tlay, zero1=True, has_ef=True)
        return
    want = JT.state_shardings(jc, jparams, jlay, zero1=zero1, has_ef=True)
    got = TT.state_shardings(tc, tparams, tlay, zero1=zero1, has_ef=True)
    assert got["opt"]["step"] is None and want["opt"]["step"] is not None
    for part in (("params",), ("opt", "m"), ("opt", "v"), ("opt", "mu"),
                 ("ef",)):
        w, g = want, got
        for k in part:
            w, g = w[k], g[k]
        w = _as_port(tc, w)
        assert _leaves(g) == _leaves(w), part
        assert len(_leaves(g)) == len(tree.leaves(tparams))
    return got


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("shape, axes", MESHES)
def test_state_shardings_match_reference_on_the_full_qwen2_tree(
        shape, axes, zero1):
    got = _check_state_shardings(jget("qwen2-0.5b"), tget("qwen2-0.5b"),
                                 shape, axes, zero1)
    if got is None:
        return
    dims = [d for d in _leaves(got["params"]) if d is not None]
    assert dims            # something shards
    if zero1 and shape == (2, 4):
        # the embedding (151936 rows) splits over model x data
        assert got["opt"]["m"]["embed"]["table"] == (0, ("model", "data"))


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_state_shardings_match_reference_for_every_reduced_arch(name,
                                                                zero1):
    for shape, axes in MESHES:
        _check_state_shardings(jget(name).reduced(), tget(name).reduced(),
                               shape, axes, zero1)


def test_state_shardings_under_local_are_replicated():
    cfg = tget("qwen2-0.5b").reduced()
    params = TM.init_model(cfg, None, device="meta")
    out = TT.state_shardings(cfg, params, shd.LOCAL, zero1=True)
    assert all(x is None for x in _leaves(out["params"]))
    assert all(x is None for x in _leaves(out["opt"]["m"]))
    assert "ef" not in out


# ---------------------------------------------------------------------------
# The shard plan.
# ---------------------------------------------------------------------------


class _Rank:
    """A shape-only mesh on which this process sits at ``coords``."""

    def __init__(self, shape, axes, coords):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.coords = dict(zip(axes, coords))

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i


def _tree(seed=0):
    """A leaf sharded on dim 0 (8 rows), one on dim 1 (3 rows, 12
    columns), a replicated one (5,) and a 0-d one.  The values are
    multiples of 1/16 below 4, so every sum of a few of them, weighted
    by a dyadic mask, is exact in f32 in any order: torch's CPU sum over
    dim 0 rounds differently at different column alignments, and the
    test is of the columns, not of that order (on the card the kernel
    adds each column over W in one order wherever it lies, and
    ``chip_smoke.py`` holds it bit for bit on random data)."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return torch.from_numpy((rng.integers(-64, 64, shape) / 16.0)
                                .astype(np.float32))

    return {"a": leaf(8, 3), "b": {"w": leaf(3, 12)}, "c": leaf(5),
            "d": torch.tensor(0.5)}


def _plan(T, D, s, d, zero1):
    lay = shd.make_layout(_Rank((D, T), ("data", "model"), (d, s)),
                          "train_fsdp")
    return shd.shard_plan(_tree(), lay, zero1=zero1)


@pytest.mark.parametrize("T, D, zero1", [(2, 1, False), (2, 2, False),
                                         (2, 2, True), (4, 1, True)])
def test_the_plan_places_dim0_dim1_and_replicated_leaves(T, D, zero1):
    plan = _plan(T, D, 0, 0, zero1)
    dims = [leaf.dim for leaf in plan.leaves]
    assert dims == [0, 1, None, None]       # a, b/w, c, d
    assert [leaf.path for leaf in plan.leaves] == ["a", "b/w", "c", "d"]
    wide = [leaf.wide for leaf in plan.leaves]
    assert wide == [zero1 and 8 % (T * D) == 0, zero1 and 12 % (T * D) == 0,
                    False, False]
    assert plan.size == 8 * 3 + 3 * 12 + 5 + 1
    assert plan.replicated == 6
    assert plan.block * T == 24 + 36


@pytest.mark.parametrize("T, D, zero1", [(2, 1, False), (4, 1, False),
                                         (2, 2, True), (4, 2, True),
                                         (2, 3, True)])
def test_shard_major_sum_splits_into_the_natural_sums_slices(T, D, zero1):
    """W gradients written into the plan's columns, the plain masked sum
    (the kernel's sum mode on the CPU; a dyadic mask, so every sum is
    exact), then each rank's block (and zero1 run) cut out: the
    natural-order sum's slices, bit for bit."""
    W = 5
    grads = [_tree(seed) for seed in range(W)]
    mask = torch.tensor([1.0, 0.0, 1.0, 0.25, 1.0])
    nat = ops.WorkerGrads(grads[0], W)
    plan = _plan(T, D, 0, 0, zero1)
    sm = ops.WorkerGrads(grads[0], W, plan=plan)
    for w, g in enumerate(grads):
        for i, x in enumerate(tree.leaves(g)):
            nat.rows[w][i].copy_(x)
            sm.rows[w][i].copy_(sm.fit(i, x))
    want = ops.masked_aggregate(nat.buf, mask, mean=False)
    got = ops.masked_aggregate(sm.buf, mask, mean=False)
    full = nat._split(want)
    for s in range(T):
        for d in range(D):
            p = _plan(T, D, s, d, zero1)
            block = got[s * p.block:(s + 1) * p.block]
            wide = block[d * p.wide:(d + 1) * p.wide]
            narrow = block[p.n_data * p.wide:]
            rep = got[T * p.block:]
            for i in range(len(p.leaves)):
                assert torch.equal(p.local(i, wide, narrow, rep),
                                   p.slice_of(i, full[i], moments=True)), \
                    (s, d, i)
                if not p.leaves[i].wide:
                    continue
                # the slice is the D pieces of its block's runs, in order
                sl = torch.cat([p.local(i, block[e * p.wide:
                                                 (e + 1) * p.wide],
                                        narrow, rep)
                                for e in range(D)], dim=p.leaves[i].dim)
                assert torch.equal(sl, p.slice_of(i, full[i]))


def test_columns_cover_the_buffer_once():
    plan = _plan(2, 2, 1, 1, True)
    row = torch.zeros(plan.size)
    for i, leaf in enumerate(plan.leaves):
        plan.columns(i, row).add_(1.0)
    assert torch.equal(row, torch.ones(plan.size))
    with pytest.raises(ValueError, match="shard-major"):
        ops.WorkerGrads(_tree(), 1, plan=plan).unflatten(row)


def test_shard_tree_cuts_each_ranks_slice():
    full = _tree()
    for s in range(2):
        plan = _plan(2, 2, s, 1, True)
        sl = TT.shard_tree(full, plan)
        mo = TT.shard_tree(full, plan, moments=True)
        assert torch.equal(sl["a"], full["a"][4 * s:4 * s + 4])
        assert torch.equal(sl["b"]["w"], full["b"]["w"][:, 6 * s:6 * s + 6])
        assert torch.equal(mo["a"], full["a"][4 * s + 2:4 * s + 4])
        assert torch.equal(mo["b"]["w"],
                           full["b"]["w"][:, 6 * s + 3:6 * s + 6])
        assert sl["c"] is not full["c"] and torch.equal(sl["c"], full["c"])
        assert sl["a"].untyped_storage().data_ptr() != \
            full["a"].untyped_storage().data_ptr()


def test_the_ports_tree_plan_under_local_and_pure_dp_replicates():
    cfg = dataclasses.replace(tget("qwen2-0.5b").reduced(), n_layers=2)
    params = TM.init_model(cfg, None, device="meta")
    for lay in (shd.LOCAL, shd.Layout(mesh=_Rank((4,), ("data",), (1,)),
                                      mode="train_fsdp", dp=("data",))):
        plan = shd.shard_plan(params, lay)
        assert all(leaf.dim is None for leaf in plan.leaves)
        assert plan.size == plan.replicated == sum(
            x.numel() for x in tree.leaves(params))
        assert not shd.is_zero3(lay)


def test_use_sites_are_the_identity_outside_a_zero3_step():
    x = torch.ones(2, 3, 4)
    p = {"w": torch.ones(3)}
    fsdp = shd.make_layout(AbstractMesh((2, 2), ("data", "model")),
                           "train_fsdp")
    # train_sp (once a raise here): act keeps a tensor of this rank's
    # columns, which every activation of the model is
    sp = shd.make_layout(AbstractMesh((2, 2), ("data", "model")),
                         "train_sp")
    for lay in (shd.LOCAL, fsdp, sp):
        with shd.use_layout(lay):
            assert shd.act(x, "dp", "sp", None) is x
            assert shd.use_weight(p) is p
            assert shd.remat(lambda a: a, x) is x
    for mode, item in (("decode_tp", "A.15.4"),):
        lay = shd.make_layout(AbstractMesh((2, 2), ("data", "model")), mode)
        with shd.use_layout(lay):
            with pytest.raises(NotImplementedError, match=item):
                shd.act(x, "dp", "sp", None)


def test_fsdp_gather_takes_its_two_values():
    for v in ("wsc", "shardmap"):
        with use_knobs(fsdp_gather=v):
            assert knobs().fsdp_gather == v
    with pytest.raises(ValueError, match="fsdp_gather"):
        with use_knobs(fsdp_gather="gspmd"):
            pass
    assert knobs().fsdp_gather == "wsc"
