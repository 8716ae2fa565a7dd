"""Port vs JAX package on the CPU: the layout rules of ``dist.sharding``.

``make_layout``, ``Layout``'s properties and the ZeRO-3 placement rule of
the reference's ``named_sharding`` for every mode on the shape-only meshes
(8,) ("data",), (2, 4) ("data", "model") and (2, 2, 2) ("pod", "data",
"model") (``jax.sharding.AbstractMesh``, which both packages read: no
devices, no process group), over the full-size qwen2-0.5b tree with the
reference's ``stacked_paths_for`` (abstract leaves: JAX's shape structs
and the port's meta tensors of the same shapes), and over the reference's own
``tests/sharded/dist_check.py`` leaves.  Then the parts the port does
not run raise by name (``decode_tp``), and ``train_fsdp`` with a model
axis (ZeRO-3) passes, its shard plan the reference's ``named_sharding``.
``train_sp`` passes too (``tests/test_torch_sp_*.py`` hold it).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import get_config as jget
from repro.dist import sharding as jshd
from repro.launch.train import stacked_paths_for as j_stacked_paths_for
from repro.models import model as JM
from repro_torch.configs.base import get_config as tget
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.launch import ranks
from repro_torch.launch import train as TT
from repro_torch.models import model as TM
from repro_torch.perf.knobs import use_knobs

MESHES = [((8,), ("data",)), ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
MODES = ("train_sp", "train_fsdp", "decode_tp")


def _mesh(shape, axes):
    return AbstractMesh(shape, axes)


def _spec_dims(ns, model_axis):
    """A NamedSharding's spec -> the dim sharded over the model axis."""
    for i, ax in enumerate(ns.spec):
        if ax == model_axis:
            return i
    return None


@pytest.mark.parametrize("shape, axes", MESHES)
@pytest.mark.parametrize("mode", MODES)
def test_make_layout_matches_reference(shape, axes, mode):
    mesh = _mesh(shape, axes)
    j, t = jshd.make_layout(mesh, mode), shd.make_layout(mesh, mode)
    for f in ("mode", "dp", "model_axis", "seq_axis", "tp_axis", "dp_size",
              "n_shards"):
        assert getattr(t, f) == getattr(j, f), f
    for kind in (None, "dp", "sp", "tp"):
        assert t.axis(kind) == j.axis(kind)
    for b in (1, 2, 4, 6, 8, 16, 24):
        assert t.dp_for(b) == j.dp_for(b)


def test_local_layout_and_bad_modes_match_reference():
    assert shd.make_layout(None, "train_sp") is shd.LOCAL
    for f in ("mode", "dp", "model_axis", "dp_size", "n_shards"):
        assert getattr(shd.LOCAL, f) == getattr(jshd.LOCAL, f)
    mesh = _mesh((2, 4), ("data", "model"))
    for bad in ("local", "zero"):
        with pytest.raises(ValueError):
            jshd.make_layout(mesh, bad)
        with pytest.raises(ValueError, match="unknown layout mode"):
            shd.make_layout(mesh, bad)
    with pytest.raises(ValueError):
        shd.LOCAL.axis("pp")


def test_layout_is_a_context_variable():
    lay = shd.make_layout(_mesh((2, 4), ("data", "model")), "train_fsdp")
    assert shd.layout() is shd.LOCAL
    with shd.use_layout(lay):
        assert shd.layout() is lay
        with shd.use_layout(shd.LOCAL):
            assert shd.layout() is shd.LOCAL
        assert shd.layout() is lay
    assert shd.layout() is shd.LOCAL


@pytest.fixture(scope="module")
def qwen2_tree():
    cfg = jget("qwen2-0.5b")
    return jax.eval_shape(lambda: JM.init_model(cfg, jax.random.PRNGKey(0)))


def _meta(tree):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


@pytest.mark.parametrize("shape, axes", MESHES)
@pytest.mark.parametrize("mode", MODES)
def test_placement_matches_named_sharding_on_the_full_qwen2_tree(
        qwen2_tree, shape, axes, mode):
    mesh = _mesh(shape, axes)
    sp = j_stacked_paths_for(jget("qwen2-0.5b"))
    jlay, tlay = jshd.make_layout(mesh, mode), shd.make_layout(mesh, mode)
    want = jax.tree.leaves(jax.tree.map(
        lambda ns: _spec_dims(ns, jlay.model_axis),
        jshd.named_sharding(qwen2_tree, jlay, stacked_paths=sp)),
        is_leaf=lambda x: x is None)
    for leaves in (qwen2_tree, _meta(qwen2_tree)):
        got = jax.tree.leaves(shd.placement(leaves, tlay, stacked_paths=sp),
                              is_leaf=lambda x: x is None)
        assert got == want
    # some leaves shard, and the stacked ones never on their repeats dim
    assert any(d is not None for d in want)
    assert 0 not in [d for (p, _), d in zip(
        jax.tree_util.tree_leaves_with_path(qwen2_tree), want)
        if p[0].key == "segments"]


def test_placement_matches_reference_dist_check_leaves():
    """The leaves of the reference's ``tests/sharded/dist_check.py`` at
    tp = 4: indivisible replicates, first divisible dim, FSDP dim 0,
    stacked dim 1, decode_tp's last dim; and LOCAL places nothing."""
    mesh = _mesh((2, 4), ("data", "model"))
    leaves = {"w": np.ones((3, 5)), "v": np.ones((3, 8)),
              "u": np.ones((8, 5)), "seg": [np.ones((3, 8, 5))]}
    for mode in MODES:
        jlay, tlay = jshd.make_layout(mesh, mode), shd.make_layout(mesh,
                                                                   mode)
        want = jax.tree.map(
            lambda ns: _spec_dims(ns, jlay.model_axis),
            jshd.named_sharding(leaves, jlay, stacked_paths=("seg",)))
        got = shd.placement(leaves, tlay, stacked_paths=("seg",))
        assert got == want, mode
    assert shd.placement(leaves, shd.make_layout(mesh, "train_sp"),
                         stacked_paths=("seg",)) == {
        "w": None, "v": 1, "u": 0, "seg": [1]}
    assert shd.placement({"u": np.ones((8, 12))},
                         shd.make_layout(mesh, "decode_tp")) == {"u": 1}
    assert shd.placement(leaves, shd.LOCAL) == {
        "w": None, "v": None, "u": None, "seg": [None]}


def test_placement_of_the_ports_own_tree():
    """The port's tree keeps one dict a layer (no stacked dims): each
    layer's leaf takes the dim the reference's stacked leaf takes, less
    the repeats dim."""
    cfg = tget("qwen2-0.5b")
    params = TM.init_model(cfg, None, device="meta")
    lay = shd.make_layout(_mesh((2, 4), ("data", "model")), "train_fsdp")
    dims = shd.placement(params, lay)
    assert dims["embed"]["table"] == 0
    for layer in dims["layers"]:
        assert layer["attn"]["wq"] == 0 and layer["attn"]["bk"] == 0
        assert layer["mlp"]["w_down"] == 0


# the id is the one this case had beside the two train_fsdp cases
# (shape2, shape3) that ZeRO-3 retired and the two train_sp cases
# (shape0, shape4) that sequence parallelism retired
@pytest.mark.parametrize("shape, axes, mode, item", [
    pytest.param((2, 4), ("data", "model"), "decode_tp", "A.15.4",
                 id="shape1-axes1-decode_tp-A.15.4"),
])
def test_unported_layouts_raise_by_name(shape, axes, mode, item):
    lay = shd.make_layout(_mesh(shape, axes), mode)
    grads = {"w": torch.ones(4, 3)}
    with pytest.raises(NotImplementedError, match=item):
        collectives.masked_grad_mean(grads, torch.ones(4), lay)
    with pytest.raises(NotImplementedError, match=item):
        collectives.grad_mean(grads, lay)
    with pytest.raises(NotImplementedError, match=item):
        TT._dp(lay)
    with use_knobs(ce_impl="ring"), shd.use_layout(lay):
        with pytest.raises(NotImplementedError, match=item):
            TT.make_loss_fn(None)(None, {}, 1.0)


@pytest.mark.parametrize("shape, axes", [((2, 4), ("data", "model")),
                                         ((8,), ("data",))])
def test_zero3_layouts_pass_and_plan_as_named_sharding(qwen2_tree, shape,
                                                       axes):
    """The two ``train_fsdp`` layouts with a model axis of more than one
    shard (the model axis "model", and "data" itself on a 1-D mesh) pass
    ``require_data_parallel``; their shard plan's dims are ``placement``'s
    and the reference's ``named_sharding``'s, leaf for leaf."""
    mesh = _mesh(shape, axes)
    lay = shd.make_layout(mesh, "train_fsdp")
    assert lay.n_shards > 1 and shd.is_zero3(lay)
    shd.require_data_parallel(lay, "a step")
    sp = j_stacked_paths_for(jget("qwen2-0.5b"))
    jlay = jshd.make_layout(mesh, "train_fsdp")
    want = jax.tree.leaves(jax.tree.map(
        lambda ns: _spec_dims(ns, jlay.model_axis),
        jshd.named_sharding(qwen2_tree, jlay, stacked_paths=sp)),
        is_leaf=lambda x: x is None)
    plan = shd.shard_plan(_meta(qwen2_tree), lay, stacked_paths=sp)
    assert [leaf.dim for leaf in plan.leaves] == want
    assert [leaf.dim for leaf in plan.leaves] == jax.tree.leaves(
        shd.placement(qwen2_tree, lay, stacked_paths=sp),
        is_leaf=lambda x: x is None)
    assert plan.n_shards == lay.n_shards


def test_pure_data_parallel_layouts_pass():
    for lay in (shd.LOCAL,
                shd.make_layout(_mesh((8, 1), ("data", "model")),
                                "train_fsdp"),
                shd.Layout(mesh=_mesh((8,), ("data",)), mode="train_fsdp",
                           dp=("data",))):
        shd.require_data_parallel(lay, "a step")
        assert lay.n_shards == 1


def test_ring_ce_raises_under_train_sp_and_is_dense_elsewhere(tmp_path):
    """Outside ``train_sp`` the ring CE is the dense sum, bit for bit.
    Under ``train_sp`` (once a raise, now the vocab ring) it runs: on a
    (1, 1) mesh of one gloo rank the one block's stream is the dense sum
    within ring_ce_check's loss bar (1e-4), its dx within 1e-3; more
    ranks are ``tests/test_torch_sp_ring_ce.py``'s."""
    cfg = tget("qwen2-0.5b").reduced()
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, cfg.d_model, generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (2, 4), generator=gen)
    dense = TM._ce_sum_dense(TM.lm_logits(cfg, params, x), labels)
    fsdp = shd.Layout(mesh=_mesh((2,), ("data",)), mode="train_fsdp",
                      dp=("data",))
    for lay in (shd.LOCAL, fsdp):
        with shd.use_layout(lay):
            assert torch.equal(TM.ring_ce_sum(cfg, params, x, labels), dense)
    xr = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(
        TM._ce_sum_dense(TM.lm_logits(cfg, params, xr), labels), xr)
    np_params = {k: v for k, v in params.items()}
    (loss, got_dx, _), = ranks.spawn(
        ranks.sp_ring_ce, 1,
        [(cfg, np_params, x.numpy(), labels.numpy(), None)],
        init_method=f"file://{tmp_path}/pg")[0]
    assert abs(loss - float(dense)) < 1e-4
    assert float(np.abs(got_dx - dx.numpy()).max()) < 1e-3
