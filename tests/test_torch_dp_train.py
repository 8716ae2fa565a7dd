"""Port vs JAX package on the CPU: the data-parallel train step and Trainer.

(a) A reduced qwen2-0.5b (2 layers) with W = 4 workers trains 3 masked
steps on 2 gloo ranks (``launch.ranks.train_steps``: each rank its rows
and 2 workers), from weights carried by ``weights.from_jax``, against the
reference's ``make_train_step`` under LOCAL: every step drops at least one
worker.  The bars are the reference's own for its sharded step
(``tests/sharded/mask_agg_check.py``): loss within 1e-4, parameters
within 1e-3, on both ``mask_agg`` paths, with gradient accumulation,
fractional (anytime) contributions and stale reuse; int8 compression
keeps the ranks' replicas bit-equal.  The ranks run every case in one
process group (``launch.ranks.several``).  (b) The vocab-chunked CE,
``forward(head=False)`` and ``make_loss_fn`` under
``use_knobs(ce_chunk=...)`` against the reference.  The CLI's 2-rank
``Trainer`` is held in ``tests/test_torch_train_cutoff_sgd.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs.base import get_config as jget
from repro.core.aggregation import example_weights as j_example_weights
from repro.launch.train import jit_train_step
from repro.launch.train import make_loss_fn as j_make_loss_fn
from repro.models import model as JM
from repro.perf.knobs import Knobs as JKnobs
from repro.perf.knobs import use_knobs as j_use_knobs
from repro_torch import tree, weights
from repro_torch.configs.base import get_config as tget
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import ranks
from repro_torch.launch import train as TT
from repro_torch.models import model as TM
from repro_torch.perf.knobs import UNPORTED, Knobs, knobs, use_knobs

LR = 3e-3
W, B, S, R = 4, 8, 16, 2
LOSS_TOL, PARAM_TOL = 1e-4, 1e-3     # tests/sharded/mask_agg_check.py


def _cfgs(n_layers=2):
    return (dataclasses.replace(jget("qwen2-0.5b").reduced(),
                                n_layers=n_layers),
            dataclasses.replace(tget("qwen2-0.5b").reduced(),
                                n_layers=n_layers))


def _np(t):
    return jax.tree.map(np.asarray, t)


def _masks(n, fractional=False, seed=0):
    """A fresh random mask a step, always with at least one worker
    dropped (the reference's mask_agg_check schedule)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = (rng.uniform(size=W) < 0.7).astype(np.float32)
        m[rng.integers(W)] = 0.0
        if m.sum() == 0:
            m[0] = 1.0
        if fractional:
            m = np.where(m > 0, 1.0, rng.uniform(size=W)).astype(np.float32)
        out.append(m)
    return out


def _batches(cfg, masks, mask_agg):
    data = SyntheticTokens(cfg.vocab_size, S, B, seed=0)
    out = []
    for t, m in enumerate(masks):
        b = data.batch(t)
        if mask_agg == "psum":
            b["mask"] = m
        else:
            b["weights"] = j_example_weights(m, B)
        out.append(b)
    return out


def _jax_run(jc, params, batches, mask_agg, grad_accum=1, stale_decay=None):
    opt = joptim.adamw(LR)
    step = jit_train_step(jc, opt, donate=False, mask_agg=mask_agg,
                          grad_accum=grad_accum,
                          stale_reuse=stale_decay is not None)
    state = {"params": params, "opt": opt.init(params)}
    stale = (jax.tree.map(jnp.zeros_like, params), jnp.float32(0))
    losses = []
    for b in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if stale_decay is not None:
            jb.update(stale_g=stale[0],
                      stale_w=jnp.float32(stale_decay) * stale[1])
        state, m = step(state, jb)
        if stale_decay is not None:
            stale = m.pop("stale")
        losses.append(float(m["loss"]))
    return losses, state["params"]


CASES = {
    "weights": dict(mask_agg="weights"),
    "psum": dict(mask_agg="psum"),
    "weights_accum2": dict(mask_agg="weights", grad_accum=2),
    "psum_anytime_accum2": dict(mask_agg="psum", grad_accum=2,
                                fractional=True),
    "psum_stale": dict(mask_agg="psum", stale_decay=0.5),
    "psum_compress": dict(mask_agg="psum", compress=True),
}


def _case(name):
    kw = dict(CASES[name])
    fractional = kw.pop("fractional", False)
    jc, tc = _cfgs()
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    batches = _batches(jc, _masks(3, fractional), kw["mask_agg"])
    return jc, tc, params, batches, kw


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case's 3 steps on 2 gloo ranks, in one process group."""
    calls = []
    for name in sorted(CASES):
        _, tc, params, batches, kw = _case(name)
        p0 = tree.map(lambda x: x.numpy(),
                      weights.from_jax(tc, _np(params), device="cpu"))
        mask_agg = kw.pop("mask_agg")
        calls.append((ranks.train_steps, (tc, p0, batches, mask_agg, LR),
                      kw))
    pg = tmp_path_factory.mktemp("dp") / "pg"
    out = ranks.spawn(ranks.several, R, calls, init_method=f"file://{pg}")
    return {name: [rank[i] for rank in out]
            for i, name in enumerate(sorted(CASES))}


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if not c.endswith("compress")))
def test_two_rank_steps_match_reference_local(two_ranks, case):
    jc, tc, params, batches, kw = _case(case)
    want_losses, want_params = _jax_run(
        jc, params, batches, kw["mask_agg"], kw.get("grad_accum", 1),
        kw.get("stale_decay"))
    want = [x.astype(np.float32) for x in tree.leaves(
        tree.map(lambda x: x.numpy(),
                 weights.from_jax(tc, _np(want_params), device="cpu")))]
    out = two_ranks[case]
    for r, (metrics, got_params) in enumerate(out):
        got_losses = [m["loss"] for m in metrics]
        np.testing.assert_allclose(got_losses, want_losses, rtol=0,
                                   atol=LOSS_TOL, err_msg=f"rank {r}")
        got = tree.leaves(got_params)
        assert len(got) == len(want)
        dp = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        assert dp < PARAM_TOL, (r, dp)
        # the replicas stay bit-equal across ranks
        for a, b in zip(got, tree.leaves(out[0][1])):
            assert np.array_equal(a, b)


def test_two_rank_compression_keeps_replicas_equal(two_ranks):
    """int8 error-feedback compression of the all-reduced gradient: the
    ranks' replicas stay bit-equal, and the first step's loss (taken
    before any update) is the reference's."""
    jc, _, params, batches, _ = _case("psum_compress")
    want_losses, _ = _jax_run(jc, params, batches[:1], "psum")
    out = two_ranks["psum_compress"]
    assert abs(out[0][0][0]["loss"] - want_losses[0]) < LOSS_TOL
    for metrics, got in out:
        assert all(np.isfinite(m["loss"]) for m in metrics)
        for a, b in zip(tree.leaves(got), tree.leaves(out[0][1])):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# (b) The vocab-chunked CE.
# ---------------------------------------------------------------------------


def _ce_inputs(jc, tied, seed=0):
    jc = dataclasses.replace(jc, tie_embeddings=tied)
    rng = np.random.default_rng(seed)
    V, D = jc.vocab_size, jc.d_model
    head = ({"embed": {"table": rng.standard_normal((V, D))
                       .astype(np.float32)}} if tied else
            {"embed": {"table": np.zeros((V, D), np.float32)},
             "lm_head": {"w": rng.standard_normal((D, V))
                         .astype(np.float32) / np.sqrt(D)}})
    x = rng.standard_normal((3, 5, D)).astype(np.float32)
    labels = rng.integers(0, V, (3, 5)).astype(np.int32)
    labels[0, :3] = (V - 1, V - 2, V - 7)     # labels in the last chunk
    w = np.asarray([1.0, 0.0, 0.5], np.float32)
    return jc, head, x, labels, w


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("vchunk", [64, 100, 37, 256, 1000])
def test_chunked_ce_sum_matches_the_dense_ce(tied, vchunk):
    """Within 1e-5 of the reference's dense CE (the value it stands for)
    for every chunk width, weighted and not; within 1e-5 of the
    reference's chunked CE where the chunk divides V (256)."""
    jc, head, x, labels, w = _ce_inputs(_cfgs()[0], tied)
    tc = dataclasses.replace(_cfgs()[1], tie_embeddings=tied)
    th = tree.map(torch.from_numpy, head)
    for wt in (None, w):
        jw = None if wt is None else jnp.asarray(wt)
        dense = float(JM._ce_sum_dense(
            JM.lm_logits(jc, head, jnp.asarray(x)), jnp.asarray(labels), jw))
        got = float(TM.chunked_ce_sum(
            tc, th, torch.from_numpy(x), torch.from_numpy(labels),
            None if wt is None else torch.from_numpy(wt), vchunk))
        assert abs(got - dense) <= 1e-5 * abs(dense), (got, dense)
        if jc.vocab_size % vchunk == 0:
            jchunk = float(JM.chunked_ce_sum(jc, head, jnp.asarray(x),
                                             jnp.asarray(labels), jw, vchunk))
            assert abs(got - jchunk) <= 1e-5 * abs(jchunk)


def test_reference_chunked_ce_clamps_its_last_chunk():
    """ROADMAP C.21: where the chunk does not divide V the reference's
    ``dynamic_slice`` clamps the last chunk's start, so its sum is not the
    dense CE; the port's is."""
    jc, head, x, labels, _ = _ce_inputs(_cfgs()[0], True)
    dense = float(JM._ce_sum_dense(JM.lm_logits(jc, head, jnp.asarray(x)),
                                   jnp.asarray(labels)))
    ref = float(JM.chunked_ce_sum(jc, head, jnp.asarray(x),
                                  jnp.asarray(labels), None, 100))
    port = float(TM.chunked_ce_sum(_cfgs()[1], tree.map(torch.from_numpy,
                                                        head),
                                   torch.from_numpy(x),
                                   torch.from_numpy(labels), None, 100))
    assert abs(ref - dense) > 1e-3 * abs(dense)
    assert abs(port - dense) <= 1e-5 * abs(dense)


@pytest.mark.parametrize("knob", [dict(ce_chunk=64), dict(ce_chunk=256),
                                  dict(ce_impl="ring")])
def test_make_loss_fn_under_knobs_matches_reference(knob):
    """The loss, ce and every gradient leaf of ``make_loss_fn`` under the
    knob against the reference's under its own ``use_knobs``, with the
    cutoff weights and the global normalizer."""
    jc, tc = _cfgs()
    params = JM.init_model(jc, jax.random.PRNGKey(2))
    batch = SyntheticTokens(jc.vocab_size, S, 4, seed=3).batch(0)
    batch["weights"] = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    norm = float(batch["weights"].sum() * S)
    with j_use_knobs(**knob):
        jloss = j_make_loss_fn(jc)
        (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, norm)
    tp = weights.from_jax(tc, _np(params), device="cpu")
    flat = [x.requires_grad_(True) for x in tree.leaves(tp)]
    with use_knobs(**knob):
        tl, tm = TT.make_loss_fn(tc)(
            tree.unflatten(tp, flat),
            {k: torch.as_tensor(v) for k, v in batch.items()}, norm)
    grads = torch.autograd.grad(tl, flat)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tm["ce"].item(), float(jm["ce"]), rtol=1e-5)
    got = [g.numpy() for g in grads]
    want = [x.numpy() for x in tree.leaves(
        weights.from_jax(tc, _np(jg), device="cpu"))]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_forward_without_head_returns_the_final_hidden():
    jc, tc = _cfgs()
    params = JM.init_model(jc, jax.random.PRNGKey(4))
    batch = SyntheticTokens(jc.vocab_size, S, 2, seed=5).batch(0)
    jx, _, _ = JM.forward(jc, params, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                          head=False)
    tp = weights.from_jax(tc, _np(params), device="cpu")
    tx, caches, aux = TM.forward(tc, tp, {k: torch.as_tensor(v)
                                          for k, v in batch.items()},
                                 head=False)
    assert tx.shape == (2, S, tc.d_model) and caches is None
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-5)
    logits, _, _ = TM.forward(tc, tp, {k: torch.as_tensor(v)
                                       for k, v in batch.items()})
    assert torch.equal(TM.lm_logits(tc, tp, tx), logits)


@pytest.mark.parametrize("factor", [0.0, 2.0, 0.5])
def test_moe_capacity_knob_matches_reference(factor):
    """``moe_capacity_factor`` overrides the config's capacity factor in
    both packages when it is set (> 0)."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe

    for name in ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"):
        jc, tc = jget(name), tget(name)
        for n in (1, 37, 512, 4096):
            with j_use_knobs(moe_capacity_factor=factor):
                want = jmoe.capacity_for(jc, n)
            with use_knobs(moe_capacity_factor=factor):
                assert tmoe.capacity_for(tc, n) == want, (name, n)
            assert tmoe.capacity_for(tc, n, 1.5) == jmoe.capacity_for(
                jc, n, 1.5)


def _fields(cls):
    return {f.name for f in dataclasses.fields(cls)}


def test_knobs_are_the_reference_knobs_ported_or_named():
    """The port's knobs and the unported ones together are the
    reference's, with the reference's defaults; an unknown name raises as
    the reference's does."""
    assert _fields(Knobs) | set(UNPORTED) == _fields(JKnobs)
    assert not _fields(Knobs) & set(UNPORTED)
    for name in _fields(Knobs):
        assert getattr(Knobs(), name) == getattr(JKnobs(), name)
    for use in (use_knobs, j_use_knobs):
        with pytest.raises(TypeError):
            with use(no_such_knob=1):
                pass


@pytest.mark.parametrize("name", sorted(_fields(JKnobs) - _fields(Knobs)
                                         | {"fsdp_gather", "attn_halo"}))
def test_unported_knobs_raise_by_name(name):
    """Setting a reference knob the port does not implement raises naming
    the ROADMAP item it waits for (even at the reference's default), and
    leaves the active knobs as they were.  ``fsdp_gather``, ported with
    ZeRO-3 (A.15.2), and ``attn_halo``, ported with train_sp (A.15.3),
    take the reference's default and raise by name for a value neither
    package knows."""
    if name in _fields(Knobs):
        with use_knobs(**{name: getattr(JKnobs(), name)}):
            assert getattr(knobs(), name) == getattr(JKnobs(), name)
        with pytest.raises(ValueError, match=name):
            with use_knobs(**{name: "no_such_gather"}):
                pass
        assert knobs() == Knobs()
        return
    with pytest.raises(NotImplementedError,
                       match=rf"{name}.*ROADMAP A\.15\.[2-5]"):
        with use_knobs(**{name: getattr(JKnobs(), name)}):
            pass
    assert knobs() == Knobs()


class _SecondRank:
    """A shape-only mesh of 2 ranks on which this process is rank 1."""
    axis_names = ("data",)
    shape = {"data": 2}

    def size(self, axes):
        return 2

    def index(self, axes):
        return 1

    def group(self, axes):
        return None


@pytest.mark.parametrize("holds", ["controller", "timer"])
def test_other_ranks_hold_no_controller_and_no_timer(holds):
    """A rank other than the lead takes the lead's decision as sent: it
    refuses a controller or a timer of its own before any collective."""
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import FullSyncController
    from repro_torch.dist import sharding as shd

    own = {"controller": FullSyncController(4),
           "timer": ClusterSim(n_workers=4, n_nodes=2, seed=1)}
    tr = TT.Trainer(step_fn=None, data=None, n_workers=4,
                    controller=own["controller"] if holds == "controller"
                    else None,
                    timer=own["timer"] if holds == "timer" else None)
    lay = shd.Layout(mesh=_SecondRank(), mode="train_fsdp", dp=("data",))
    with shd.use_layout(lay):
        with pytest.raises(ValueError, match="neither a controller nor a "
                           "timer"):
            tr.run(1)
