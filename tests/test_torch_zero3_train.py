"""Port vs JAX package on the CPU: the ZeRO-3 train step on 2 gloo ranks.

A reduced qwen2-0.5b (2 layers) with W = 4 workers trains 3 masked steps
(each mask drops at least one worker) under ``train_fsdp`` on the meshes
(1, 2) ("data", "model") (the parameters ZeRO-3 over a model axis of 2)
and (2,) ("data",) (pure FSDP: the model axis is "data" itself), on both
``mask_agg`` paths, with zero1 off and on (``launch.ranks.zero3_steps``:
the state cut into shards, gathered back at the end).  Each run is held
against the reference's LOCAL ``make_train_step`` at the bars of its
``tests/sharded/mask_agg_check.py`` (loss 1e-4, parameters 1e-3), and
against the port's data-parallel step on the same 2 ranks
(``launch.ranks.train_steps``) within 1e-5.  Each rank's resident state
is its slices and moments' pieces plus the replicated leaves, in bytes;
each step makes one reduce-scatter over the model axis (zero1: one more
over "data") and one gather a block a forward.  All runs share one
process group (``launch.ranks.several``).
"""

import dataclasses
import math

import jax
import numpy as np
import pytest

from repro.core.aggregation import example_weights as j_example_weights
from repro.models import model as JM
from repro_torch import tree, weights
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.dist import sharding as shd
from repro_torch.launch import ranks
from repro_torch.models import model as TM
from test_torch_dp_train import LOSS_TOL, LR, PARAM_TOL, _cfgs, _jax_run, _np
from test_torch_zero3_layout import _Rank

W, B, S, R = 4, 8, 16, 2
DP_TOL = 1e-5          # against the data-parallel step on the same ranks
MESHES = {"m12": ((1, 2), ("data", "model")), "d2": ((2,), ("data",))}
CASES = {
    "m12_psum": ("m12", "psum", {}),
    "m12_weights": ("m12", "weights", {}),
    "m12_psum_zero1": ("m12", "psum", dict(zero1=True)),
    "m12_weights_zero1": ("m12", "weights", dict(zero1=True)),
    "d2_psum": ("d2", "psum", {}),
    "d2_weights": ("d2", "weights", {}),
}


def masks(n, n_workers, seed=0, fractional=False):
    """A fresh random mask a step, at least one worker dropped (the
    reference's mask_agg_check schedule)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = (rng.uniform(size=n_workers) < 0.7).astype(np.float32)
        m[rng.integers(n_workers)] = 0.0
        if m.sum() == 0:
            m[0] = 1.0
        if fractional:
            m = np.where(m > 0, 1.0,
                         rng.uniform(size=n_workers)).astype(np.float32)
        out.append(m)
    return out


def batches(cfg, ms, mask_agg, batch):
    data = SyntheticTokens(cfg.vocab_size, S, batch, seed=0)
    out = []
    for t, m in enumerate(ms):
        b = data.batch(t)
        if mask_agg == "psum":
            b["mask"] = m
        else:
            b["weights"] = j_example_weights(m, batch)
        out.append(b)
    return out


def setup(n_layers=2, **widths):
    """Reduced qwen2-0.5b at ``n_layers`` (and ``widths``, e.g. d_ff) for
    both packages, the reference's params and the port's as numpy."""
    jc, tc = (dataclasses.replace(c, **widths) for c in _cfgs(n_layers))
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    p0 = tree.map(lambda x: x.numpy(),
                  weights.from_jax(tc, _np(params), device="cpu"))
    return jc, tc, params, p0


def expected_bytes(tc, shape, axes, zero1):
    """params + m + v of one rank: each leaf's slice in its dtype and its
    moments' piece twice in f32, the replicated leaves whole."""
    lay = shd.make_layout(_Rank(shape, axes, (0,) * len(shape)),
                          "train_fsdp")
    meta = TM.init_model(tc, None, device="meta")
    plan = shd.shard_plan(meta, lay, zero1=zero1)
    total = 0
    for i, x in enumerate(tree.leaves(meta)):
        total += math.prod(plan.slice_shape(i)) * x.element_size()
        total += 2 * 4 * math.prod(plan.slice_shape(i, moments=True))
    return total


def want_local(jc, tc, params, bs, mask_agg, **kw):
    losses, jparams = _jax_run(jc, params, bs, mask_agg, **kw)
    return losses, [x.astype(np.float32) for x in tree.leaves(
        tree.map(lambda x: x.numpy(),
                 weights.from_jax(tc, _np(jparams), device="cpu")))]


def held(out, want_losses, want_params, loss_tol, param_tol, what):
    """Every rank's losses and gathered parameters against a reference;
    the ranks' gathered parameters bit-equal."""
    for r, (metrics, got_params, *_) in enumerate(out):
        got = [m["loss"] for m in metrics]
        np.testing.assert_allclose(got, want_losses, rtol=0, atol=loss_tol,
                                   err_msg=f"{what}, rank {r}")
        flat = tree.leaves(got_params)
        assert len(flat) == len(want_params)
        gap = max(float(np.abs(a - b).max())
                  for a, b in zip(flat, want_params))
        assert gap < param_tol, (what, r, gap)
        for a, b in zip(flat, tree.leaves(out[0][1])):
            assert np.array_equal(a, b), (what, r)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jc, tc, params, p0 = setup()
    ms = masks(3, W)
    calls = []
    for name in sorted(CASES):
        mesh, mask_agg, kw = CASES[name]
        calls.append((ranks.zero3_steps,
                      (tc, p0, batches(jc, ms, mask_agg, B), mask_agg, LR)
                      + MESHES[mesh], kw))
    for mask_agg in ("psum", "weights"):
        calls.append((ranks.train_steps,
                      (tc, p0, batches(jc, ms, mask_agg, B), mask_agg, LR),
                      {}))
    pg = tmp_path_factory.mktemp("zero3") / "pg"
    out = ranks.spawn(ranks.several, R, calls, init_method=f"file://{pg}")
    names = sorted(CASES) + ["dp_psum", "dp_weights"]
    got = {name: [rank[i] for rank in out] for i, name in enumerate(names)}
    local = {m: want_local(jc, tc, params, batches(jc, ms, m, B), m)
             for m in ("psum", "weights")}
    return dict(got=got, local=local, tc=tc)


@pytest.mark.parametrize("case", sorted(CASES))
def test_zero3_steps_match_reference_local(runs, case):
    mask_agg = CASES[case][1]
    held(runs["got"][case], *runs["local"][mask_agg], LOSS_TOL, PARAM_TOL,
         case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_zero3_steps_match_the_data_parallel_step(runs, case):
    mask_agg = CASES[case][1]
    dp = runs["got"][f"dp_{mask_agg}"]
    want = [x.astype(np.float32) for x in tree.leaves(dp[0][1])]
    held(runs["got"][case], [m["loss"] for m in dp[0][0]], want, DP_TOL,
         DP_TOL, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_zero3_resident_state_is_the_ranks_shards(runs, case):
    mesh, _, kw = CASES[case]
    want = expected_bytes(runs["tc"], *MESHES[mesh], kw.get("zero1", False))
    full = sum(x.numel() * (x.element_size() + 8) for x in tree.leaves(
        TM.init_model(runs["tc"], None, device="meta")))
    for rank in runs["got"][case]:
        assert rank[2]["state_bytes"] == want
        assert want < 0.6 * full       # most leaves split over 2 shards


@pytest.mark.parametrize("case", sorted(CASES))
def test_zero3_step_collectives(runs, case):
    """Each step: one reduce-scatter over the model axis (zero1: and one
    over "data", and one all-gather of the updated pieces); a gather a
    block a forward, twice (the backward's recompute), and the embedding
    (twice: the tied head), the final norm."""
    _, mask_agg, kw = CASES[case]
    tc = runs["tc"]
    per_forward = 2 * tc.n_layers + 3
    workers = W // R if mask_agg == "psum" else 1
    zero1 = kw.get("zero1", False)
    for rank in runs["got"][case]:
        for made in rank[2]["collectives"]:
            assert made["reduce_scatter"] == (2 if zero1 else 1)
            assert made["all_gather"] == workers * per_forward + zero1
            assert made["all_reduce"] >= 2     # replicated sums, metrics


def test_reduced_qwen2_shards_every_leaf_on_two_shards():
    """The run's tree on (1, 2): every leaf sharded on dim 0 (the plan's
    dim-1 and replicated leaves run in the arch tests and on 4 shards)."""
    _, tc = _cfgs(2)
    lay = shd.make_layout(_Rank((1, 2), ("data", "model"), (0, 1)),
                          "train_fsdp")
    plan = shd.shard_plan(TM.init_model(tc, None, device="meta"), lay)
    assert {leaf.dim for leaf in plan.leaves} == {0}
    assert plan.shard == 1 and plan.narrow * 2 == plan.size
