"""Port vs JAX package on the CPU: the ZeRO-3 step on a model axis of 3.

The (1, 3) ("data", "model") mesh, W = 6 on 3 gloo ranks, over a
reduced qwen2-0.5b with d_ff 192: 3 divides no width but d_ff, so the
tree's leaves shard on dim 0 (w_down, 192 rows), on dim 1 (w_gate,
w_up: 64 rows, 192 columns) or not at all (the rest), and a real step
writes strided columns, reduce-scatters them and all-reduces the
replicated leaves.  3 masked steps of both ``mask_agg`` paths held
against the reference's LOCAL step (loss 1e-4, parameters 1e-3), with
plain SGD against the port's data-parallel step on the same 3 ranks
(1e-5); each rank's resident state, its shards, in bytes.
"""

import numpy as np
import pytest

from repro_torch import tree
from repro_torch.dist import sharding as shd
from repro_torch.launch import ranks
from repro_torch.models import model as TM
from test_torch_dp_train import LOSS_TOL, LR, PARAM_TOL
from test_torch_zero3_layout import _Rank
from test_torch_zero3_train import (DP_TOL, batches, expected_bytes, held,
                                    masks, setup, want_local)

R, SHAPE, AXES, W, B = 3, (1, 3), ("data", "model"), 6, 12
WIDTHS = {"d_ff": 192}
CASES = {
    "psum": ("psum", {}),
    "weights": ("weights", {}),
    "psum_sgd": ("psum", dict(optimizer="sgd")),
    "weights_sgd": ("weights", dict(optimizer="sgd")),
}


def _spawn(tmp_path_factory):
    jc, tc, params, p0 = setup(**WIDTHS)
    ms = masks(3, W, seed=1)
    calls, names = [], []
    for name in sorted(CASES):
        mask_agg, kw = CASES[name]
        calls.append((ranks.zero3_steps,
                      (tc, p0, batches(jc, ms, mask_agg, B), mask_agg, LR,
                       SHAPE, AXES), kw))
        names.append(name)
    for mask_agg in ("psum", "weights"):
        calls.append((ranks.train_steps,
                      (tc, p0, batches(jc, ms, mask_agg, B), mask_agg, LR),
                      dict(optimizer="sgd")))
        names.append(f"dp_{mask_agg}_sgd")
    pg = tmp_path_factory.mktemp("zero3") / "pg"
    out = ranks.spawn(ranks.several, R, calls, init_method=f"file://{pg}")
    got = {name: [rank[i] for rank in out] for i, name in enumerate(names)}
    local = {m: want_local(jc, tc, params, batches(jc, ms, m, B), m)
             for m in ("psum", "weights")}
    return dict(got=got, local=local, tc=tc)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _spawn(tmp_path_factory)


ADAM = sorted(c for c in CASES if not c.endswith("_sgd"))
SGD = sorted(c for c in CASES if c.endswith("_sgd"))


@pytest.mark.parametrize("case", ADAM)
def test_zero3_steps_match_reference_local(runs, case):
    mask_agg = CASES[case][0]
    held(runs["got"][case], *runs["local"][mask_agg], LOSS_TOL, PARAM_TOL,
         case)


@pytest.mark.parametrize("case", SGD)
def test_zero3_steps_match_the_data_parallel_step(runs, case):
    """Plain SGD on both sides, so the parameters move by the reduced
    gradient itself: a reduce-scatter adds the ranks in another order
    than the data-parallel all-reduce, and Adam's normalization would
    blow a last-bit difference of a near-zero gradient up to the
    learning rate."""
    mask_agg = CASES[case][0]
    dp = runs["got"][f"dp_{mask_agg}_sgd"]
    want = [x.astype(np.float32) for x in tree.leaves(dp[0][1])]
    held(runs["got"][case], [m["loss"] for m in dp[0][0]], want, DP_TOL,
         DP_TOL, case)


@pytest.mark.parametrize("case", ADAM)
def test_zero3_resident_state_is_the_ranks_shards(runs, case):
    want = expected_bytes(runs["tc"], SHAPE, AXES,
                          CASES[case][1].get("zero1", False))
    for rank in runs["got"][case]:
        assert rank[2]["state_bytes"] == want


def test_three_shards_place_every_kind_of_leaf():
    _, tc, _, _ = setup(**WIDTHS)
    lay = shd.make_layout(_Rank(SHAPE, AXES, (0, 2)), "train_fsdp")
    plan = shd.shard_plan(TM.init_model(tc, None, device="meta"), lay)
    dims = {leaf.dim for leaf in plan.leaves}
    assert dims == {0, 1, None}, dims
    assert plan.replicated > 0 and plan.narrow > 0
