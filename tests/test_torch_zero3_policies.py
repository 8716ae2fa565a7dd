"""Port vs JAX package on the CPU: the ZeRO-3 step's policies on 2 ranks.

On the (1, 2) ("data", "model") mesh of ``test_torch_zero3_train.py``,
W = 4: anytime (fractional) contributions with 2 accumulated
microbatches and stale-gradient reuse (decay 0.5), both under zero1, and
int8 error-feedback compression, each held against the reference's LOCAL
step (loss 1e-4, parameters 1e-3) and the port's data-parallel step on
the same ranks (1e-5); ``fsdp_gather="shardmap"`` against ``"wsc"`` at
the reference's knob_equiv bars (loss 1e-4, parameters 1e-3), with its
one gather a dim-0 leaf.  Compression under zero1 raises by name.
"""

import numpy as np
import pytest
import torch

from repro_torch import optim, tree
from repro_torch.dist import sharding as shd
from repro_torch.launch import ranks
from repro_torch.launch import train as TT
from test_torch_dp_train import LOSS_TOL, LR, PARAM_TOL
from test_torch_zero3_train import (B, DP_TOL, MESHES, R, W, batches, held,
                                    masks, setup, want_local)

CASES = {
    "anytime_accum2_zero1": dict(grad_accum=2, zero1=True),
    "stale_zero1": dict(stale_decay=0.5, zero1=True),
    "compress": dict(compress=True),
    "wsc": {},
    "shardmap": dict(fsdp_gather="shardmap"),
}
DP_KW = ("grad_accum", "compress", "stale_decay")


def _masks(case):
    return masks(3, W, fractional=case.startswith("anytime"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jc, tc, params, p0 = setup()
    calls, names = [], []
    for name in sorted(CASES):
        bs = batches(jc, _masks(name), "psum", B)
        calls.append((ranks.zero3_steps, (tc, p0, bs, "psum", LR)
                      + MESHES["m12"], CASES[name]))
        names.append(name)
        if name in ("wsc", "shardmap"):
            continue
        calls.append((ranks.train_steps, (tc, p0, bs, "psum", LR),
                      {k: v for k, v in CASES[name].items() if k in DP_KW}))
        names.append(f"dp_{name}")
    pg = tmp_path_factory.mktemp("zero3p") / "pg"
    out = ranks.spawn(ranks.several, R, calls, init_method=f"file://{pg}")
    got = {name: [rank[i] for rank in out] for i, name in enumerate(names)}
    return dict(got=got, jc=jc, tc=tc, params=params)


@pytest.mark.parametrize("case", ["anytime_accum2_zero1", "stale_zero1"])
def test_zero3_policies_match_reference_local(runs, case):
    kw = CASES[case]
    want = want_local(runs["jc"], runs["tc"], runs["params"],
                      batches(runs["jc"], _masks(case), "psum", B), "psum",
                      grad_accum=kw.get("grad_accum", 1),
                      stale_decay=kw.get("stale_decay"))
    held(runs["got"][case], *want, LOSS_TOL, PARAM_TOL, case)


@pytest.mark.parametrize("case", ["anytime_accum2_zero1", "stale_zero1",
                                  "compress"])
def test_zero3_policies_match_the_data_parallel_step(runs, case):
    dp = runs["got"][f"dp_{case}"]
    want = [x.astype(np.float32) for x in tree.leaves(dp[0][1])]
    held(runs["got"][case], [m["loss"] for m in dp[0][0]], want, DP_TOL,
         DP_TOL, case)


def test_zero3_compression_first_loss_is_the_references(runs):
    """Compression acts on the update: the first step's loss, taken before
    any, is the reference's."""
    want, _ = want_local(runs["jc"], runs["tc"], runs["params"],
                         batches(runs["jc"], _masks("compress"), "psum",
                                 B)[:1], "psum")
    for metrics, *_ in runs["got"]["compress"]:
        assert abs(metrics[0]["loss"] - want[0]) < LOSS_TOL
        assert all(np.isfinite(m["loss"]) for m in metrics)


def test_shardmap_gather_matches_wsc(runs):
    """knob_equiv's bars; the shardmap runs gather each dim-0 leaf alone
    (every leaf of this tree), so they make more all-gathers a step."""
    wsc = runs["got"]["wsc"]
    want = [x.astype(np.float32) for x in tree.leaves(wsc[0][1])]
    held(runs["got"]["shardmap"], [m["loss"] for m in wsc[0][0]], want,
         1e-4, 1e-3, "shardmap")
    for a, b in zip(runs["got"]["shardmap"], wsc):
        for ms, mw in zip(a[2]["collectives"], b[2]["collectives"]):
            assert ms["all_gather"] > mw["all_gather"]
            assert ms["reduce_scatter"] == mw["reduce_scatter"] == 1


class _Mesh:
    """A shape-only (1, 2) ("data", "model") mesh, this process rank 0."""
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 2}

    def size(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes):
        return 0

    def group(self, axes):
        return None


def test_compression_under_zero1_raises_by_name():
    _, tc, _, p0 = setup()
    opt = optim.adamw(LR, fused=True)
    step = TT.make_train_step(tc, opt, mask_agg="psum",
                              compress_pod_grads=True, zero1=True)
    params = tree.map(torch.from_numpy, p0)
    with shd.use_layout(shd.make_layout(_Mesh(), "train_fsdp")):
        with pytest.raises(NotImplementedError, match="C.23"):
            step({"params": params, "opt": opt.init(params)},
                 {"tokens": np.zeros((4, 4), np.int32),
                  "labels": np.zeros((4, 4), np.int32),
                  "positions": np.tile(np.arange(4), (4, 1)),
                  "mask": np.ones(4, np.float32)})
