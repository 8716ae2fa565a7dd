"""Port vs JAX package on the CPU: every arch's ZeRO-3 step, part 1 of 4.

Each registered arch (reduced; MoE at a capacity factor of n_experts)
takes one psum step of plain SGD at lr 1 under ``train_fsdp`` on a
(1, 2) ("data", "model") mesh of 2 gloo ranks (the parameters ZeRO-3
over the model axis), W = 4 with shard_check's mask (1, 0, 1, 1), and
is held against the reference's LOCAL ``make_train_step`` at the bars
of its ``tests/sharded/shard_check.py``: loss within 2e-4, the
aggregated gradient (the parameters' change) within 2e-2.  The archs
are split over ``test_torch_zero3_archs*.py`` so each file stays under
a minute; this one holds the shared helpers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import optim as joptim
from repro.configs.base import get_config as jget
from repro.launch.train import jit_train_step
from repro.models import model as JM
from repro_torch import tree, weights
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import ranks

W, B, S = 4, 4, 16
LOSS_TOL, GRAD_TOL = 2e-4, 2e-2      # tests/sharded/shard_check.py
MASK = np.array([1.0, 0.0, 1.0, 1.0], np.float32)   # shard_check's


def _reduced(name):
    """Both packages' reduced config; MoE at a capacity factor of
    n_experts (no token dropped), as shard_check runs it."""
    jc, tc = jget(name).reduced(), tget(name).reduced()
    if jc.n_experts:
        jc = dataclasses.replace(jc, moe_capacity_factor=float(jc.n_experts))
        tc = dataclasses.replace(tc, moe_capacity_factor=float(tc.n_experts))
    return jc, tc


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32),
             "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                          (B, S)).copy(),
             "mask": MASK}
    if cfg.frontend == "vision_patches":
        batch["patch_embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32) * 0.1
        batch["image_mask"] = rng.uniform(size=(B, S)) < 0.25
        batch["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, B, S)).copy()
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32) * 0.1
    return batch


def _port_numpy(tc, jtree):
    return [x.astype(np.float32) for x in tree.leaves(tree.map(
        lambda x: x.numpy(),
        weights.from_jax(tc, jax.tree.map(np.asarray, jtree),
                         device="cpu")))]


def _reference(name):
    """One psum step of plain SGD at lr 1 under LOCAL: (loss, the
    aggregated gradient p0 - p1 in the port's leaf order)."""
    jc, tc = _reduced(name)
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    step = jit_train_step(jc, joptim.sgd(1.0), donate=False,
                          mask_agg="psum")
    opt = joptim.sgd(1.0)
    state, m = step({"params": params, "opt": opt.init(params)},
                    {k: jnp.asarray(v) for k, v in _batch(jc).items()})
    p0, p1 = _port_numpy(tc, params), _port_numpy(tc, state["params"])
    return float(m["loss"]), [a - b for a, b in zip(p0, p1)]


def spawn_archs(names, tmp_path_factory):
    """Every arch's one ZeRO-3 psum step of plain SGD at lr 1 on a
    (1, 2) ("data", "model") mesh of 2 gloo ranks, in one process group:
    {name: (losses, p0 - p1 on each rank)}."""
    calls, p0s = [], {}
    for name in names:
        jc, tc = _reduced(name)
        params = JM.init_model(jc, jax.random.PRNGKey(0))
        p0 = tree.map(lambda x: x.numpy(), weights.from_jax(
            tc, jax.tree.map(np.asarray, params), device="cpu"))
        p0s[name] = [x.astype(np.float32) for x in tree.leaves(p0)]
        calls.append((ranks.zero3_steps,
                      (tc, p0, [_batch(jc)], "psum", 1.0, (1, 2),
                       ("data", "model")), dict(optimizer="sgd")))
    pg = tmp_path_factory.mktemp("zero3a") / "pg"
    out = ranks.spawn(ranks.several, 2, calls, init_method=f"file://{pg}")
    return {name: [(rank[i][0][0]["loss"],
                    [a - b for a, b in zip(p0s[name],
                                           tree.leaves(rank[i][1]))])
                   for rank in out]
            for i, name in enumerate(names)}


def check_arch(runs, name):
    want_loss, want_g = _reference(name)
    scale = max(float(np.abs(g).max()) for g in want_g)
    assert scale > 0
    for r, (loss, got_g) in enumerate(runs[name]):
        assert abs(loss - want_loss) < LOSS_TOL, (name, r, loss, want_loss)
        assert len(got_g) == len(want_g)
        gap = max(float(np.abs(a - b).max()) for a, b in zip(got_g, want_g))
        assert gap < GRAD_TOL, (name, r, gap)

ARCHS = ['deepseek-moe-16b', 'gemma3-12b']


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_archs(ARCHS, tmp_path_factory)


@pytest.mark.parametrize("name", ARCHS)
def test_zero3_psum_step_matches_reference_local(runs, name):
    check_arch(runs, name)
