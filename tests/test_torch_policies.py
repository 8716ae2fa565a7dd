"""Port vs JAX package on the CPU: the straggler-policy frontier.

The Elfving baseline (math and controller), the anytime and stale-reuse
wrappers, int8 error-feedback compression, and the port's own race of the
DMM controller against static and full sync on ``tpu_pod_hosts(8)``.

Bars: the Elfving math and controller, the contribution vectors and the
int8 codes are numpy/elementwise copies of the reference and are held to
it exactly.  The identities the reference pins bit for bit stay bit for
bit in the port: ``n_micro=1`` anytime equals discard, stale reuse with
decay 0 equals discard.  The fold with a nonzero weight and the error
feedback's ``tot - q * scale`` may differ from XLA's by an ulp (XLA's CPU
backend contracts ``a * b + c`` into fused multiply-adds): the folded
gradient is held through Adam's first moment (m = 0.1 g) to atol 1e-6,
the residuals to atol 1e-6 of values below 1, and a 4-step stale-reuse
``Trainer`` to the JAX one with equal cutoffs and clock, losses within
1e-5 and final params within 1e-3 (the bar of ``test_torch_train.py``'s
``Trainer`` comparison).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.cluster.simulator import ClusterSim as JClusterSim
from repro.configs.base import get_config as jget
from repro.core import controller as jctl
from repro.core.cutoff import elfving as jelf
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.launch.train import Trainer as JTrainer
from repro.launch.train import jit_train_step
from repro.models import model as JM
from repro_torch import optim as toptim
from repro_torch import tree, weights
from repro_torch.cluster.simulator import (ClusterSim, paper_cluster_158,
                                           tpu_pod_hosts)
from repro_torch.configs.base import get_config as tget
from repro_torch.core import controller as tctl
from repro_torch.core.cutoff import elfving as telf
from repro_torch.core.runtime_model.api import RuntimeModel as TRM
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as TT
from repro_torch.models import model as TM

torch.set_num_threads(2)

LR = 3e-3


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _cfgs(n_layers):
    return (dataclasses.replace(jget("qwen2-0.5b").reduced(),
                                n_layers=n_layers),
            dataclasses.replace(tget("qwen2-0.5b").reduced(),
                                n_layers=n_layers))


def _leaves_np(cfg, t_tree, j_tree):
    carried = weights.from_jax(cfg, _np_tree(j_tree), device="cpu")
    return ([x.float().numpy() for x in tree.leaves(t_tree)],
            [x.float().numpy() for x in tree.leaves(carried)])


# ---------------------------------------------------------------------------
# Elfving: the analytic baseline.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,mu,sigma", [(8, 1.0, 0.09), (8, 1.0, 0.4),
                                        (158, 1.057, 0.393),
                                        (2175, 1.0, 0.2)])
def test_elfving_math_matches_jax(n, mu, sigma):
    np.testing.assert_array_equal(telf.expected_order_stats(n, mu, sigma),
                                  jelf.expected_order_stats(n, mu, sigma))
    assert telf.expected_max(n, mu, sigma) == jelf.expected_max(n, mu, sigma)
    assert (telf.expected_idle_fraction(n, mu, sigma)
            == jelf.expected_idle_fraction(n, mu, sigma))
    for min_frac in (0.0, 0.5, 0.9):
        assert (telf.elfving_cutoff(n, mu, sigma, min_frac)
                == jelf.elfving_cutoff(n, mu, sigma, min_frac))


def test_exact_order_stat_mean_matches_jax():
    """The quadrature at the paper's n = 158 moments (§4.1): equal to the
    reference's, and within 1e-3 of the Elfving approximation."""
    got = telf.exact_order_stat_mean(158, 158, 1.057, 0.393)
    assert got == jelf.exact_order_stat_mean(158, 158, 1.057, 0.393)
    assert abs(got - telf.expected_max(158, 1.057, 0.393)) < 1e-3


@pytest.mark.parametrize("warmup,min_frac", [(2, 0.5), (5, 0.75)])
def test_elfving_controller_matches_jax(warmup, min_frac):
    """The same runtimes through both controllers, each step's mask from
    the cutoff both chose: identical cutoffs, and some step cuts."""
    j = jctl.ElfvingController(8, warmup=warmup, min_frac=min_frac)
    t = tctl.ElfvingController(8, warmup=warmup, min_frac=min_frac)
    sim = paper_cluster_158(0, n_workers=8)
    cutoffs = []
    for step in range(40):
        if step == 30:
            j.resize(4)
            t.resize(4)
        c = t.predict_cutoff()
        assert c == j.predict_cutoff(), step
        times = sim.step()[:t.n]
        mask = np.zeros(t.n, bool)
        mask[np.argsort(times)[:c]] = True
        j.observe(times, mask)
        t.observe(times, mask)
        cutoffs.append(c)
        np.testing.assert_array_equal(t.buf[-1], j.buf[-1])
    assert min(cutoffs[:30]) < 8


def test_elfving_observe_imputes_censored_at_cutoff_time():
    """tests/test_elastic.py's case, on the port."""
    ctl = tctl.ElfvingController(4, warmup=1)
    ctl.observe(np.array([1.0, 2.0, 777.0, 3.0]),
                np.array([True, True, False, True]))
    np.testing.assert_allclose(ctl.buf[-1], [1.0, 2.0, 3.0, 3.0])
    ctl.observe(np.array([1.0, 2.0, 2.5, 3.0]))
    np.testing.assert_allclose(ctl.buf[-1], [1.0, 2.0, 2.5, 3.0])
    with pytest.raises(ValueError, match="all-False"):
        ctl.observe(np.ones(4), np.zeros(4, bool))


# ---------------------------------------------------------------------------
# Anytime contributions.
# ---------------------------------------------------------------------------


def test_anytime_contribution_vector():
    ctl = tctl.AnytimeController(tctl.StaticCutoffController(4, cutoff=2),
                                 n_micro=4)
    contrib = ctl.contribution(np.array([1.0, 2.0, 3.0, 8.0]), 2)
    np.testing.assert_allclose(contrib, [1.0, 1.0, 0.5, 0.25])
    assert contrib.dtype == np.float32


@pytest.mark.parametrize("n_micro", [1, 2, 3, 4])
def test_anytime_contribution_matches_jax(n_micro):
    rng = np.random.default_rng(n_micro)
    j = jctl.AnytimeController(jctl.StaticCutoffController(6, cutoff=4),
                               n_micro=n_micro)
    t = tctl.AnytimeController(tctl.StaticCutoffController(6, cutoff=4),
                               n_micro=n_micro)
    for _ in range(20):
        times = rng.uniform(1.0, 10.0, size=6)
        times[rng.integers(6)] = times[rng.integers(6)]     # a tie
        c = int(rng.integers(1, 7))
        got = t.contribution(times, c)
        np.testing.assert_array_equal(got, j.contribution(times, c))
        if n_micro == 1:       # the discard bit array, bit for bit
            bits = np.zeros(6, np.float32)
            bits[np.argsort(times, kind="stable")[:c]] = 1.0
            np.testing.assert_array_equal(got, bits)


# ---------------------------------------------------------------------------
# Trainer-level identities and parity (2-layer reduced qwen2-0.5b, W = 4).
# ---------------------------------------------------------------------------


def _port_trainer(tc, step, controller, mask_agg, n_steps=4):
    step_fn, opt = step
    tr = TT.Trainer(step_fn=step_fn, data=SyntheticTokens(tc.vocab_size, 16,
                                                          8, seed=0),
                    controller=controller,
                    timer=ClusterSim(n_workers=4, n_nodes=2, seed=5),
                    n_workers=4, mask_agg=mask_agg, metrics_every=0)

    def init():
        params = TM.init_model(tc, torch.Generator().manual_seed(0),
                               device="cpu")
        return {"params": params, "opt": opt.init(params)}

    tr.restore_or_init(init)
    tr.run(n_steps)
    return tr


def _port_step(tc, **kw):
    """(step_fn, optimizer) for :func:`_port_trainer`."""
    opt = toptim.adamw(LR, fused=True)
    return TT.make_train_step(tc, opt, **kw), opt


def _params_equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(tree.leaves(a.state["params"]),
                   tree.leaves(b.state["params"])))


@pytest.mark.parametrize("mode", ["weights", "psum"])
def test_anytime_n_micro_1_bitwise_equals_discard(mode):
    _, tc = _cfgs(2)
    step = _port_step(tc, grad_accum=2, mask_agg=mode)
    discard = _port_trainer(tc, step, tctl.StaticCutoffController(4, 3),
                            mode)
    anytime = _port_trainer(
        tc, step, tctl.AnytimeController(tctl.StaticCutoffController(4, 3),
                                         n_micro=1), mode)
    assert _params_equal(discard, anytime)
    assert ([h["loss"] for h in discard.history]
            == [h["loss"] for h in anytime.history])


def test_stale_reuse_decay_0_bitwise_equals_discard():
    _, tc = _cfgs(2)
    discard = _port_trainer(tc, _port_step(tc, grad_accum=2,
                                           mask_agg="psum"),
                            tctl.StaticCutoffController(4, 3), "psum")
    stale = _port_trainer(
        tc, _port_step(tc, grad_accum=2, mask_agg="psum", stale_reuse=True),
        tctl.StaleReuseController(tctl.StaticCutoffController(4, 3),
                                  decay=0.0), "psum")
    assert _params_equal(discard, stale)
    half = _port_trainer(
        tc, _port_step(tc, grad_accum=2, mask_agg="psum", stale_reuse=True),
        tctl.StaleReuseController(tctl.StaticCutoffController(4, 3),
                                  decay=0.5), "psum")
    assert not _params_equal(discard, half)
    assert float(half._stale[1]) == 1.0          # one dropped worker


def test_stale_fold_step_matches_jax():
    """One stale-reuse step from the same state, with the same buffered
    gradient at weight 1.5: the dropped mean and count equal JAX's within
    1e-6, and the folded gradient (through m = 0.1 g) within 1e-6."""
    jc, tc = _cfgs(2)
    jopt, topt = joptim.adamw(LR), toptim.adamw(LR, fused=True)
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    jstate = {"params": params, "opt": jopt.init(params)}
    tstate = weights.state_from_jax(tc, _np_tree(jstate), device="cpu")
    rng = np.random.default_rng(3)
    stale_np = jax.tree.map(
        lambda p: (0.01 * rng.standard_normal(p.shape)).astype(np.float32),
        _np_tree(params))
    mask = np.asarray([1.0, 0.0, 1.0, 0.0], np.float32)
    batch = SyntheticTokens(jc.vocab_size, 16, 8, seed=0).batch(1)
    jb = dict(batch, mask=jnp.asarray(mask), stale_g=stale_np,
              stale_w=jnp.float32(1.5))
    tb = dict(batch, mask=mask,
              stale_g=weights.from_jax(tc, stale_np, device="cpu"),
              stale_w=torch.tensor(1.5))
    jnew, jm = jit_train_step(jc, jopt, donate=False, mask_agg="psum",
                              stale_reuse=True)(jstate, jb)
    tnew, tm = TT.make_train_step(tc, topt, mask_agg="psum",
                                  stale_reuse=True)(tstate, tb)
    assert float(tm["stale"][1]) == float(jm["stale"][1]) == 2.0
    got, want = _leaves_np(tc, tm["stale"][0], jm["stale"][0])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)
    got, want = _leaves_np(tc, tnew["opt"]["m"], jnew["opt"]["m"])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               atol=1e-5)


def test_stale_reuse_trainer_matches_jax_trainer():
    jc, tc = _cfgs(2)
    jopt = joptim.adamw(LR)
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    jinit = {"params": params, "opt": jopt.init(params)}
    jt = JTrainer(cfg=jc, step_fn=jit_train_step(jc, jopt, mask_agg="psum",
                                                 stale_reuse=True),
                  data=JTokens(jc.vocab_size, 16, 8, seed=0),
                  controller=jctl.StaleReuseController(
                      jctl.FirstKController(8, backup=2), decay=0.5),
                  timer=JClusterSim(n_workers=8, n_nodes=2, seed=5),
                  n_workers=8, mask_agg="psum")
    jt.restore_or_init(lambda: jax.tree.map(jnp.copy, jinit))
    topt = toptim.adamw(LR, fused=True)
    tt = TT.Trainer(step_fn=TT.make_train_step(tc, topt, mask_agg="psum",
                                               stale_reuse=True),
                    data=SyntheticTokens(tc.vocab_size, 16, 8, seed=0),
                    controller=tctl.StaleReuseController(
                        tctl.FirstKController(8, backup=2), decay=0.5),
                    timer=ClusterSim(n_workers=8, n_nodes=2, seed=5),
                    n_workers=8, mask_agg="psum")
    tt.restore_or_init(lambda: weights.state_from_jax(tc, _np_tree(jinit),
                                                      device="cpu"))
    jh, th = jt.run(4), tt.run(4)
    assert [(h["c"], h["clock"]) for h in th] \
        == [(h["c"], h["clock"]) for h in jh]
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=1e-5)
    got, want = _leaves_np(tc, tt.state["params"], jt.state["params"])
    assert max(np.abs(a - b).max() for a, b in zip(got, want)) < 1e-3
    assert float(tt._stale[1]) == float(jt._stale[1]) == 2.0


def test_anytime_trainer_matches_jax_trainer():
    """Fractional contributions (n_micro 2, grad_accum 2) through the
    wrapper and the psum path: the same cutoffs, clock and losses."""
    jc, tc = _cfgs(2)
    jopt = joptim.adamw(LR)
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    jinit = {"params": params, "opt": jopt.init(params)}
    jt = JTrainer(cfg=jc, step_fn=jit_train_step(jc, jopt, mask_agg="psum",
                                                 grad_accum=2),
                  data=JTokens(jc.vocab_size, 16, 8, seed=0),
                  controller=jctl.AnytimeController(
                      jctl.FirstKController(4, backup=2), n_micro=2),
                  timer=JClusterSim(n_workers=4, n_nodes=2, seed=5),
                  n_workers=4, mask_agg="psum")
    jt.restore_or_init(lambda: jax.tree.map(jnp.copy, jinit))
    contribs = []
    ctl = tctl.AnytimeController(tctl.FirstKController(4, backup=2),
                                 n_micro=2)
    contribution = ctl.contribution
    ctl.contribution = lambda times, c: contribs.append(
        contribution(times, c)) or contribs[-1]
    tt = TT.Trainer(step_fn=TT.make_train_step(
        tc, toptim.adamw(LR, fused=True), mask_agg="psum", grad_accum=2),
        data=SyntheticTokens(tc.vocab_size, 16, 8, seed=0), controller=ctl,
        timer=ClusterSim(n_workers=4, n_nodes=2, seed=5), n_workers=4,
        mask_agg="psum")
    tt.restore_or_init(lambda: weights.state_from_jax(tc, _np_tree(jinit),
                                                      device="cpu"))
    jh, th = jt.run(3), tt.run(3)
    assert [(h["c"], h["clock"]) for h in th] \
        == [(h["c"], h["clock"]) for h in jh]
    assert any(np.any((f > 0) & (f < 1)) for f in contribs)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=1e-5)


# ---------------------------------------------------------------------------
# Guard rails.
# ---------------------------------------------------------------------------


def test_stale_reuse_needs_psum():
    _, tc = _cfgs(2)
    with pytest.raises(ValueError, match="psum"):
        TT.make_train_step(tc, toptim.adamw(LR), mask_agg="weights",
                           stale_reuse=True)


def test_stale_controller_rejects_weights_trainer():
    _, tc = _cfgs(2)
    with pytest.raises(ValueError, match="psum"):
        _port_trainer(tc, _port_step(tc, mask_agg="weights"),
                      tctl.StaleReuseController(
                          tctl.StaticCutoffController(4, 3)),
                      "weights", n_steps=1)


def test_stale_controller_rejects_plain_step():
    _, tc = _cfgs(2)
    with pytest.raises(ValueError, match="stale_reuse=True"):
        _port_trainer(tc, _port_step(tc, mask_agg="psum"),
                      tctl.StaleReuseController(
                          tctl.StaticCutoffController(4, 3)),
                      "psum", n_steps=1)


def test_policy_wrapper_validation():
    with pytest.raises(ValueError):
        tctl.AnytimeController(tctl.FullSyncController(4), n_micro=0)
    with pytest.raises(ValueError):
        tctl.StaleReuseController(tctl.FullSyncController(4), decay=1.5)


# ---------------------------------------------------------------------------
# The wrapper protocol (tests/test_frontier.py:252-300).
# ---------------------------------------------------------------------------


WRAPS = {"anytime": lambda inner: tctl.AnytimeController(inner, n_micro=4),
         "stale": lambda inner: tctl.StaleReuseController(inner, decay=0.5)}


@pytest.mark.parametrize("wrap", sorted(WRAPS))
def test_policy_wrappers_satisfy_resize_protocol(wrap):
    wrap = WRAPS[wrap]
    ctl = wrap(tctl.StaticCutoffController(8, cutoff=6))
    assert ctl.n == 8 and not hasattr(ctl, "_step")
    ctl.resize(4, col_map=None, model=None, members=np.arange(4))
    assert ctl.n == 4 and 1 <= ctl.predict_cutoff() <= 4

    # DMM inner: the window remaps column-exactly through the wrapper, and
    # the step and the predictions pass through
    trace = paper_cluster_158(0, n_workers=8).run(60)
    rm = TRM(n_workers=8, lag=6, device="cpu").init(0)
    rm.fit(trace, steps=20, batch=8, seed=0)
    rm4 = TRM(n_workers=4, lag=6, device="cpu").init(1)
    rm4.norm_scale = rm.norm_scale
    bare = tctl.CutoffController(rm, k_samples=16, seed=0)
    wrapped = wrap(tctl.CutoffController(rm, k_samples=16, seed=0))
    for c in (bare, wrapped):
        c.seed_window(trace)
        c._step = 7
    assert wrapped._step == 7
    assert wrapped.predict_cutoff() == bare.predict_cutoff()
    assert wrapped._step == bare._step == 8
    assert wrapped.predicted_iter_time() == bare.predicted_iter_time()
    assert torch.equal(wrapped.predicted_samples(), bare.predicted_samples())
    for a, b in zip(wrapped.predicted_order_stats(),
                    bare.predicted_order_stats()):
        np.testing.assert_array_equal(a, b)
    col_map = np.array([0, 2, 4, 6])
    bare.resize(4, col_map=col_map, model=rm4)
    wrapped.resize(4, col_map=col_map, model=rm4, members=np.arange(4))
    np.testing.assert_array_equal(bare.window_array(),
                                  wrapped.window_array())
    assert wrapped.predict_cutoff() == bare.predict_cutoff()


def test_policy_wrapper_window_protocol():
    ctl = tctl.AnytimeController(tctl.StaticCutoffController(4, cutoff=3))
    with pytest.raises(ValueError):
        ctl.window_array()
    ctl.seed_window(np.ones((3, 4)))      # no-op, must not raise
    assert ctl.predicted_samples() is None
    assert ctl.predicted_iter_time() is None


# ---------------------------------------------------------------------------
# int8 error-feedback compression (tests/test_substrates.py:53-84).
# ---------------------------------------------------------------------------


def _compress_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000).astype(np.float32)
    halves = (np.arange(-300, 301, dtype=np.float32) + 0.5) / 2.0
    return {"normal": x, "wide": x * np.float32(1e4),
            "tiny": x * np.float32(1e-30),
            "zeros": np.zeros(17, np.float32),
            # |x| / scale lands on .5 for many entries: half to even
            "halves": halves, "one_big": np.r_[x[:99], np.float32(1e3)]}


@pytest.mark.parametrize("name", sorted(_compress_inputs()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_codes_equal_jax(name, dtype):
    x = _compress_inputs()[name]
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = joptim.compress_int8(jx)
    tq, ts = toptim.compress_int8(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.dtype == torch.float32
    assert ts.item() == float(js)
    np.testing.assert_array_equal(
        toptim.decompress_int8(tq, ts).numpy(),
        np.asarray(joptim.decompress_int8(jq, js)))


def test_error_feedback_matches_jax():
    """Five EF steps over a two-leaf tree: the same codes on the first step
    (identical inputs), sent gradients and residuals within 1e-6 after."""
    rng = np.random.default_rng(1)
    gs = [{"a": rng.standard_normal((33, 7)).astype(np.float32) * 0.1,
           "b": [rng.standard_normal(129).astype(np.float32)]}
          for _ in range(5)]
    jr = tr = None
    for i, g in enumerate(gs):
        jsent, jr = joptim.error_feedback_compress(
            jax.tree.map(jnp.asarray, g), jr)
        tsent, tr = toptim.error_feedback_compress(
            tree.map(torch.from_numpy, g), tr)
        for a, b in zip(tree.leaves(tsent), jax.tree.leaves(jsent)):
            if i == 0:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        for a, b in zip(tree.leaves(tr), jax.tree.leaves(jr)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_error_feedback_unbiased_over_time(seed):
    """The cumulative sent update tracks the cumulative true gradient: the
    residual stays within one quantization step, no drift."""
    rng = np.random.default_rng(seed)
    g_true = torch.from_numpy(rng.normal(size=257) * 0.1)
    res, applied = None, torch.zeros(257, dtype=torch.float64)
    for _ in range(20):
        sent, res = toptim.error_feedback_compress({"g": g_true}, res)
        applied = applied + sent["g"]
    total_err = float((applied - 20 * g_true).abs().max())
    scale = float(g_true.abs().max())
    assert total_err <= scale / 127.0 * 1.5 + 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_roundtrip_error_bound(seed):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=1000))
    q, s = toptim.compress_int8(x)
    back = toptim.decompress_int8(q, s, torch.float64)
    assert float((back - x).abs().max()) <= float(s) * 0.5 + 1e-7


def test_compressed_step_matches_jax_and_carries_ef():
    """compress_pod_grads=True, one psum step from the same state: the
    state gains f32 residuals that agree with JAX's within 1e-6 except
    where the two packages' gradients (equal to ~1e-7) straddle a rounding
    boundary of the codes: there, at most 1% of the entries, they differ
    by one quantization step (twice the leaf's largest residual).  And
    ``state_from_jax`` carries JAX's residuals.

    One layer: JAX stacks a segment's repeated layers into one leaf and so
    quantizes all of them with ONE scale, where the port quantizes each
    layer's leaf with its own (ROADMAP C.7); with one layer the leaves, and
    the scales, are the same."""
    jc, tc = _cfgs(1)
    jopt, topt = joptim.adamw(LR), toptim.adamw(LR, fused=True)
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    jstate = {"params": params, "opt": jopt.init(params)}
    tstate = weights.state_from_jax(tc, _np_tree(jstate), device="cpu")
    mask = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    batch = SyntheticTokens(jc.vocab_size, 16, 8, seed=0).batch(0)
    jnew, _ = jit_train_step(jc, jopt, donate=False, mask_agg="psum",
                             compress_pod_grads=True)(
        jstate, dict(batch, mask=jnp.asarray(mask)))
    tnew, _ = TT.make_train_step(tc, topt, mask_agg="psum",
                                 compress_pod_grads=True)(
        tstate, dict(batch, mask=mask))
    got, want = _leaves_np(tc, tnew["ef"], jnew["ef"])
    for a, b in zip(got, want):
        d = np.abs(a - b)
        assert np.mean(d > 1e-6) <= 0.01
        assert d.max() <= 2.02 * np.abs(b).max() + 1e-6
    carried = weights.state_from_jax(tc, _np_tree(jnew), device="cpu")
    for a, b in zip(tree.leaves(carried["ef"]),
                    tree.leaves(weights.from_jax(tc, _np_tree(jnew["ef"]),
                                                 device="cpu"))):
        assert a.dtype == torch.float32 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The port's own race (tests/test_system.py:216, [tpu_pod_hosts-psum]).
# ---------------------------------------------------------------------------


def test_dmm_beats_static_and_sync_wall_clock_to_loss_tpu_pod_hosts():
    """The port's DMM (its own fit) against static 7 and full sync, 40
    psum steps each on the reference's setup: the DMM reaches full sync's
    final 3-step mean loss first by the simulated clock."""
    cfg = tget("qwen2-0.5b").reduced()
    trace = tpu_pod_hosts(8, seed=0).run(200)
    rm = TRM(n_workers=8, lag=10, device="cpu").init(0)
    rm.fit(trace, steps=200, batch=8, seed=0)
    dmm = tctl.CutoffController(rm, k_samples=32, seed=0)
    dmm.seed_window(trace)
    opt = toptim.adamw(LR, fused=True)
    step = TT.make_train_step(cfg, opt, mask_agg="psum")
    hist = {}
    for name, ctl in [("dmm", dmm),
                      ("static", tctl.StaticCutoffController(8, cutoff=7)),
                      ("sync", tctl.FullSyncController(8))]:
        tr = TT.Trainer(step_fn=step, data=SyntheticTokens(
            cfg.vocab_size, 16, 8, seed=0), controller=ctl,
            timer=tpu_pod_hosts(8, seed=9), n_workers=8, mask_agg="psum")

        def init():
            params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
            return {"params": params, "opt": opt.init(params)}

        hist[name] = tr.restore_or_init(init).run(40)
    target = float(np.mean([h["loss"] for h in hist["sync"][-3:]]))
    t = {k: TT.clock_to_loss(h, target) for k, h in hist.items()}
    assert t["dmm"] is not None, t
    assert t["static"] is None or t["dmm"] < t["static"], t
    assert t["sync"] is None or t["dmm"] < t["sync"], t
    assert min(h["c"] for h in hist["dmm"]) < 8
