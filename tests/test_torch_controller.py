"""The port's ``CutoffController`` against the JAX package's on the CPU.

The bar is the reference's own (``tests/test_controller_device.py``):
over 100 seeded ``paper_cluster_158`` steps the port's device backend
(the fused observe+decide, run eagerly on the CPU) gives the IDENTICAL
cutoff sequence as the reference's device controller, with the newest
window row within rtol = atol = 2e-3 (f32 imputation through erf/inverse
CDFs that round differently in XLA and torch), at least 50 censored steps
and more than one distinct cutoff.  The port's own two backends are held
to the same bar, and a DMM-driven 2-layer ``Trainer`` to the JAX
``Trainer``: the same cutoffs and simulated clock, losses within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.cluster.simulator import ClusterSim as JClusterSim
from repro.cluster.simulator import paper_cluster_158
from repro.configs.base import get_config as jget
from repro.core import controller as jctl
from repro.core.cutoff import order_stats
from repro.core.runtime_model.api import RuntimeModel as JRM
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.launch.train import Trainer as JTrainer
from repro.launch.train import jit_train_step
from repro.models import model as JM
from repro_torch import optim as toptim
from repro_torch import weights
from repro_torch.cluster.simulator import ClusterSim
from repro_torch.configs.base import get_config as tget
from repro_torch.core import controller as tctl
from repro_torch.core.runtime_model.api import RuntimeModel as TRM
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as TT

torch.set_num_threads(2)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _port(rm):
    return weights.runtime_model_from_jax(_np_tree(rm.params), rm.norm_scale,
                                          lag=rm.lag, device="cpu")


@pytest.fixture(scope="module")
def fitted_158():
    trace = paper_cluster_158(seed=0).run(60)
    rm = JRM(n_workers=158, lag=20).init(0)
    rm.fit(trace, steps=60, batch=8, seed=0)
    return rm, _port(rm), trace


def _drive(ctls, steps, sim_seed, check_window=True):
    """Run controllers side by side on one simulated cluster; every step
    their cutoffs must be equal.  Returns (cutoffs, censored steps)."""
    sim = paper_cluster_158(seed=sim_seed)
    cutoffs, censored = [], 0
    for step in range(steps):
        cs = [c.predict_cutoff() for c in ctls]
        assert len(set(cs)) == 1, (step, cs)
        cutoffs.append(cs[0])
        times = sim.step()
        mask = times <= order_stats.iter_time(times, cs[0]) + 1e-12
        censored += int(not mask.all())
        for c in ctls:
            c.observe(times, mask)
        if check_window:
            last = ctls[0].window_array()[-1]
            for c in ctls[1:]:
                np.testing.assert_allclose(
                    c.window_array()[-1], last, rtol=2e-3, atol=2e-3,
                    err_msg=f"step {step}")
    return cutoffs, censored


@pytest.mark.parametrize("other", ["jax_device", "port_numpy"])
def test_device_backend_matches_over_100_steps(fitted_158, other):
    """The port's device backend against the reference device controller,
    and against the port's f64 numpy backend."""
    rm, tm, trace = fitted_158
    dev = tctl.CutoffController(tm, k_samples=32, seed=0, backend="device")
    ref = (jctl.CutoffController(rm, k_samples=32, seed=0, backend="device")
           if other == "jax_device" else
           tctl.CutoffController(tm, k_samples=32, seed=0, backend="numpy"))
    dev.seed_window(trace)
    ref.seed_window(trace)
    np.testing.assert_allclose(dev.window_array(), ref.window_array(),
                               rtol=1e-6, atol=1e-6)
    cutoffs, censored = _drive([ref, dev], 100, 7)
    assert censored >= 50
    assert len(set(cutoffs)) > 1
    np.testing.assert_allclose(dev.window_array(), ref.window_array(),
                               rtol=2e-3, atol=2e-3)
    assert dev.predicted_iter_time() == pytest.approx(
        ref.predicted_iter_time(), rel=1e-3)


def test_numpy_backend_matches_the_reference_numpy_backend(fitted_158):
    rm, tm, trace = fitted_158
    ref = jctl.CutoffController(rm, k_samples=32, seed=0, backend="numpy")
    got = tctl.CutoffController(tm, k_samples=32, seed=0, backend="numpy")
    ref.seed_window(trace)
    got.seed_window(trace)
    _drive([ref, got], 30, 7)
    for a, b in zip(got.predicted_order_stats(),
                    ref.predicted_order_stats()):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)


def test_device_backend_deterministic(fitted_158):
    _, tm, trace = fitted_158
    runs = []
    for _ in range(2):
        ctl = tctl.CutoffController(tm, k_samples=16, seed=3)
        ctl.seed_window(trace)
        runs.append(_drive([ctl], 20, 11, check_window=False)[0])
    assert runs[0] == runs[1]


def test_device_predicted_order_stats_reuse_the_pending_samples(fitted_158):
    _, tm, trace = fitted_158
    ctl = tctl.CutoffController(tm, k_samples=16, seed=0)
    ctl.seed_window(trace)
    ctl.predict_cutoff()
    cached = ctl.predicted_samples().numpy().copy()
    mean, std = ctl.predicted_order_stats()
    want_mean, want_std = order_stats.mc_order_stats(cached)
    np.testing.assert_allclose(mean, want_mean, rtol=1e-6)
    np.testing.assert_allclose(std, want_std, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("backend", ["device", "numpy"])
def test_warmup_resize_and_refusals_match_jax(backend):
    """From an empty window (the plain-append warmup path), through a
    same-width resize with a survivor map and a resize to a refit model
    of a new width, against the reference controller of the same backend."""
    n, lag = 12, 4
    jr = JRM(n_workers=n, lag=lag).init(1)
    trace = JClusterSim(n_workers=n, n_nodes=3, seed=0).run(30)
    jr.fit(trace, steps=5, batch=4, seed=0)
    ref = jctl.CutoffController(jr, k_samples=16, seed=2, backend=backend)
    got = tctl.CutoffController(_port(jr), k_samples=16, seed=2,
                                backend=backend)
    with pytest.raises(ValueError, match="empty"):
        got.window_array()
    sim = JClusterSim(n_workers=n, n_nodes=3, seed=4)

    def steps(k):
        for _ in range(k):
            cs = (got.predict_cutoff(), ref.predict_cutoff())
            assert cs[0] == cs[1]
            times = sim.step()[:got.n]
            mask = times <= order_stats.iter_time(times, cs[0]) + 1e-12
            got.observe(times, mask)
            ref.observe(times, mask)
            np.testing.assert_allclose(got.window_array(),
                                       ref.window_array(), rtol=2e-3,
                                       atol=2e-3)

    steps(lag + 4)
    assert got.warmed_up
    col_map = np.array([3, 1, -1, 0, 4, 5, 6, 7, 8, 9, 10, 11])
    got.resize(n, col_map=col_map)
    ref.resize(n, col_map=col_map)
    steps(3)
    j8 = JRM(n_workers=8, lag=lag).init(2)
    j8.fit(trace[:, :8], steps=5, batch=4, seed=0)
    with pytest.raises(ValueError, match="width"):
        got.resize(8)
    got.resize(8, model=_port(j8))
    ref.resize(8, model=j8)
    steps(3)
    with pytest.raises(ValueError, match="all-False"):
        got.observe(np.ones(8), np.zeros(8, bool))


def test_unknown_backend_refused(fitted_158):
    with pytest.raises(ValueError, match="backend"):
        tctl.CutoffController(fitted_158[1], backend="tpu")


def test_remap_columns_matches_jax():
    rows = np.random.default_rng(0).uniform(size=(5, 6))
    for n_new, col_map in ((6, None), (4, None), (8, None),
                           (6, np.array([5, -1, 0, 2, -1, 1]))):
        np.testing.assert_array_equal(
            tctl.remap_columns(rows, n_new, col_map),
            jctl.remap_columns(rows, n_new, col_map))


def test_dmm_trainer_matches_the_jax_trainer():
    """A 2-layer reduced qwen2-0.5b, 8 workers, psum, cutoffs from the
    DMM controller on both sides (the same fitted model): the same c and
    clock every step, losses within 1e-5."""
    jc = dataclasses.replace(jget("qwen2-0.5b").reduced(), n_layers=2)
    tc = dataclasses.replace(tget("qwen2-0.5b").reduced(), n_layers=2)
    trace = JClusterSim(n_workers=8, n_nodes=2, seed=0).run(60)
    rm = JRM(n_workers=8, lag=20).init(0)
    rm.fit(trace, steps=20, batch=8, seed=0)
    jctl_ = jctl.CutoffController(rm, k_samples=48)
    tctl_ = tctl.CutoffController(_port(rm), k_samples=48)
    jctl_.seed_window(trace)
    tctl_.seed_window(trace)

    jopt = joptim.adamw(3e-3)
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    jinit = {"params": params, "opt": jopt.init(params)}
    jt = JTrainer(cfg=jc, step_fn=jit_train_step(jc, jopt, mask_agg="psum"),
                  data=JTokens(jc.vocab_size, 16, 8, seed=0),
                  controller=jctl_,
                  timer=JClusterSim(n_workers=8, n_nodes=2, seed=7),
                  n_workers=8, mask_agg="psum")
    jt.restore_or_init(lambda: jax.tree.map(jnp.copy, jinit))
    topt = toptim.adamw(3e-3, fused=True)
    tt = TT.Trainer(step_fn=TT.make_train_step(tc, topt, mask_agg="psum"),
                    data=SyntheticTokens(tc.vocab_size, 16, 8, seed=0),
                    controller=tctl_,
                    timer=ClusterSim(n_workers=8, n_nodes=2, seed=7),
                    n_workers=8, mask_agg="psum")
    tt.restore_or_init(lambda: weights.state_from_jax(tc, _np_tree(jinit),
                                                      device="cpu"))
    jh, th = jt.run(5), tt.run(5)
    assert [(h["c"], h["clock"]) for h in th] \
        == [(h["c"], h["clock"]) for h in jh]
    assert len({h["c"] for h in th}) > 1 or th[0]["c"] < 8
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=1e-5)
