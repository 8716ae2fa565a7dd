"""The paper's CNN workload on the port against the JAX package's.

On the CPU, at small sizes:

  * ``SyntheticImages`` batches and its valid set equal the reference's;
  * ``cnn_init(seed)`` draws the reference's params within the twin's
    normal tolerance, and ``weights.cnn_from_jax`` carries them exactly;
  * the loss and its gradient at batch 32, the mean and the 0/1
    worker-weighted CE, against ``jax.value_and_grad(cnn_loss)`` in f32
    (LOSS_TOL / GRAD_TOL: convolutions summed in another order);
  * ten steps of the Fig. 4 loop (``launch.cnn.run_cnn_cutoff``) under the
    port's ``CutoffController`` on the CPU, the JAX-fitted DMM carried
    across, against the same loop written here over the reference's
    functions: identical cutoffs, losses within LOOP_TOL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.cluster.simulator import ClusterSim as JClusterSim
from repro.core import controller as jctl
from repro.core.cutoff import order_stats
from repro.core.runtime_model.api import RuntimeModel as JRM
from repro.data.pipeline import SyntheticImages as JImages
from repro.models import cnn as jcnn
from repro_torch import optim as toptim
from repro_torch import weights
from repro_torch.cluster.simulator import ClusterSim
from repro_torch.core import controller as tctl
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.launch.cnn import run_cnn_cutoff
from repro_torch.models import cnn as tcnn

torch.set_num_threads(2)

NORMAL_TOL = (1e-6, 1e-7)    # (rtol, atol) of tests/test_torch_random.py
LOSS_TOL = (1e-5, 1e-6)      # (rtol, atol), f32
GRAD_TOL = (1e-5, 1e-6)      # (rtol, atol), f32: per-entry sums reorder
LOOP_TOL = (1e-5, 1e-6)      # ten momentum steps of the above


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def params_np():
    return _np_tree(jcnn.cnn_init(jax.random.PRNGKey(0)))


def test_synthetic_images_equal_the_reference():
    for kw in ({}, {"seed": 3, "noise": 0.9, "n_valid": 500}):
        a, b = SyntheticImages(**kw), JImages(**kw)
        np.testing.assert_array_equal(a.templates, b.templates)
        for step, n, worker in ((0, 16, None), (7, 5, 3), (150, 16, 31)):
            for x, y in zip(a.batch(step, n, worker=worker),
                            b.batch(step, n, worker=worker)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        for x, y in zip(a.valid_set(), b.valid_set()):
            np.testing.assert_array_equal(x, y)


def test_cnn_init_draws_the_reference_params(params_np):
    ours = tcnn.cnn_init(0, device="cpu")
    carried = weights.cnn_from_jax(params_np, device="cpu")
    for layer, p in params_np.items():
        for name, want in p.items():
            got = carried[layer][name].numpy()
            if want.ndim == 4:       # HWIO -> OIHW
                want = want.transpose(3, 2, 0, 1)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(ours[layer][name].numpy(), want,
                                       rtol=NORMAL_TOL[0], atol=NORMAL_TOL[1])


@pytest.mark.parametrize("weighted", [False, True])
def test_loss_and_grad_match_jax(params_np, weighted):
    data = JImages(seed=0, noise=0.9)
    x, y = data.batch(0, 32)
    # 8 workers of 4 examples; workers 2, 5 and 6 were cut
    w = np.repeat(np.array([1, 1, 0, 1, 1, 0, 0, 1], np.float32), 4)
    jw = jnp.asarray(w) if weighted else None
    jloss, jgrad = jax.value_and_grad(jcnn.cnn_loss)(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(x),
        jnp.asarray(y), jw)
    params = weights.cnn_from_jax(params_np, device="cpu")
    flat = {(k, n): t.requires_grad_(True) for k, p in params.items()
            for n, t in p.items()}
    loss = tcnn.cnn_loss(params, torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(w) if weighted else None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL[0],
                               atol=LOSS_TOL[1])
    for (k, n), t in flat.items():
        want = np.asarray(jgrad[k][n])
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=GRAD_TOL[0],
                                   atol=GRAD_TOL[1], err_msg=f"{k}.{n}")


def test_all_cut_weighted_loss_is_zero(params_np):
    x, y = SyntheticImages().batch(0, 4)
    loss = tcnn.cnn_loss(weights.cnn_from_jax(params_np, device="cpu"),
                         torch.from_numpy(x), torch.from_numpy(y),
                         torch.zeros(4))
    assert loss.item() == 0.0


def _jax_loop(rm, trace, params, n, steps, batch):
    """The reference's Fig. 4 loop (paper_figures.py, the DMM branch) at
    this test's size."""
    ctl = jctl.CutoffController(rm, k_samples=16, seed=0)
    ctl.seed_window(trace[-(rm.lag + 1):])
    opt = joptim.momentum(0.05, 0.9)

    @jax.jit
    def step(params, state, x, y, w):
        loss, g = jax.value_and_grad(jcnn.cnn_loss)(params, x, y, w)
        ups, state = opt.update(g, state, params)
        return joptim.apply_updates(params, ups), state, loss

    state = opt.init(params)
    data, timer, per = JImages(seed=0, noise=0.9), JClusterSim(
        n_workers=n, n_nodes=4, seed=21), batch // n
    cutoffs, losses = [], []
    for it in range(steps):
        times = timer.step()
        c = int(ctl.predict_cutoff())
        itime = order_stats.iter_time(times, c)
        ctl.observe(times, times <= itime + 1e-12)
        mask = (times <= itime + 1e-12).astype(np.float32)
        xs, ys = zip(*(data.batch(it, per, worker=w) for w in range(n)))
        params, state, loss = step(
            params, state, jnp.asarray(np.concatenate(xs)),
            jnp.asarray(np.concatenate(ys)), jnp.asarray(np.repeat(mask,
                                                                   per)))
        cutoffs.append(c)
        losses.append(float(loss))
    return cutoffs, losses


def test_cutoff_loop_matches_the_reference_loop(params_np):
    n, steps, batch = 8, 10, 64
    trace = JClusterSim(n_workers=n, n_nodes=4, seed=0).run(40)
    rm = JRM(n_workers=n, lag=10).init(0)
    rm.fit(trace, steps=40, batch=8, seed=0)
    want_c, want_l = _jax_loop(rm, trace, jax.tree.map(jnp.asarray,
                                                       params_np),
                               n, steps, batch)
    trm = weights.runtime_model_from_jax(_np_tree(rm.params), rm.norm_scale,
                                         lag=rm.lag, device="cpu")
    ctl = tctl.CutoffController(trm, k_samples=16, seed=0)
    ctl.seed_window(trace[-(rm.lag + 1):])
    out = run_cnn_cutoff(ctl, ClusterSim(n_workers=n, n_nodes=4, seed=21),
                         SyntheticImages(seed=0, noise=0.9),
                         weights.cnn_from_jax(params_np, device="cpu"),
                         toptim.momentum(0.05, 0.9), n_workers=n,
                         steps=steps, batch=batch, eval_every=5,
                         n_valid=200)
    assert out["cutoffs"] == want_c
    assert len(set(want_c)) > 1
    np.testing.assert_allclose(out["losses"], want_l, rtol=LOOP_TOL[0],
                               atol=LOOP_TOL[1])
    assert [round(t, 9) for t, _ in out["curve"]] == [
        round(t, 9) for t in np.cumsum([
            order_stats.iter_time(r, c) for r, c in zip(
                ClusterSim(n_workers=n, n_nodes=4, seed=21).run(steps),
                want_c)])[4::5]]
    assert np.all(np.isfinite([v for _, v in out["curve"]]))


def test_cnn_init_needs_a_card_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcnn.cnn_init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights.cnn_from_jax({})
