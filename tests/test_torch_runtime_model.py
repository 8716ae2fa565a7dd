"""The port's DMM runtime model (``repro_torch.core.runtime_model``) against
the JAX package on the CPU.  The reference params go into the port through
``weights.runtime_model_from_jax``; keys are the same seeds (the port draws
from its ``jax.random`` twin).

Tolerances: one pass (ELBO, predictions, the decision) differs from JAX by
f32 rounding and by the few-ulp normals of the twin: rtol 1e-5 on the
ELBO, atol 1e-5 on samples and moments of unit scale.  The fit feeds each
step's rounding into the next Adam step: the 20-step loss trajectory is
held to rtol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.simulator import paper_cluster_158
from repro.core.runtime_model import api as japi
from repro.core.runtime_model.api import RuntimeModel as JRM
from repro_torch import random as R
from repro_torch import tree, weights
from repro_torch.core.runtime_model import api as tapi
from repro_torch.core.runtime_model.api import RuntimeModel as TRM

torch.set_num_threads(2)

N, LAG = 24, 6


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def models():
    jr = JRM(n_workers=N, lag=LAG).init(3)
    jr.norm_scale = 1.7
    tr = weights.runtime_model_from_jax(_np_tree(jr.params), 1.7, lag=LAG,
                                        device="cpu")
    return jr, tr


@pytest.fixture(scope="module")
def trace():
    return paper_cluster_158(seed=0, n_workers=N).run(40)


def test_init_draws_the_reference_params():
    jr = JRM(n_workers=N, lag=LAG).init(5)
    tr = TRM(N, lag=LAG, device="cpu").init(5)
    want = jax.tree.leaves(jr.params)
    got = tree.leaves(tr.params)
    assert [tuple(x.shape) for x in got] == [x.shape for x in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_runtime_model_from_jax_reads_the_widths(models):
    jr, tr = models
    assert (tr.n_workers, tr.lag, tr.z_dim, tr.hidden, tr.norm_scale) \
        == (jr.n_workers, jr.lag, jr.z_dim, jr.hidden, 1.7)
    assert tr.device == torch.device("cpu")


def test_model_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRM(N)


@pytest.mark.parametrize("seed", [0, 11])
def test_elbo_matches_jax(models, seed):
    jr, tr = models
    x = np.random.default_rng(seed).normal(1.0, 0.3, size=(4, LAG + 1, N)
                                           ).astype(np.float32)
    want = float(jr.elbo(jnp.asarray(x), jax.random.PRNGKey(seed)))
    got = float(tr.elbo(torch.as_tensor(x), R.PRNGKey(seed)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_colwise_draws_match_jax():
    for n in (1, 8, 158):
        np.testing.assert_array_equal(
            tapi.colwise_uniform(R.PRNGKey(4), n).numpy(),
            np.asarray(japi.colwise_uniform(jax.random.PRNGKey(4), n)))
        np.testing.assert_allclose(
            tapi.colwise_normal(R.PRNGKey(4), 16, n).numpy(),
            np.asarray(japi.colwise_normal(jax.random.PRNGKey(4), 16, n)),
            rtol=1e-6, atol=1e-7)


def test_predict_next_matches_jax(models, trace):
    jr, tr = models
    w = trace[:LAG + 1]
    for a, b in zip(tr.predict_next(w, 16, seed=3),
                    jr.predict_next(w, 16, seed=3)):
        assert a.dtype == np.float32 and a.shape == (16, N)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("head,lo", [(0, 0), (4, 12), (6, 23)])
def test_decide_core_matches_jax(models, trace, head, lo):
    """Equal cutoff; samples, moments and E[x_(c)] allclose, with the ring
    read from ``head`` (the oldest row) onwards."""
    jr, tr = models
    ring = trace[5:5 + LAG + 1].astype(np.float32)
    want = JRM._decide_core(jr.params, jnp.asarray(ring), jnp.int32(head),
                            jax.random.PRNGKey(9), jnp.float32(1.7), 32, lo)
    got = TRM._decide_core(tr.params, torch.as_tensor(ring),
                           torch.tensor(head), R.PRNGKey(9), 1.7, 32, lo)
    assert got[0].dtype == torch.int32
    assert int(got[0]) == int(want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_fit_loss_trajectory_matches_jax(trace):
    jl = JRM(n_workers=N, lag=LAG).init(0).fit(trace, steps=20, batch=8,
                                               seed=0)
    tm = TRM(N, lag=LAG, device="cpu").init(0)
    tl = tm.fit(trace, steps=20, batch=8, seed=0)
    assert len(tl) == 20 and all(isinstance(x, float) for x in tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]
    assert tm.norm_scale == pytest.approx(
        float(2.0 * trace[:LAG + 1].astype(np.float32).mean()))


def test_fit_refuses_a_short_trace():
    with pytest.raises(ValueError, match="too short"):
        TRM(N, lag=LAG, device="cpu").fit(np.ones((LAG + 1, N)), steps=1)
