"""The port's multi-tenant parameter server against the JAX package's.

Held on the CPU, with the JAX-fitted DMMs carried across by
``weights.runtime_model_from_jax`` and the same windows, seeds and traces:

  * the host-built key rows and the batched impute keys bit for bit;
  * ``stack_models_padded`` / ``_pad_width_params`` element for element;
  * the ragged batched decision at widths 16/10/6 padded to 16: cutoffs
    equal to JAX's ``_batched_decide_ragged`` and to the port's unpadded
    single-job ``_decide_core``, samples in the real columns within
    ``SAMPLE_TOL`` (f32 sums in another order per shape);
  * the port's ``PSServer`` against JAX's, J = 3 at width 16, the ragged
    16/10/6 bucket and a capacity-2 schedule, 40 ticks: identical cutoff
    sequences, windows within rtol = atol = 1e-4, one launch a bucket a
    tick; J = 1 at n = 158 against the port's own ``CutoffController``;
  * C.12: where a server's window leaves its controller's (imputed
    entries only, in both packages) and why (the f32 imputation's tail);
  * the reference's server contracts (tests/test_ps_server.py) on the
    port, and the schedulers and ``PartitionedSim`` against the copies'
    originals.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import simulator as jsim
from repro.core import controller as jctl
from repro.core.cutoff import order_stats
from repro.core.runtime_model import api as japi
from repro.core.runtime_model.api import RuntimeModel as JRM
from repro.ps import PSServer as JPSServer
from repro.ps import scheduler as jsched
from repro_torch import weights
from repro_torch.cluster import simulator as tsim
from repro_torch.core import controller as tctl
from repro_torch.core.cutoff import censoring as tcen
from repro_torch.core.runtime_model import api as tapi
from repro_torch.core.runtime_model.api import RuntimeModel as TRM
from repro_torch.ps import PSServer, make_scheduler
from repro_torch.ps import scheduler as tsched
from repro_torch.tree import leaves

torch.set_num_threads(2)

WINDOW_TOL = 1e-4        # rtol = atol, the reference's server tests
SAMPLE_TOL = 1e-5        # rtol = atol: padded vs unpadded, port vs JAX


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _port(rm):
    return weights.runtime_model_from_jax(_np_tree(rm.params), rm.norm_scale,
                                          lag=rm.lag, device="cpu")


def _fit(n, lag, seed, steps=50, rows=40):
    trace = jsim.paper_cluster_158(seed=seed, n_workers=n).run(rows)
    rm = JRM(n_workers=n, lag=lag).init(0)
    rm.fit(trace, steps=steps, batch=8, seed=0)
    return rm, _port(rm), trace


@pytest.fixture(scope="module")
def fitted_16():
    return _fit(16, 10, 0, steps=60, rows=60)


@pytest.fixture(scope="module")
def fitted_mixed():
    """Three DMMs at widths 16/10/6 with one decision architecture."""
    return [_fit(n, 10, n) for n in (16, 10, 6)]


def _drive(controller, sim, steps, prefetch=None, flush=None):
    """Standard predict/observe cycle; returns the cutoff sequence."""
    seq = []
    for _ in range(steps):
        if prefetch is not None:
            prefetch()
        c = controller.predict_cutoff()
        times = sim.step()
        it = order_stats.iter_time(times, c)
        controller.observe(times, times <= it + 1e-12)
        if flush is not None:
            flush()
        seq.append(int(c))
    return seq


# ---------------------------------------------------------------------------
# Keys, stacking and the ragged decision.
# ---------------------------------------------------------------------------


SEEDS = [0, 1, 7, 123456789, 2**31, 2**33 + 5]


def test_prng_key_rows_and_stacked_keys_match_jax():
    rows = tctl._prng_key_rows(SEEDS)
    np.testing.assert_array_equal(rows, jctl._prng_key_rows(SEEDS))
    stack = tctl.stacked_prng_keys(SEEDS, device="cpu").numpy()
    for row, s in zip(stack, SEEDS):
        np.testing.assert_array_equal(row, np.asarray(jax.random.PRNGKey(s)))


def test_batched_impute_keys_match_jax_and_single():
    seeds, steps = [3, 9, 250], [5, 11, 40]
    base = [s + 1_000_003 for s in seeds]
    got = tctl._batched_impute_keys(tctl.stacked_prng_keys(base),
                                    torch.tensor(steps)).numpy()
    want = np.asarray(jctl._batched_impute_keys(
        jctl.stacked_prng_keys(base), jnp.asarray(steps, jnp.uint32)))
    np.testing.assert_array_equal(got, want)
    for row, s, t in zip(got, seeds, steps):
        np.testing.assert_array_equal(row, tctl._impute_key(s, t))


@pytest.mark.parametrize("draw", ["split", "fold_in", "uniform", "normal",
                                  "colwise_uniform", "colwise_normal"])
def test_twin_draws_take_a_key_stack(draw):
    """A (J, 2) key stack gives, row for row, the single key's draw: the
    batched decision leans on it for every key it folds and draws."""
    from repro_torch import random as R

    seeds = [3, 11, 2**31 + 7]
    stack = tctl.stacked_prng_keys(seeds)
    fns = {"split": lambda k: R.split(k, 4),
           "fold_in": lambda k: R.fold_in(k, 5),
           "uniform": lambda k: R.uniform(k, (6, 3)),
           "normal": lambda k: R.normal(k, (6, 3)),
           "colwise_uniform": lambda k: tapi.colwise_uniform(k, 7),
           "colwise_normal": lambda k: tapi.colwise_normal(k, 4, 7)}
    got = fns[draw](stack)
    for j, s in enumerate(seeds):
        torch.testing.assert_close(got[j], fns[draw](R.PRNGKey(s)),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("n_pad", [16, 20])
def test_stack_models_padded_matches_jax(fitted_mixed, n_pad):
    jms = [j for j, _, _ in fitted_mixed]
    tms = [t for _, t, _ in fitted_mixed]
    jp, js = japi.stack_models_padded(jms, n_pad)
    tp, ts = tapi.stack_models_padded(tms, n_pad)
    jl, tl = jax.tree.leaves(jp), leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for jm, tm in zip(jms, tms):
        for a, b in zip(
                jax.tree.leaves(japi._pad_width_params(jm.params,
                                                       jm.n_workers, n_pad)),
                leaves(tapi._pad_width_params(tm.params, tm.n_workers,
                                              n_pad))):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_stacking_refusals():
    a = TRM(8, lag=10, device="cpu").init(0)
    b = TRM(6, lag=10, device="cpu").init(0)
    c = TRM(6, lag=5, device="cpu").init(0)
    with pytest.raises(ValueError, match="shapes"):
        tapi.stack_models([a, b])
    with pytest.raises(ValueError, match="architectures"):
        tapi.stack_models_padded([a, c], 8)
    with pytest.raises(ValueError, match="exceeds"):
        tapi.stack_models_padded([a], 6)
    params, scales = tapi.stack_models([a, a])
    assert scales.shape == (2,) and leaves(params)[0].shape[0] == 2


def _rings(traces, n_pad, heads, cap):
    """(J, cap, n_pad) rings holding each trace's last cap rows, rolled so
    that ``heads[j]`` is the oldest row."""
    out = np.zeros((len(traces), cap, n_pad), np.float32)
    for j, tr in enumerate(traces):
        w = np.asarray(tr[-cap:], np.float32)
        out[j, :, :w.shape[1]] = np.roll(w, heads[j], axis=0)
    return out


def test_ragged_decide_matches_jax_and_the_single_job(fitted_mixed):
    jms = [j for j, _, _ in fitted_mixed]
    tms = [t for _, t, _ in fitted_mixed]
    widths, n_pad, cap, K = [16, 10, 6], 16, 11, 16
    heads = [3, 0, 7]
    rings = _rings([tr for _, _, tr in fitted_mixed], n_pad, heads, cap)
    seeds = [5, 6, 7]
    los = [order_stats.min_frac_floor(n, 0.5) for n in widths]
    jp, js = japi.stack_models_padded(jms, n_pad)
    jc, jsamp, *_ = jctl._batched_decide_ragged(
        jp, jnp.asarray(rings), jnp.asarray(heads, jnp.int32),
        jctl.stacked_prng_keys(seeds), js, jnp.asarray(widths, jnp.int32),
        jnp.asarray(los, jnp.int32), k_samples=K)
    tp, ts = tapi.stack_models_padded(tms, n_pad)
    tc, tsamp, tmu, tstd, tit = tctl._batched_decide_ragged(
        tapi.batched_layout(tp), torch.from_numpy(rings),
        torch.tensor(heads), tctl.stacked_prng_keys(seeds), ts,
        torch.tensor(widths), torch.tensor(los), k_samples=K)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for j, (tm, n) in enumerate(zip(tms, widths)):
        np.testing.assert_allclose(tsamp[j, :, :n].numpy(),
                                   np.asarray(jsamp)[j, :, :n],
                                   rtol=SAMPLE_TOL, atol=SAMPLE_TOL)
        assert torch.isinf(tsamp[j, :, n:]).all()
        c, samp, mu, std, it = TRM._decide_core(
            tm.params, torch.from_numpy(rings[j, :, :n].copy()),
            torch.tensor(heads[j]), tctl.stacked_prng_keys([seeds[j]])[0],
            tm.norm_scale, K, los[j])
        assert int(c) == int(tc[j])
        np.testing.assert_allclose(tsamp[j, :, :n].numpy(), samp.numpy(),
                                   rtol=SAMPLE_TOL, atol=SAMPLE_TOL)
        np.testing.assert_allclose(tmu[j, :n].numpy(), mu.numpy(),
                                   rtol=SAMPLE_TOL, atol=SAMPLE_TOL)
        np.testing.assert_allclose(float(tit[j]), float(it), rtol=SAMPLE_TOL)


def test_ragged_cutoff_full_width_equals_static():
    g = torch.Generator().manual_seed(0)
    samples = torch.rand((3, 32, 12), generator=g) + 0.5
    for lo in (0, 5, 11):
        c, it = tapi.order_stats.cutoff_and_iter_ragged_torch(
            samples, torch.full((3,), lo), torch.full((3,), 12))
        for j in range(3):
            cs, its = tapi.order_stats.cutoff_and_iter_torch(samples[j], lo)
            assert int(c[j]) == int(cs)
            assert float(it[j]) == float(its)


# ---------------------------------------------------------------------------
# The server against JAX's server, and J = 1 against the port's controller.
# ---------------------------------------------------------------------------


def _servers(fitted, k, seed_of, **kw):
    js, ts = JPSServer(**kw), PSServer(**kw)
    jh, th = [], []
    for j, (jm, tm, tr) in enumerate(fitted):
        jh.append(js.admit(f"job{j}", jm, window=tr, k_samples=k,
                           seed=seed_of(j)))
        th.append(ts.admit(f"job{j}", tm, window=tr, k_samples=k,
                           seed=seed_of(j)))
    return js, ts, jh, th


@pytest.mark.parametrize("case", ["j3_w16", "ragged_16_10_6", "capacity2"])
def test_psserver_matches_jax_psserver(case, fitted_16, fitted_mixed):
    """40 ticks: identical cutoff sequences, windows within 1e-4, one
    launch a bucket a tick (a capacity-2 round robin services a subset of
    the bucket through the same launch)."""
    fitted = ([fitted_16] * 3 if case == "j3_w16" else fitted_mixed)
    js, ts, jh, th = _servers(fitted, 16, lambda j: 11 * j)
    assert len(ts._buckets) == 1
    capacity = 2 if case == "capacity2" else None
    jsch, tsch = jsched.make_scheduler("rr"), make_scheduler("rr")
    widths = [tm.n_workers for _, tm, _ in fitted]
    sims = [tsim.paper_cluster_158(seed=300 + j, n_workers=w)
            for j, w in enumerate(widths)]
    censored, seqs = 0, [[] for _ in fitted]
    for tick in range(40):
        order = tsch.order(tsched.job_views(ts), capacity)
        assert order == jsch.order(jsched.job_views(js), capacity)
        js.prefetch(order)
        ts.prefetch(order)
        for job_id in order:
            j = int(job_id[3:])
            cj = jh[j].predict_cutoff()
            ct = th[j].predict_cutoff()
            assert cj == ct, (tick, j, cj, ct)
            seqs[j].append(ct)
            t = sims[j].step()
            mask = t <= order_stats.iter_time(t, ct) + 1e-12
            censored += int(not mask.all())
            jh[j].observe(t, mask)
            th[j].observe(t, mask)
        assert js.flush() == 1
        assert ts.flush() == 1, tick
    assert censored >= 20
    assert any(len(set(s)) > 1 for s in seqs)
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b.window_array(), a.window_array(),
                                   rtol=WINDOW_TOL, atol=WINDOW_TOL)
        assert b.predicted_iter_time() == pytest.approx(
            a.predicted_iter_time(), rel=1e-4)


def test_psserver_j1_158_matches_the_port_controller():
    """J = 1 at n = 158 gives the port's own CutoffController's cutoffs
    over 100 steps (the reference's J = 1 parity test fails in the
    reference on its window tolerance, so the port is held to its own
    controller here)."""
    trace = tsim.paper_cluster_158(seed=0).run(60)
    rm = TRM(158, lag=20, device="cpu").init(0)
    rm.fit(trace, steps=30, batch=8, seed=0)
    ref = tctl.CutoffController(rm, k_samples=32, seed=0)
    ref.seed_window(trace)
    srv = PSServer()
    h = srv.admit("job0", rm, window=trace, k_samples=32, seed=0)
    np.testing.assert_array_equal(h.window_array(), ref.window_array())
    sim = tsim.paper_cluster_158(seed=7)
    cutoffs, censored = [], 0
    for step in range(100):
        c_ref, c_ps = ref.predict_cutoff(), h.predict_cutoff()
        assert c_ref == c_ps, (step, c_ref, c_ps)
        cutoffs.append(c_ref)
        times = sim.step()
        mask = times <= order_stats.iter_time(times, c_ref) + 1e-12
        censored += int(not mask.all())
        ref.observe(times, mask)
        h.observe(times, mask)
        assert srv.flush() == 1
    assert censored >= 50 and len(set(cutoffs)) > 1
    np.testing.assert_allclose(h.window_array(), ref.window_array(),
                               rtol=WINDOW_TOL, atol=WINDOW_TOL)


# C.12: the server's window beside a looped controller's, entry by entry.
# Observed entries are the step's runtimes copied in; an imputed entry is
# a truncated-normal inverse-CDF draw, which f32 quantizes deep in the
# tail.  chip_smoke.py holds the card's server to SERVER_WINDOW_TOL, the
# reference's 1e-4 (WINDOW_TOL here), which the card meets since the
# controller divides its ring by a tensor scale as the server does;
# scripts/torch_c12_stages.py replays both decisions stage by stage.


def _window_gap(ctl, h, srv, sim, steps=100):
    """Drive a controller and a J = 1 server job in lockstep (the
    reference's test_psserver_j1_identical_cutoffs_158 loop); return
    |window difference| and the imputed entries of the final window."""
    masks = [np.ones(ctl.n, bool)] * (ctl.model.lag + 1)   # seeded rows
    for step in range(steps):
        c = ctl.predict_cutoff()
        assert h.predict_cutoff() == c, step
        t = sim.step()
        mask = t <= order_stats.iter_time(t, c) + 1e-12
        ctl.observe(t, mask)
        h.observe(t, mask)
        srv.flush()
        masks = masks[1:] + [mask]
    return (np.abs(h.window_array() - ctl.window_array()),
            ~np.stack(masks))


def test_server_window_drift_lies_in_imputed_entries():
    """Over the reference test's 100 paper_cluster_158 ticks (its fitted
    DMM, carried across): the port's CPU server against the port's CPU
    controller, and the reference's server against its controller.
    Every entry that differs by more than 1e-4 in either pair is an
    imputed one, observed entries are equal, and the port's server equals
    its controller (on the CPU both divide by the scale truly; so does
    the card since C.12's repair)."""
    trace = jsim.paper_cluster_158(seed=0).run(60)
    rm = JRM(n_workers=158, lag=20).init(0)
    rm.fit(trace, steps=60, batch=8, seed=0)
    trm = _port(rm)
    gaps = {}
    for name, ctl_cls, srv_cls, model in (
            ("reference", jctl.CutoffController, JPSServer, rm),
            ("port", tctl.CutoffController, PSServer, trm)):
        ctl = ctl_cls(model, k_samples=32, seed=0)
        ctl.seed_window(trace)
        srv = srv_cls()
        h = srv.admit("job0", model, window=trace, k_samples=32, seed=0)
        gaps[name] = _window_gap(ctl, h, srv, jsim.paper_cluster_158(seed=7))
    for name, (d, imputed) in gaps.items():
        assert imputed.any() and (~imputed).any(), name
        assert np.all(d[~imputed] == 0.0), name
        assert not np.any((d > 1e-4) & ~imputed), name
    d, _ = gaps["port"]
    assert np.all(d <= WINDOW_TOL) and np.all(d == 0.0)


@pytest.mark.parametrize("depth", [4.0, 4.5])
def test_one_ulp_of_the_mean_moves_a_deep_tail_imputation(depth):
    """The cause of C.12: left-truncated ``depth`` sigmas above the mean,
    the f32 imputation's CDF value sits within ~1e-5 of 1, where its
    spacing is 6e-8, so a one-ulp step of the predictive mean can flip it
    and move the draw by thousands of the mean's ulps; the f64 twin moves
    with the mean."""
    n = 4000
    bits = np.float32(1.0).view(np.int32) + np.arange(n, dtype=np.int32)
    mu = bits.view(np.float32)
    sigma = np.full(n, 0.3, np.float32)
    lower = np.full(n, 1.0 + depth * 0.3, np.float32)
    u = np.full(n, 0.5, np.float32)
    x32 = tcen.truncated_normal_sample_torch(
        *(torch.from_numpy(a) for a in (mu, sigma, lower, u))).numpy()
    x64 = tcen.truncated_normal_sample(mu, sigma, lower, u=u)
    step = np.diff(mu.astype(np.float64))
    assert np.max(np.abs(np.diff(x32)) / step) > 1000
    assert np.max(np.abs(np.diff(x32))) > 1e-4
    assert np.max(np.abs(np.diff(x64)) / step) < 2


def test_psserver_deterministic(fitted_16):
    _, rm, trace = fitted_16
    runs = []
    for _ in range(2):
        srv = PSServer()
        h = srv.admit("a", rm, window=trace, k_samples=16, seed=3)
        runs.append(_drive(h, tsim.paper_cluster_158(seed=11, n_workers=16),
                           20, prefetch=srv.prefetch, flush=srv.flush))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# Registry / elasticity / checkpoint contracts (tests/test_ps_server.py).
# ---------------------------------------------------------------------------


def test_registry_admission_contracts(fitted_16):
    _, rm, trace = fitted_16
    srv = PSServer()
    srv.admit("a", rm, window=trace, seed=0)
    with pytest.raises(ValueError):
        srv.admit("a", rm)                        # duplicate id
    with pytest.raises(ValueError):
        srv.admit("b", rm, members=np.arange(4))  # wrong membership width
    with pytest.raises(ValueError):
        srv.admit("c", TRM(16, lag=10, device="cpu"))  # unfitted
    assert srv.registry.ids() == ["a"]
    out = srv.evict("a")
    assert out["window"].shape[1] == 16
    assert "a" not in srv.registry
    # telemetry is accepted: a flush with nothing queued records no span
    from repro_torch.obs import ObsRun

    obs = ObsRun()
    assert PSServer(obs=obs).flush() == 0 and obs.trace.spans == []


def test_mixed_architectures_bucket_separately():
    trace = tsim.paper_cluster_158(seed=0, n_workers=8).run(20)
    a = TRM(8, lag=5, z_dim=8, device="cpu").init(0)
    b = TRM(8, lag=5, z_dim=16, device="cpu").init(0)
    for rm in (a, b):
        rm.norm_scale = float(2.0 * trace[:6].mean())
    srv = PSServer()
    ha = srv.admit("a", a, window=trace, k_samples=8, seed=0)
    hb = srv.admit("b", b, window=trace, k_samples=8, seed=1)
    assert srv.registry["a"].bucket_sig != srv.registry["b"].bucket_sig
    for h in (ha, hb):
        c = h.predict_cutoff()
        assert 1 <= c <= 8
        times = tsim.paper_cluster_158(seed=3, n_workers=8).step()
        h.observe(times, times <= np.sort(times)[c - 1] + 1e-12)
    assert srv.flush() == 2          # one launch per architecture


@pytest.mark.parametrize("bad", ["width", "all_false"])
def test_observe_refusals_mutate_nothing(fitted_16, bad):
    _, rm, trace = fitted_16
    srv = PSServer()
    h = srv.admit("a", rm, window=trace, k_samples=16, seed=0)
    h.predict_cutoff()
    before = np.asarray(h.window_array()).copy()
    trace_len = len(h.job.trace)
    with pytest.raises(ValueError, match=("width" if bad == "width"
                                          else "all-False")):
        if bad == "width":
            h.observe(np.ones(12))
        else:
            h.observe(np.ones(16), np.zeros(16, dtype=bool))
    np.testing.assert_array_equal(h.window_array(), before)
    assert len(h.job.trace) == trace_len
    t = tsim.paper_cluster_158(seed=2, n_workers=16).step()
    h.observe(t, t <= np.sort(t)[7] + 1e-12)
    assert srv.flush() == 1


def test_resize_without_model_degrades_then_refits(fitted_16):
    _, rm, trace = fitted_16
    srv = PSServer(refit_steps=30, refit_fresh=3)
    h = srv.admit("a", rm, window=trace, k_samples=16, seed=0)
    win_before = h.window_array()
    h.resize(12, col_map=np.arange(12))
    assert h.mode == "fallback" and h.n == 12
    np.testing.assert_allclose(h.window_array()[-win_before.shape[0]:],
                               win_before[:, :12], rtol=1e-6, atol=1e-6)
    seq = _drive(h, tsim.paper_cluster_158(seed=6, n_workers=12), 25,
                 flush=srv.flush)
    assert all(1 <= c <= 12 for c in seq)
    assert h.mode == "dmm", "refit should have rejoined the batched path"
    assert h.job.model.n_workers == 12


@pytest.mark.parametrize("outcome", ["retry_recovers", "budget_spent"])
def test_refit_failure(fitted_16, monkeypatch, outcome):
    """A failed async refit is logged and retried after the doubled
    fresh-row backoff, and a success rejoins the batched path; past the
    retry budget the failure surfaces as RefitError naming the job."""
    _, rm, trace = fitted_16
    retries = 1 if outcome == "retry_recovers" else 0
    srv = PSServer(refit_steps=30, refit_fresh=3 if retries else 2,
                   refit_async=True, refit_retries=retries)
    h = srv.admit("a", rm, window=trace, k_samples=16, seed=0)
    h.resize(12, col_map=np.arange(12))
    real, calls = srv._fit_model, {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1 or outcome == "budget_spent":
            raise RuntimeError("ELBO diverged")
        return real(*a, **kw)

    monkeypatch.setattr(srv, "_fit_model", flaky)
    if outcome == "budget_spent":
        _drive(h, tsim.paper_cluster_158(seed=6, n_workers=12), 2,
               flush=srv.flush)
        with pytest.raises(tctl.RefitError, match="job 'a'"):
            srv.wait_refits()
        return
    _drive(h, tsim.paper_cluster_158(seed=6, n_workers=12), 3,
           flush=srv.flush)
    srv.wait_refits()                     # first fit fails: logged only
    assert h.mode == "fallback" and h.job.refit_failures == 1
    _drive(h, tsim.paper_cluster_158(seed=7, n_workers=12), 3,
           flush=srv.flush)
    assert h.job.refit_task is None       # 3 fresh < 6 needed under backoff
    _drive(h, tsim.paper_cluster_158(seed=8, n_workers=12), 3,
           flush=srv.flush)
    srv.wait_refits()                     # retry at 2x fresh, wins
    assert h.mode == "dmm" and h.job.refit_failures == 0
    assert calls["n"] == 2


def test_resize_same_width_is_a_noop(fitted_16):
    _, rm, trace = fitted_16
    srv = PSServer()
    h = srv.admit("a", rm, window=trace, k_samples=16, seed=0,
                  members=np.arange(30, 46))
    h.resize(16)
    assert h.mode == "dmm" and h.job.model is rm
    np.testing.assert_array_equal(h.job.members, np.arange(30, 46))


def test_resize_with_model_stays_on_dmm_path(fitted_16):
    _, rm, trace = fitted_16
    rm12 = TRM(12, lag=10, device="cpu").init(1)
    rm12.norm_scale = rm.norm_scale
    srv = PSServer()
    h = srv.admit("a", rm, window=trace, k_samples=16, seed=0)
    h.resize(12, col_map=np.arange(12), model=rm12)
    assert h.mode == "dmm" and h.n == 12
    with pytest.raises(ValueError):
        h.resize(10, model=rm12)                 # wrong-width model
    seq = _drive(h, tsim.paper_cluster_158(seed=6, n_workers=12), 5,
                 flush=srv.flush)
    assert all(1 <= c <= 12 for c in seq)


def test_resized_members_width0_is_a_clear_error():
    with pytest.raises(ValueError, match="width-0"):
        PSServer._resized_members(np.array([], dtype=int), 4, None, None)
    got = PSServer._resized_members(np.array([], dtype=int), 3,
                                    None, np.array([7, 8, 9]))
    np.testing.assert_array_equal(got, [7, 8, 9])


def test_checkpoint_group_roundtrip(fitted_16):
    _, rm, trace = fitted_16
    srv = PSServer()
    h = srv.admit("a", rm, window=trace, k_samples=16, seed=0,
                  members=np.arange(30, 46))
    _drive(h, tsim.paper_cluster_158(seed=5, n_workers=16), 4,
           flush=srv.flush)
    grp = srv.checkpoint_groups()["ps/a"]
    assert int(grp["n"]) == 16 and int(grp["step"]) == 4
    np.testing.assert_array_equal(grp["members"], np.arange(30, 46))
    srv2 = PSServer()
    h2 = srv2.admit("a", rm, k_samples=16, seed=0)
    h2.seed_window(grp["window"])
    h2._step = int(grp["step"])
    np.testing.assert_allclose(h2.window_array(), h.window_array(),
                               rtol=1e-6, atol=1e-6)
    assert h2.predict_cutoff() == h.predict_cutoff()


def test_ragged_bucket_repacks_on_widest_evict(fitted_mixed):
    """Evicting the widest job shrinks the pad width, and the survivor's
    decisions keep matching its own controller across the repack."""
    srv = PSServer()
    handles = [srv.admit(f"job{j}", tm, window=tr, k_samples=16,
                         seed=11 * j)
               for j, (_, tm, tr) in enumerate(fitted_mixed)]
    b = srv._buckets[srv.registry["job1"].bucket_sig]
    assert b.n_pad == 16
    srv.evict("job0")
    assert b.n_pad == 10 and b.st["rings"].shape == (2, 11, 10)
    ref = tctl.CutoffController(fitted_mixed[1][1], k_samples=16, seed=11)
    ref.seed_window(np.asarray(handles[1].window_array()))
    sim = tsim.paper_cluster_158(seed=42, n_workers=10)
    for step in range(10):
        c_ref = ref.predict_cutoff()
        c_ps = handles[1].predict_cutoff()
        assert c_ref == c_ps, (step, c_ref, c_ps)
        t = sim.step()
        mask = t <= order_stats.iter_time(t, c_ref) + 1e-12
        ref.observe(t, mask)
        handles[1].observe(t.copy(), mask)
        srv.flush()


def test_async_refit_never_blocks_a_tick(fitted_16, monkeypatch):
    _, rm, trace = fitted_16
    srv = PSServer(refit_steps=5, refit_fresh=2, refit_async=True)
    ha = srv.admit("a", rm, window=trace, k_samples=16, seed=0)
    hb = srv.admit("b", rm, window=trace, k_samples=16, seed=1)
    gate = threading.Event()
    real_fit = TRM.fit

    def gated_fit(self, *args, **kwargs):
        gate.wait(timeout=60)
        return real_fit(self, *args, **kwargs)

    monkeypatch.setattr(TRM, "fit", gated_fit)
    hb.resize(12, col_map=np.arange(12))
    sim_a = tsim.paper_cluster_158(seed=6, n_workers=16)
    sim_b = tsim.paper_cluster_158(seed=7, n_workers=12)
    for _ in range(12):
        for h, sim in ((ha, sim_a), (hb, sim_b)):
            c = h.predict_cutoff()
            t = sim.step()
            h.observe(t, t <= order_stats.iter_time(t, c) + 1e-12)
        srv.flush()
    task = srv.registry["b"].refit_task
    assert task is not None and task[0].is_alive()
    assert hb.mode == "fallback"
    gate.set()
    srv.wait_refits()
    assert hb.mode == "dmm" and hb.job.model.n_workers == 12
    assert ha.mode == "dmm" and ha.job.model is rm


def test_install_in_observe_spawns_no_second_refit(fitted_16):
    """An async refit that lands during an observe puts the job back on
    the DMM with no refit in flight; the reference's observe spawns a
    second fit there (ROADMAP C.11), whose result it discards."""
    jm, tm, trace = fitted_16
    tasks = {}
    for name, srv, rm in (("port", PSServer(refit_steps=5, refit_fresh=2,
                                            refit_async=True), tm),
                          ("jax", JPSServer(refit_steps=5, refit_fresh=2,
                                            refit_async=True), jm)):
        h = srv.admit("a", rm, window=trace, k_samples=16, seed=0)
        h.resize(12, col_map=np.arange(12))
        sim = tsim.paper_cluster_158(seed=6, n_workers=12)
        while h.job.refit_task is None:
            t = sim.step()
            h.observe(t, t <= np.sort(t)[8] + 1e-12)
        h.job.refit_task[0].join()
        t = sim.step()
        h.observe(t, t <= np.sort(t)[8] + 1e-12)   # the poll installs
        assert h.mode == "dmm" and h.n == 12
        tasks[name] = h.job.refit_task
    assert tasks["port"] is None
    assert tasks["jax"] is not None
    tasks["jax"][0].join()       # no fit thread outlives the test


def test_predicted_iter_time_matches_samples(fitted_16):
    _, rm, trace = fitted_16
    srv = PSServer()
    h = srv.admit("a", rm, window=trace, k_samples=16, seed=0)
    c = h.predict_cutoff()
    samples = h.predicted_samples().numpy()
    assert samples.shape == (16, 16)
    want = float(np.sort(samples, axis=1)[:, c - 1].mean())
    np.testing.assert_allclose(h.predicted_iter_time(), want, rtol=1e-5)
    mean, _ = h.predicted_order_stats()
    np.testing.assert_allclose(mean, np.sort(samples, axis=1).mean(0),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# The copies: schedulers and PartitionedSim.
# ---------------------------------------------------------------------------


def _views(pkg, preds, prios):
    return [pkg.JobView(job_id=f"j{i}", priority=p, admit_order=i,
                        predicted_iter=(lambda t=t: t))
            for i, (t, p) in enumerate(zip(preds, prios))]


@pytest.mark.parametrize("policy", ["rr", "priority", "spsf"])
def test_scheduler_orders_match_jax(policy):
    rng = np.random.default_rng(0)
    js, ts = jsched.make_scheduler(policy), tsched.make_scheduler(policy)
    for tick in range(30):
        n = int(rng.integers(3, 7))
        preds = [None if rng.random() < 0.2 else float(rng.random())
                 for _ in range(n)]
        prios = rng.integers(0, 3, size=n).tolist()
        cap = [None, 1, 2, n][tick % 4]
        assert (ts.order(_views(tsched, preds, prios), cap)
                == js.order(_views(jsched, preds, prios), cap))
    with pytest.raises(ValueError):
        tsched.make_scheduler("fifo")


def test_partitioned_sim_rows_and_pruning_match_jax():
    ev = [(3, (4, 5), ()), (7, (), (4,))]
    mk = lambda pkg, **kw: pkg.PartitionedSim(
        pkg.paper_cluster_158(seed=0, n_workers=12),
        pkg.partition_ids(12, 3),
        events=[pkg.ChurnEvent(step=s, kill=k, restore=r)
                for s, k, r in ev], **kw)
    j, t = mk(jsim), mk(tsim)
    for a, b in zip(j.partitions, t.partitions):
        np.testing.assert_array_equal(a, b)
    jv, tv = j.views(), t.views()
    for step in range(12):
        for v in range(3):
            if v == 2 and step % 2:
                continue           # job 2 runs at half the rate
            np.testing.assert_array_equal(tv[v].active_ids,
                                          jv[v].active_ids)
            np.testing.assert_array_equal(tv[v].step(), jv[v].step())
        assert len(t._rows) == len(j._rows) and t._row0 == j._row0
    # a view opened after pruning, and a pinned view past max_cache, fail
    with pytest.raises(IndexError):
        t.view(0).step()
    p = mk(tsim, max_cache=4)
    va, vb, _ = p.views()
    for _ in range(10):
        va.step()
    assert len(p._rows) <= 4
    with pytest.raises(IndexError):
        vb.step()
    with pytest.raises(ValueError, match="overlap"):
        tsim.PartitionedSim(tsim.paper_cluster_158(0, 8),
                            [np.arange(4), np.arange(3, 8)])
