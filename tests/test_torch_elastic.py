"""The port's elastic membership against the JAX package on the CPU.

``ChurnSim`` / ``resize_schedule`` give the reference's widths, active
ids and rows on the same bases.  The refit task (``_spawn_refit`` /
``_poll_refit_task``) keeps the reference's cases.  ``ElasticController``
on both backends, driven through a seeded 8 -> 6 -> 8 churn with
synchronous refits beside the reference's, makes IDENTICAL cutoffs and
modes step for step, its window within 2e-3, and asks for its refits
with identical ``(rows, n, seed)``; across a refit both sides decide with
the JAX-fitted model (carried by ``weights.runtime_model_from_jax``: the
fit's own parity is ``test_torch_runtime_model.py::
test_fit_loss_trajectory_matches_jax``).  The port's ``Trainer`` under the
elastic controller follows the JAX ``Trainer`` (equal widths and c,
losses within 1e-5), and a mid-churn checkpoint restarts warm, by global
worker id.
"""
import contextlib
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.cluster import simulator as jsim
from repro.configs.base import bench_tiny_config as jtiny
from repro.core import controller as jctl
from repro.core.runtime_model.api import RuntimeModel as JRM
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.launch.train import Trainer as JTrainer
from repro.launch.train import jit_train_step
from repro.models import model as JM
from repro_torch import optim as toptim
from repro_torch import weights
from repro_torch.checkpoint import store
from repro_torch.cluster import simulator as tsim
from repro_torch.configs.base import bench_tiny_config as ttiny
from repro_torch.core import controller as tctl
from repro_torch.core.runtime_model.api import RuntimeModel as TRM
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as TT
from repro_torch.models import model as TM

torch.set_num_threads(2)

LAG = 10
WINDOW_TOL = 2e-3        # rtol = atol, tests/test_controller_device.py


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _port(rm):
    return weights.runtime_model_from_jax(_np_tree(rm.params), rm.norm_scale,
                                          lag=rm.lag, device="cpu")


@pytest.fixture(scope="module")
def fitted8():
    trace = jsim.paper_cluster_158(0, n_workers=8).run(120)
    rm = JRM(n_workers=8, lag=LAG).init(0)
    rm.fit(trace, steps=60, batch=8, seed=0)
    return rm, _port(rm), trace


# ---------------------------------------------------------------------------
# ChurnSim / resize_schedule.
# ---------------------------------------------------------------------------

PLANS = {
    "kill_restore": [(3, (2, 5), ()), (6, (), (2,))],
    "tail_8_6_8": [(4, (6, 7), ()), (9, (), (6, 7))],
    "same_step": [(0, (1,), ()), (5, (3, 4), (1,))],
}


def _events(pkg, plan):
    return [pkg.ChurnEvent(step=s, kill=k, restore=r) for s, k, r in plan]


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_churnsim_matches_jax(plan, seed):
    """Widths, active ids and rows equal to JAX's every step; survivors
    column-exact against the full-width run."""
    full = tsim.ClusterSim(n_workers=8, n_nodes=2, seed=seed).run(12)
    j = jsim.ChurnSim(jsim.ClusterSim(n_workers=8, n_nodes=2, seed=seed),
                      _events(jsim, PLANS[plan]))
    t = tsim.ChurnSim(tsim.ClusterSim(n_workers=8, n_nodes=2, seed=seed),
                      _events(tsim, PLANS[plan]))
    widths = set()
    for i in range(12):
        assert t.n_workers == j.n_workers and t.t == j.t == i
        ids = t.active_ids
        np.testing.assert_array_equal(ids, j.active_ids)
        row = t.step()
        np.testing.assert_array_equal(row, j.step())
        np.testing.assert_array_equal(row, full[i][ids])
        widths.add(row.shape[0])
    assert len(widths) > 1


@pytest.mark.parametrize("plan", [[(2, 5), (4, 8)], [(0, 3), (3, 7), (5, 1)]])
def test_resize_schedule_matches_jax(plan):
    j = jsim.resize_schedule(jsim.ClusterSim(n_workers=8, n_nodes=2, seed=1),
                             plan)
    t = tsim.resize_schedule(tsim.ClusterSim(n_workers=8, n_nodes=2, seed=1),
                             plan)
    jr, tr = j.run(7), t.run(7)
    assert [len(r) for r in tr] == [len(r) for r in jr]
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.active_ids, j.active_ids)


@pytest.mark.parametrize("target", [0, 9])
@pytest.mark.parametrize("step", [0, 2])
def test_resize_schedule_out_of_range_raises(target, step):
    """Both packages refuse a width outside [1, n], when the event fires."""
    for pkg in (jsim, tsim):
        with pytest.raises(ValueError, match="outside"):
            churn = pkg.resize_schedule(
                pkg.ClusterSim(n_workers=8, n_nodes=2, seed=0),
                [(step, target)])
            churn.run(3)


# ---------------------------------------------------------------------------
# The refit task.
# ---------------------------------------------------------------------------


def _finished_thread():
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    return t


def test_spawn_refit_captures_exception():
    """A fit that raises is captured and surfaced from the poll; the same
    failure at a stale generation is discarded like a result."""
    task = tctl._spawn_refit(lambda: 1 / 0, 3)
    task[0].join(timeout=10)
    assert not task[0].is_alive()
    done, model, err = tctl._poll_refit_task(task, 3, 8)
    assert done and model is None
    assert isinstance(err, ZeroDivisionError)
    assert tctl._poll_refit_task(task, 4, 8) == (True, None, None)


def test_poll_refit_task_running_current_stale_and_wrong_width():
    gate = threading.Event()
    model = types.SimpleNamespace(n_workers=6)

    def fit():
        assert gate.wait(timeout=10)
        return model

    task = tctl._spawn_refit(fit, 2)
    assert tctl._poll_refit_task(task, 2, 6) == (False, None, None)
    gate.set()
    task[0].join(timeout=10)
    assert not task[0].is_alive()
    assert tctl._poll_refit_task(task, 2, 6) == (True, model, None)
    assert tctl._poll_refit_task(task, 1, 6) == (True, None, None)  # stale
    assert tctl._poll_refit_task(task, 2, 8) == (True, None, None)  # width
    # the reference's poll gives the same answers on the same box
    jtask = (_finished_thread(), {"model": model}, 2)
    for gen, width in ((2, 6), (1, 6), (2, 8)):
        assert (jctl._poll_refit_task(jtask, gen, width)
                == tctl._poll_refit_task(jtask, gen, width))


# ---------------------------------------------------------------------------
# ElasticController against the reference's, over a seeded 8 -> 6 -> 8
# churn with synchronous refits.
# ---------------------------------------------------------------------------

SHRINK, RECOVER, STEPS = 8, 16, 24


def _churn(pkg, seed=7):
    return pkg.ChurnSim(pkg.paper_cluster_158(seed, n_workers=8),
                        [pkg.ChurnEvent(step=SHRINK, kill=(6, 7)),
                         pkg.ChurnEvent(step=RECOVER, restore=(6, 7))])


def _follow(ctls, members, ids):
    """Resize every controller onto the timer's worker set, survivors by
    global id (the Trainer's ``_sync_membership``)."""
    if np.array_equal(ids, members):
        return members
    old = {wid: col for col, wid in enumerate(members)}
    col_map = np.array([old.get(wid, -1) for wid in ids], int)
    for c in ctls:
        c.resize(len(ids), col_map=col_map, members=ids)
    return ids


@pytest.mark.parametrize("backend", ["device", "numpy"])
def test_elastic_controller_matches_jax_over_8_6_8_churn(fitted8, backend,
                                                          monkeypatch):
    rm, tm, trace = fitted8
    kw = dict(k_samples=16, seed=0, backend=backend, refit_steps=20,
              refit_fresh=3, fallback_warmup=2)
    jc = jctl.ElasticController(rm, **kw)
    tc = tctl.ElasticController(tm, **kw)
    jc.seed_window(trace[-40:])
    tc.seed_window(trace[-40:])
    jcalls, tcalls, fits = [], [], []
    jfit = jc._fit_model

    def jspy(rows, n, seed):
        jcalls.append((rows, n, seed))
        fits.append(jfit(rows, n, seed))
        return fits[-1]

    def tspy(rows, n, seed):
        tcalls.append((rows, n, seed))
        return _port(fits[len(tcalls) - 1])   # the JAX side's fit

    monkeypatch.setattr(jc, "_fit_model", jspy)
    monkeypatch.setattr(tc, "_fit_model", tspy)
    jt, tt = _churn(jsim), _churn(tsim)
    members = np.arange(8)
    seen, censored = [], 0
    for step in range(STEPS):
        ids = tt.active_ids
        np.testing.assert_array_equal(ids, jt.active_ids)
        members = _follow((jc, tc), members, ids)
        cj, ct = jc.predict_cutoff(), tc.predict_cutoff()
        assert (ct, tc.mode, tc.n) == (cj, jc.mode, jc.n), step
        seen.append((tc.n, tc.mode, ct))
        times = tt.step()
        np.testing.assert_array_equal(times, jt.step())
        mask = np.zeros(len(times), bool)
        mask[np.argsort(times)[:ct]] = True
        censored += int(not mask.all())
        jc.observe(times, mask)
        tc.observe(times, mask)
        np.testing.assert_allclose(tc.window_array(), jc.window_array(),
                                   rtol=WINDOW_TOL, atol=WINDOW_TOL,
                                   err_msg=f"step {step}")
    assert len(tcalls) == len(jcalls) == 2
    for (a, n_a, s_a), (b, n_b, s_b) in zip(tcalls, jcalls):
        np.testing.assert_array_equal(a, b)
        assert (n_a, s_a) == (n_b, s_b)
    assert [c[1] for c in tcalls] == [6, 8]
    # widths 8 -> 6 -> 8, each resize decided by the fallback, then the
    # refitted DMM again
    runs = [(n, mode) for i, (n, mode, _) in enumerate(seen)
            if i == 0 or seen[i - 1][:2] != (n, mode)]
    assert runs == [(8, "dmm"), (6, "fallback"), (6, "dmm"),
                    (8, "fallback"), (8, "dmm")]
    assert censored > 0 and tc.fallback_steps == jc.fallback_steps


def test_elastic_resize_rejects_wrong_width_model(fitted8):
    _, tm, trace = fitted8
    ctl = tctl.ElasticController(tm, k_samples=16, seed=0)
    ctl.seed_window(trace[-40:])
    with pytest.raises(ValueError, match="width"):
        ctl.resize(6, model=tm)            # tm is still width 8


def _model6(tm, seed=0):
    model = TRM(n_workers=6, lag=tm.lag, z_dim=tm.z_dim, hidden=tm.hidden,
                device="cpu").init(seed)
    model.norm_scale = tm.norm_scale
    return model


def test_elastic_async_refit_dropped_by_generation(fitted8):
    """A resize abandons an in-flight async refit without joining it; its
    late result is discarded by generation, never installed."""
    _, tm, trace = fitted8
    ctl = tctl.ElasticController(tm, k_samples=16, seed=0, refit_async=True)
    ctl.seed_window(trace[-40:])
    ctl.resize(6)
    assert ctl.mode == "fallback" and ctl._refit_job is None
    model6 = _model6(tm)
    ctl._refit_job = (_finished_thread(), {"model": model6},
                      ctl._resize_count - 1)
    ctl._poll_refit()
    assert ctl.mode == "fallback"
    ctl._refit_job = (_finished_thread(), {"model": model6},
                      ctl._resize_count)
    ctl._poll_refit()
    assert ctl.mode == "dmm" and ctl._dmm.n == 6


def test_elastic_refit_failure_retries_then_raises(fitted8, monkeypatch):
    """First failure: logged, one retry with doubled backoff; the second
    past the budget raises RefitError from the poll."""
    _, tm, trace = fitted8
    ctl = tctl.ElasticController(tm, k_samples=16, seed=0, refit_async=True,
                                 refit_fresh=2, refit_retries=1)
    ctl.seed_window(trace[-40:])
    ctl.resize(6)

    def boom(rows, n, seed):
        raise RuntimeError("ELBO diverged")

    monkeypatch.setattr(ctl, "_fit_model", boom)
    for _ in range(2):
        ctl.observe(np.ones(6))
    assert ctl._refit_job is not None      # spawned at refit_fresh
    ctl._refit_job[0].join(timeout=10)
    ctl.predict_cutoff()                   # failure #1: retry, no raise
    assert ctl.mode == "fallback"
    assert ctl._refit_failures == 1 and ctl._fresh == 0
    for _ in range(2):
        ctl.observe(np.ones(6))
    assert ctl._refit_job is None          # backoff: 2 are not enough
    for _ in range(2):
        ctl.observe(np.ones(6))
    assert ctl._refit_job is not None      # retry at 2x refit_fresh
    ctl._refit_job[0].join(timeout=10)
    with pytest.raises(tctl.RefitError, match="retry budget"):
        ctl.predict_cutoff()


def test_elastic_stale_refit_failure_burns_no_budget(fitted8):
    _, tm, trace = fitted8
    ctl = tctl.ElasticController(tm, k_samples=16, seed=0, refit_async=True,
                                 refit_retries=0)
    ctl.seed_window(trace[-40:])
    ctl.resize(6)
    ctl._refit_job = (_finished_thread(), {"error": RuntimeError("boom")},
                      ctl._resize_count - 1)
    ctl._poll_refit()                      # would raise if not stale
    assert ctl._refit_failures == 0 and ctl.mode == "fallback"


def test_async_refit_fits_on_a_thread_and_installs(fitted8):
    """A real async refit on the CPU: seeded like the synchronous one, on
    the controller's model device, installed by the poll."""
    _, tm, trace = fitted8
    ctl = tctl.ElasticController(tm, k_samples=16, seed=3, refit_async=True,
                                 refit_fresh=2, refit_steps=5)
    ctl.seed_window(trace[-40:])
    ctl.resize(6)
    calls = []
    fit = ctl._fit_model

    def spy(rows, n, seed):
        calls.append((n, seed, threading.current_thread().name))
        return fit(rows, n, seed)

    ctl._fit_model = spy
    sim = tsim.paper_cluster_158(1, n_workers=6)
    for _ in range(2):
        ctl.predict_cutoff()
        ctl.observe(sim.step())
    thread = ctl._refit_job[0]
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert ctl.predict_cutoff() >= 1 and ctl.mode == "dmm"
    assert calls == [(6, 3 + 1, thread.name)]    # seed + resize_count
    assert calls[0][2] != threading.main_thread().name
    assert ctl._dmm.model.device.type == "cpu"
    assert ctl._dmm.seed == 3 + 101               # seed + 101 * resizes


def test_fit_model_stays_on_the_models_device(fitted8):
    """The refit model's device is the given model's, never a default
    (which would mean the card)."""
    _, tm, trace = fitted8
    ctl = tctl.ElasticController(tm, k_samples=16, seed=0, refit_steps=2)
    model = ctl._fit_model(trace[-30:, :6], 6, 0)
    assert model.device == tm.device == torch.device("cpu")
    assert model.n_workers == 6 and model.lag == tm.lag
    assert all(p.device.type == "cpu" for p in
               torch.utils._pytree.tree_leaves(model.params))


def test_resize_waits_for_the_dropped_dmm(fitted8):
    """A DMM controller is dropped only after its decision in flight: the
    resize and an install both wait on the controller being replaced."""
    _, tm, trace = fitted8
    ctl = tctl.ElasticController(tm, k_samples=16, seed=0)
    ctl.seed_window(trace[-40:])
    ctl.predict_cutoff()
    ctl.observe(trace[-1])          # a decision dispatched for the next step
    waited = []
    first = ctl._dmm
    first._wait = lambda: waited.append("resize")
    ctl.resize(6, model=_model6(tm))
    assert waited == ["resize"] and ctl.mode == "dmm"
    ctl._dmm._wait = lambda: waited.append("install")
    ctl._install_dmm(_model6(tm, 1))
    assert waited == ["resize", "install"]


def test_capture_is_thread_local(fitted8, monkeypatch):
    """The decision graphs are captured in thread-local mode, so a refit
    fitting on another thread cannot invalidate them."""
    _, tm, _ = fitted8
    seen = {}

    @contextlib.contextmanager
    def graph(g, stream=None, capture_error_mode="global", **kw):
        seen.update(stream=stream, mode=capture_error_mode)
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: "graph")
    monkeypatch.setattr(torch.cuda, "graph", graph)
    ctl = tctl.CutoffController(tm, k_samples=8)
    ctl._ensure_ring()
    ran = []
    assert ctl._capture(ran.append) == "graph"
    assert seen == {"stream": ctl._stream, "mode": "thread_local"}
    assert len(ran) == 2 and ran[1] is ctl._st   # warm-up copy, then real


# ---------------------------------------------------------------------------
# The Trainer under churn.
# ---------------------------------------------------------------------------


def _elastic(pkg, rm, trace, refit_steps=60):
    ctl = pkg.ElasticController(rm, k_samples=32, seed=0,
                                refit_steps=refit_steps, refit_fresh=3,
                                fallback_warmup=2)
    ctl.seed_window(trace[-60:])
    return ctl


def test_elastic_trainer_matches_the_jax_trainer(fitted8, monkeypatch):
    """The tiny config, weights path, 8 -> 6 -> 8 over 12 steps with
    synchronous refits, the port deciding with the JAX-fitted models: the
    same widths, cutoffs and clock every step, losses within 1e-5."""
    rm, tm, trace = fitted8
    jc, tc = jtiny(), ttiny()
    jctl_ = _elastic(jctl, rm, trace, refit_steps=20)
    tctl_ = _elastic(tctl, tm, trace, refit_steps=20)
    fits = []
    jfit = jctl_._fit_model
    monkeypatch.setattr(jctl_, "_fit_model",
                        lambda *a: fits.append(jfit(*a)) or fits[-1])
    monkeypatch.setattr(tctl_, "_fit_model", lambda *a: _port(fits.pop(0)))

    def churn(pkg):
        return pkg.ChurnSim(pkg.paper_cluster_158(9, n_workers=8),
                            [pkg.ChurnEvent(step=3, kill=(6, 7)),
                             pkg.ChurnEvent(step=8, restore=(6, 7))])

    jopt = joptim.adamw(3e-3)
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    jinit = {"params": params, "opt": jopt.init(params)}
    jt = JTrainer(cfg=jc, step_fn=jit_train_step(jc, jopt),
                  data=JTokens(jc.vocab_size, 8, 24, seed=0),
                  controller=jctl_, timer=churn(jsim), n_workers=8)
    jt.restore_or_init(lambda: jax.tree.map(jnp.copy, jinit))
    topt = toptim.adamw(3e-3, fused=True)
    tt = TT.Trainer(step_fn=TT.make_train_step(tc, topt),
                    data=SyntheticTokens(tc.vocab_size, 8, 24, seed=0),
                    controller=tctl_, timer=churn(tsim), n_workers=8)
    tt.restore_or_init(lambda: weights.state_from_jax(tc, _np_tree(jinit),
                                                      device="cpu"))
    jh, th = jt.run(12), tt.run(12)
    assert [(h["n"], h["c"], h["clock"]) for h in th] \
        == [(h["n"], h["c"], h["clock"]) for h in jh]
    widths = [h["n"] for h in th]
    assert widths[0] == 8 and 6 in widths and widths[-1] == 8
    assert min(h["c"] for h in th) < 6 and not fits
    assert tctl_.mode == jctl_.mode == "dmm"
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=1e-5)


def _tiny_trainer(ctl, timer, *, ckpt=None, ckpt_every=50):
    tc = ttiny()
    opt = toptim.adamw(3e-3, fused=True)

    def init():
        params = TM.init_model(tc, torch.Generator().manual_seed(0),
                               device="cpu")
        return {"params": params, "opt": opt.init(params)}

    return TT.Trainer(step_fn=TT.make_train_step(tc, opt),
                      data=SyntheticTokens(tc.vocab_size, 8, 24, seed=0),
                      controller=ctl, timer=timer, n_workers=8,
                      ckpt_dir=ckpt, ckpt_every=ckpt_every
                      ).restore_or_init(init)


def test_mid_churn_checkpoint_restart_resumes_warm(fitted8, tmp_path):
    _, tm, trace = fitted8
    d = str(tmp_path / "ck")

    def timer():
        return tsim.ChurnSim(tsim.paper_cluster_158(11, n_workers=8),
                             [tsim.ChurnEvent(step=8, kill=(6, 7)),
                              tsim.ChurnEvent(step=16, restore=(6, 7))])

    tr = _tiny_trainer(_elastic(tctl, tm, trace), timer(), ckpt=d,
                       ckpt_every=12)
    tr.run(14)                                  # ckpt at step 12: width 6
    saved = store.restore_group(d, "ctl")
    assert int(saved["n"]) == 6 and int(saved["step"]) == 12
    assert saved["members"].tolist() == [0, 1, 2, 3, 4, 5]
    assert saved["window"].shape == (LAG + 1, 6)

    # crash + restart: a fresh trainer at the original width adopts the
    # checkpoint's degraded membership and a WARM controller window
    ctl2 = _elastic(tctl, tm, trace)
    timer2 = timer()
    for _ in range(12):
        timer2.step()
    tr2 = _tiny_trainer(ctl2, timer2, ckpt=d, ckpt_every=12)
    assert tr2.step == 12 and tr2.n_workers == 6 and ctl2.n == 6
    assert ctl2.mode == "fallback"
    np.testing.assert_allclose(ctl2.window_array(), saved["window"],
                               rtol=1e-7, atol=1e-9)
    tr2.ckpt_dir = None
    tr2.run(3)                                  # and it keeps stepping
    assert tr2.step == 15 and [h["n"] for h in tr2.history] == [6, 6, 6]


def test_restore_remaps_by_saved_membership_not_prefix(fitted8, tmp_path):
    """Workers 2 and 3 die: the restore maps survivors by GLOBAL id, so new
    column 2 is old worker 4's series, not old worker 2's."""
    _, tm, trace = fitted8
    d = str(tmp_path / "ck")
    timer = tsim.ChurnSim(tsim.paper_cluster_158(13, n_workers=8),
                          [tsim.ChurnEvent(step=5, kill=(2, 3))])
    tr = _tiny_trainer(_elastic(tctl, tm, trace), timer, ckpt=d,
                       ckpt_every=8)
    tr.run(10)                    # ckpt at step 8: width 6, non-prefix set
    saved = store.restore_group(d, "ctl")
    assert saved["members"].tolist() == [0, 1, 4, 5, 6, 7]

    # the restart controller carries a marker trace: column j holds j
    ctl2 = tctl.ElasticController(tm, k_samples=32, seed=0, refit_steps=60,
                                  refit_fresh=3, fallback_warmup=2)
    ctl2.seed_window(np.tile(np.arange(8.0), (LAG + 15, 1)))
    timer2 = tsim.ChurnSim(tsim.paper_cluster_158(13, n_workers=8),
                           [tsim.ChurnEvent(step=0, kill=(2, 3))])
    tr2 = _tiny_trainer(ctl2, timer2, ckpt=d, ckpt_every=8)
    assert tr2.n_workers == 6
    assert tr2.members.tolist() == [0, 1, 4, 5, 6, 7]
    np.testing.assert_allclose(ctl2._trace[0], [0, 1, 4, 5, 6, 7])
    np.testing.assert_allclose(ctl2.window_array(), saved["window"],
                               rtol=1e-7, atol=1e-9)
