"""The port's telemetry (``repro_torch.obs``) against the JAX package's
``repro.obs``, and attached to the port's entry points.

Against the reference, on the same inputs: the ring and histogram drain
payloads (equal), ``score_decision`` records (equal), ``chrome_trace``
documents (equal), the JSONL streams read both ways (the same calibration
report and render), and the decision records of a wrapped port
``CutoffController`` against a wrapped reference one over 30
``paper_cluster_158`` decisions drained every 7 (cutoffs, oracle, regret,
idle and discard equal; ``pred_iter`` and ``residual`` within the
device controller's window bar, rtol = atol = 2e-3).  A wrapper that keeps
the reference's lazy sample handle fails that test: the port's
controllers write their samples in place.

Port only: the Trainer (the reference test's 50-step run) and a J = 3
``PSServer`` (25 ticks) give identical losses and cutoffs with obs on and
off; the streams keep monotone ``seq`` and the obs kinds, a torn tail
still renders, the CLI renders a run and refuses an empty directory; and
``import repro_torch.obs`` works in a fresh interpreter in either order
with the control plane.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.cluster.simulator import paper_cluster_158
from repro.core import controller as jctl
from repro.core.cutoff import order_stats
from repro.core.runtime_model.api import RuntimeModel as JRM
from repro.obs import ObsRun as JObsRun
from repro.obs import metrics as jmetrics
from repro.obs import quality as jquality
from repro.obs import report as jreport
from repro.obs import trace as jtrace
from repro_torch import optim, weights
from repro_torch.cluster.simulator import ClusterSim
from repro_torch.configs.base import bench_tiny_config
from repro_torch.controlplane.events import read_events
from repro_torch.core import controller as tctl
from repro_torch.core.runtime_model.api import RuntimeModel as TRM
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.train import Trainer, make_train_step
from repro_torch.models import model as M
from repro_torch.obs import ObsRun
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import quality as tquality
from repro_torch.obs import report as treport
from repro_torch.obs import trace as ttrace
from repro_torch.obs.__main__ import main as cli
from repro_torch.ps import PSServer

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")

# pred_iter / residual of the port's device controller against the
# reference's: its samples come from a window held to rtol = atol = 2e-3
# (tests/test_torch_controller.py)
PRED_TOL = 2e-3


# ---------------------------------------------------------------------------
# Collectors against the reference.
# ---------------------------------------------------------------------------


def _ring_pushes(case):
    """(cap, pushes) of one drain case; a push is a list of floats."""
    if case == "oldest_first":
        return 8, [[float(i), float(10 * i)] for i in range(5)]
    if case == "overflow":
        return 4, [[float(i), 0.5 * i] for i in range(11)]
    return 3, [[1.0 / 3.0, 2.0 ** 30 + 1.0]]       # f32 rounding on push


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("case", ["oldest_first", "overflow", "rounding"])
def test_ring_drain_payloads_equal_jax(case, as_tensor):
    """The same pushes through both rings, drained twice, then once more
    after one push: payloads equal, exactly.  ``as_tensor`` pushes the
    first column as a tensor (the device half of the port's ring), the
    second as a float (its host half)."""
    cap, pushes = _ring_pushes(case)
    rings = [jmetrics.MetricsRegistry().ring("r", ("x", "y"), cap=cap),
             tmetrics.MetricsRegistry().ring("r", ("x", "y"), cap=cap)]
    for row in pushes:
        rings[0].push(tuple(row))
        rings[1].push((torch.tensor(row[0], dtype=torch.float64)
                       if as_tensor else row[0], row[1]))
    for _ in range(2):
        a, b = (r.drain() for r in rings)
        assert a == b
    rings[0].push((99.0, -1.0))
    rings[1].push((torch.tensor(99.0) if as_tensor else 99.0, -1.0))
    assert rings[0].drain() == rings[1].drain()


def test_ring_rejects_arity_and_column_drift_as_jax():
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        ring = reg.ring("r", ("a", "b"))
        with pytest.raises(ValueError, match="wants 2 values"):
            ring.push((1.0,))
        with pytest.raises(ValueError, match="re-registered"):
            reg.ring("r", ("a", "c"))
        with pytest.raises(ValueError, match="cap must be"):
            reg.ring("s", ("a",), cap=0)


def test_histogram_and_summary_equal_jax():
    """Values on an edge, between edges and outside them, as floats and
    (port) tensors: the drained counts are the reference's
    ``jnp.searchsorted`` (left) counts; the summaries agree."""
    edges = (0.5, 1.0, 2.0)
    values = [0.5, 1.0, 2.0, 0.49, 0.75, 1.5, 3.0, -7.0, 2.0000002]
    regs = [jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()]
    hj, ht = (r.histogram("h", edges) for r in regs)
    for i, v in enumerate(values):
        hj.add(v)
        ht.add(torch.tensor(v) if i % 2 else v)
    for r in regs:
        r.ring("z", ("v",), cap=2).push((1.0,))
        r.counter("k").inc(3)
    a, b = (r.drain() for r in regs)
    assert a == b
    assert [r.drain() for r in regs] == [[], []]
    assert regs[0].summary() == regs[1].summary()


# ---------------------------------------------------------------------------
# Scoring, spans, streams against the reference.
# ---------------------------------------------------------------------------


def _entries(pkg):
    """Buffered decision entries, one of each kind: sampled, anytime
    (the package's own contribution), sample-less, full sync."""
    rng = np.random.default_rng(0)
    times = rng.gamma(4.0, 0.25, size=(4, 12))
    samples = rng.gamma(4.0, 0.25, size=(16, 12)).astype(np.float32)
    anytime = pkg.AnytimeController(pkg.FullSyncController(12), n_micro=4)
    out = []
    for k, (c, samp, fn) in enumerate([(7, samples, None),
                                       (9, samples, anytime.contribution),
                                       (5, None, None), (12, None, None)]):
        t = times[k]
        out.append({"policy": f"p{k}", "step": k + 1, "c": c, "times": t,
                    "mask": t <= order_stats.iter_time(t, c),
                    "samples": samp, "contrib_fn": fn})
    return out


def test_score_decision_records_equal_jax():
    want = [jquality.score_decision(e) for e in _entries(jctl)]
    got = [tquality.score_decision(e) for e in _entries(tctl)]
    assert got == want
    assert want[1]["discard_frac"] < want[0]["discard_frac"]   # fractions
    assert want[2]["pred_iter"] is None and want[3]["discard_frac"] == 0.0


def test_span_nesting_and_chrome_trace_equal_jax():
    tracer = ttrace.Tracer()
    with tracer.span("outer", track="t", tick=3):
        with tracer.span("inner", track="t", step=9):
            pass
        with tracer.span("side", track="u"):
            pass
    inner, side, outer = tracer.spans        # completion order
    assert (outer["depth"], inner["depth"], side["depth"]) == (1, 2, 2)
    assert outer["attrs"] == {"tick": 3} and inner["attrs"] == {"step": 9}
    assert outer["dur_us"] >= inner["dur_us"]
    assert ttrace.chrome_trace(tracer.spans) == jtrace.chrome_trace(
        tracer.spans)
    assert ttrace.OBS_KINDS == jtrace.OBS_KINDS


def _write_streams(pkg_obs, d):
    """One run's worth of every stream through ``pkg_obs.ObsRun``."""
    obs = pkg_obs(str(d))
    with obs.trace.span("trainer.step", track="trainer", step=1):
        pass
    for i in range(3):
        obs.steps.on_step({"step": i + 1, "clock": 0.5 * (i + 1), "c": 6,
                           "n": 8, "iter_time": 0.5, "loss": 2.0 - i / 10},
                          job="j")
    for e in _entries(jctl)[::2]:
        e.pop("contrib_fn")
        obs.decisions.record(e)
    obs.metrics.ring("trainer", ("loss",), cap=2).push((1.5,))
    obs.metrics.histogram("h", (1.0,)).add(0.5)
    obs.close()
    return str(d)


def test_streams_read_both_ways(tmp_path):
    """The port's reader and report on the reference's streams, and the
    reference's on the port's: the same calibration report and render."""
    dirs = [_write_streams(JObsRun, tmp_path / "jax"),
            _write_streams(ObsRun, tmp_path / "port")]
    cals = []
    for d in dirs:
        runs = [treport.load_run(d), jreport.load_run(d)]
        cal = [treport.calibration_report(runs[0]["decisions"]),
               jreport.calibration_report(runs[1]["decisions"])]
        assert cal[0] == cal[1]
        assert treport.render(runs[0]) == jreport.render(runs[1])
        assert treport.timeline_summary(runs[0]["spans"]) == \
            jreport.timeline_summary(runs[1]["spans"])
        cals.append(cal[0])
    assert cals[0] == cals[1] and cals[0]["p0"]["scored"] == 1


# ---------------------------------------------------------------------------
# Decision records: the port's controller against the reference's.
# ---------------------------------------------------------------------------


class _LazyQuality(tquality.QualityController):
    """The reference's wrapper taken literally: it keeps the lazy handle
    ``predicted_samples()`` and reads it only at the drain."""

    def predict_cutoff(self) -> int:
        c = self.inner.predict_cutoff()
        self._decisions += 1
        self._pending = {"step": self._decisions, "c": int(c),
                         "samples": self.inner.predicted_samples()}
        return c


def _decisions(obs, wrapped, steps=30, every=7):
    sim = paper_cluster_158(seed=3)
    for s in range(steps):
        c = wrapped.predict_cutoff()
        t = sim.step()
        wrapped.observe(t, t <= order_stats.iter_time(t, c) + 1e-12)
        if (s + 1) % every == 0:
            obs.drain()
    obs.drain()
    return obs.decisions.records


@pytest.fixture(scope="module")
def decisions_158():
    """Unfitted 158-wide DMMs (the reference's obs tests scale an init),
    the reference's and its numpy copy, each wrapped and driven over 30
    decisions."""
    n, lag = 158, 10
    trace = paper_cluster_158(seed=0).run(40)
    jrm = JRM(n_workers=n, lag=lag).init(0)
    jrm.norm_scale = float(2.0 * trace[:lag + 1].mean())
    trm = weights.runtime_model_from_jax(
        jax.tree.map(np.asarray, jrm.params), jrm.norm_scale, lag=lag,
        device="cpu")

    def port(wrapper):
        ctl = tctl.CutoffController(trm, k_samples=16, seed=0)
        ctl.seed_window(trace)
        obs = ObsRun()
        return _decisions(obs, wrapper(ctl, obs.decisions, "dmm"))

    jc = jctl.CutoffController(jrm, k_samples=16, seed=0)
    jc.seed_window(trace)
    jobs = JObsRun()
    want = _decisions(jobs, jobs.wrap(jc, policy="dmm"))
    return want, port(tquality.QualityController), port(_LazyQuality)


def _records_match(want, got):
    assert len(got) == len(want) == 30
    for r, q in zip(want, got):
        for k in ("policy", "step", "n", "c", "iter_time", "oracle_c",
                  "regret", "idle_frac", "discard_frac"):
            assert q[k] == r[k], (r["step"], k)
        for k in ("pred_iter", "residual"):
            np.testing.assert_allclose(q[k], r[k], rtol=PRED_TOL,
                                       atol=PRED_TOL, err_msg=k)


def test_decision_records_match_the_reference_controller(decisions_158):
    want, got, _ = decisions_158
    _records_match(want, got)
    assert len({r["c"] for r in want}) > 1
    assert all(r["pred_iter"] is not None for r in got)


def test_a_wrapper_keeping_the_lazy_handle_fails_the_match(decisions_158):
    """Every decision but a drain window's last is scored with the wrong
    samples by a wrapper that reads the controller's in-place tensor at
    the drain."""
    want, got, lazy = decisions_158
    with pytest.raises(AssertionError):
        _records_match(want, lazy)
    wrong = [q["step"] for q, g in zip(lazy, got)
             if q["pred_iter"] != g["pred_iter"]]
    assert len(wrong) >= 20


# ---------------------------------------------------------------------------
# Port only: bit-exactness on the entry points.
# ---------------------------------------------------------------------------

_STEP = {}


def _scale_model(n, trace):
    rm = TRM(n_workers=n, lag=10, device="cpu").init(0)
    rm.norm_scale = float(2.0 * trace[:21].mean())
    return rm


def _run_trainer(obs, steps=50, n=8, **kw):
    """The reference test's seeded run: tiny config, a DMM controller
    (k 16) seeded with 60 rows, ClusterSim(8, 2 nodes, seed 5), drains
    every 7 steps; ``kw`` goes to the Trainer."""
    cfg = bench_tiny_config()
    opt = optim.adamw(3e-3)
    if "fn" not in _STEP:
        _STEP["fn"] = make_train_step(cfg, opt)
    trace = paper_cluster_158(seed=0, n_workers=n).run(60)
    ctl = tctl.CutoffController(_scale_model(n, trace), k_samples=16, seed=0)
    ctl.seed_window(trace)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=8,
                           global_batch=n * 3, seed=0)
    tr = Trainer(step_fn=_STEP["fn"], data=data,
                 controller=obs.wrap(ctl, policy="dmm") if obs else ctl,
                 timer=ClusterSim(n_workers=n, n_nodes=2, seed=5),
                 n_workers=n, metrics_every=7, obs=obs, name="dmm", **kw)

    def init_fn():
        params = M.init_model(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        return {"params": params, "opt": opt.init(params)}

    tr.restore_or_init(init_fn)
    tr.run(steps)
    return tr


def test_trainer_bit_exact_with_obs_attached():
    bare = _run_trainer(None)
    obs = ObsRun()
    inst = _run_trainer(obs)
    assert [h["c"] for h in inst.history] == [h["c"] for h in bare.history]
    assert ([h["loss"] for h in inst.history]
            == [h["loss"] for h in bare.history])
    assert len(obs.steps) == len(bare.history) == 50
    recs = obs.decisions.records
    assert len(recs) == 50 and all(r["cov50"] is not None for r in recs)
    assert [r["c"] for r in recs] == [h["c"] for h in bare.history]
    names = {s["name"] for s in obs.trace.spans}
    assert {"trainer.step", "controller.predict_cutoff", "train.dispatch",
            "controller.observe", "obs.drain"} <= names
    ring = obs.metrics.ring("trainer[dmm]",
                            ("loss", "gnorm", "c", "iter_time"))
    assert ring.pushed == 50


def test_checkpoint_restores_through_the_wrapper(tmp_path):
    """A wrapped controller's step and window go into the checkpoint's
    ``ctl`` group and come back into a fresh wrapped controller."""
    first = _run_trainer(ObsRun(), steps=4, ckpt_dir=str(tmp_path),
                         ckpt_every=4)
    obs = ObsRun()
    again = _run_trainer(obs, steps=0, ckpt_dir=str(tmp_path))
    assert again.step == 4 and again.controller._step == 4
    np.testing.assert_array_equal(again.controller.window_array(),
                                  first.controller.window_array())
    again.run(1)
    assert [r["step"] for r in obs.decisions.records] == [1]
    assert obs.decisions.records[0]["pred_iter"] is not None


def test_psserver_refit_counters_and_span():
    """A job resized to the Elfving fallback refits synchronously: one
    ``ps.refit`` span and the started / installed counters."""
    trace = paper_cluster_158(seed=0, n_workers=8).run(60)
    obs = ObsRun()
    srv = PSServer(obs=obs, refit_steps=3, refit_fresh=2)
    h = srv.admit("a", _scale_model(8, trace), window=trace, k_samples=8)
    h.resize(6, col_map=np.arange(6))
    sim = paper_cluster_158(seed=5, n_workers=6)
    for _ in range(3):
        c = h.predict_cutoff()
        t = sim.step()
        h.observe(t, t <= order_stats.iter_time(t, c) + 1e-12)
    assert h.mode == "dmm"
    assert obs.metrics.summary()["counters"] == {"ps.refits_started": 1,
                                                 "ps.refits_installed": 1}
    assert [s["attrs"] for s in obs.trace.spans
            if s["name"] == "ps.refit"] == [{"job": "a", "width": 6}]


def _drive_ps(obs, J=3, steps=25, n=8):
    trace = paper_cluster_158(seed=0, n_workers=n).run(60)
    rm = _scale_model(n, trace)
    srv = PSServer(obs=obs)
    ctls = []
    for j in range(J):
        h = srv.admit(f"job{j}", rm,
                      window=paper_cluster_158(seed=30 + j,
                                               n_workers=n).run(40),
                      k_samples=16, seed=7 * j)
        ctls.append(obs.wrap(h, policy=f"job{j}") if obs else h)
    sims = [paper_cluster_158(seed=50 + j, n_workers=n) for j in range(J)]
    seqs = [[] for _ in range(J)]
    for _ in range(steps):
        for j in range(J):
            c = ctls[j].predict_cutoff()
            times = sims[j].step()
            it = order_stats.iter_time(times, c)
            ctls[j].observe(times, times <= it + 1e-12)
            seqs[j].append(int(c))
        srv.flush()
    if obs is not None:
        obs.drain()
    return seqs


def test_psserver_bit_exact_with_obs_attached():
    """J = 3 batched server: identical cutoff sequences with flush spans
    and per-job quality wrappers on and off (the three jobs' sequences
    are not required to differ: the reference's own test fails on that
    claim of its data, ROADMAP C)."""
    bare = _drive_ps(None)
    obs = ObsRun()
    inst = _drive_ps(obs)
    assert inst == bare
    by_name = {}
    for s in obs.trace.spans:
        by_name.setdefault(s["name"], []).append(s)
    assert len(by_name["ps.flush"]) == 25
    assert len(by_name["ps.dispatch"]) == 25
    depth = by_name["ps.flush"][0]["depth"]
    assert all(s["depth"] == depth + 1 for s in by_name["ps.dispatch"])
    assert all(s["attrs"] == {"jobs": 3, "n_pad": 8, "gather": False}
               for s in by_name["ps.dispatch"])
    recs = obs.decisions.records
    assert len(recs) == 3 * 25
    assert {r["policy"] for r in recs} == {"job0", "job1", "job2"}
    assert all(r["cov50"] is not None for r in recs)
    assert [r["c"] for r in recs if r["policy"] == "job1"] == bare[1]


# ---------------------------------------------------------------------------
# Streams, CLI, imports.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def recorded_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs") / "run"
    obs = ObsRun(str(d))
    _run_trainer(obs, steps=12)
    obs.close()
    return str(d)


def test_streams_monotone_seq_and_kinds(recorded_run):
    for stream in ("spans", "steps", "decisions", "metrics"):
        events = read_events(f"{recorded_run}/{stream}.jsonl")
        assert events, stream
        seqs = [e.seq for e in events]
        assert seqs == sorted(set(seqs)), stream
        assert all(e.kind in ttrace.OBS_KINDS for e in events), stream
    mets = read_events(f"{recorded_run}/metrics.jsonl")
    assert mets[0].kind == "run" and mets[0].data["phase"] == "start"
    assert mets[-1].kind == "run" and mets[-1].data["phase"] == "end"
    assert mets[-1].data["summary"]["rings"] == {
        "trainer[dmm]": {"pushed": 12, "cap": 256}}
    rows = [r for e in mets if e.kind == "metrics"
            for r in e.data["rows"]]
    steps = read_events(f"{recorded_run}/steps.jsonl")
    assert [r[0] for r in rows] == [
        float(np.float32(e.data["loss"])) for e in steps]


def test_torn_tail_still_renders(recorded_run, tmp_path):
    d = tmp_path / "torn"
    shutil.copytree(recorded_run, d)
    with open(d / "spans.jsonl", "a") as f:
        f.write('{"seq": 999999, "tick": 999, "kind": "sp')   # torn write
    run = treport.load_run(str(d))
    whole = treport.load_run(recorded_run)
    assert len(run["spans"]) == len(whole["spans"])
    assert treport.render(run)


def test_cli_renders_timeline_and_calibration(recorded_run, tmp_path,
                                              capsys):
    chrome = tmp_path / "trace.json"
    assert cli([recorded_run, "--chrome", str(chrome)]) == 0
    out = capsys.readouterr().out
    assert "12 step records" in out
    assert "timeline" in out and "decision quality" in out
    assert "trainer.step" in out and "dmm" in out
    with open(chrome) as f:
        doc = json.load(f)
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])


def test_cli_empty_dir_is_an_error(tmp_path):
    assert cli([str(tmp_path)]) == 1


def test_obslog_rejects_unknown_kind():
    log = ttrace.ObsLog(None)
    with pytest.raises(ValueError):
        # reprolint: disable=event-kind-drift -- deliberately unregistered: this pins the runtime rejection the lint rule mirrors
        log.emit(log.autotick(), "not-a-kind")


@pytest.mark.parametrize("first", ["repro_torch.obs",
                                   "repro_torch.controlplane"])
def test_import_in_a_fresh_interpreter(first):
    """obs.trace imports the control plane's events, whose package
    imports the supervisor: either order imports, and the subprocess
    worker's import stays free of torch."""
    code = (f"import sys, {first}, repro_torch.obs, repro_torch.controlplane"
            "\nassert repro_torch.obs.ObsRun\n"
            "import subprocess\n"
            "r = subprocess.run([sys.executable, '-c', 'import sys, "
            "repro_torch.controlplane.worker; print(\"torch\" in "
            "sys.modules)'], capture_output=True, text=True, check=True)\n"
            "print(r.stdout.strip())")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
