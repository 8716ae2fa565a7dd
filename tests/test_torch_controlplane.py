"""The port's control plane against the JAX package's, on the CPU.

  * event logs written by either package read equal in the other, and
    the JSONL bytes are the same for the same events and wall stamps;
  * ``HeartbeatMonitor`` over seeded beat streams: the reference's state
    transitions and events, never dead before the deadline, dead at
    exactly last beat + dead_after + 1;
  * ``FaultPlan`` storms and ``FaultInjector`` budgets equal for a seed;
    ``corrupt_checkpoint`` damage caught by the port's store;
  * ``Supervisor`` over ``SimWorkerPool`` (``default_plan(6)``, a flaky
    eviction, seeded storms): the reference's event stream (kind, tick,
    worker, data) and an equal ``drill_report``; ``SupervisedTimer`` rows;
  * ``run_supervised(steps=36, n_workers=6, device="cpu")``: match, 2
    detections within 5 ticks, 1 failed restart, no evictions, widths
    {5, 6}, losses within the Trainer's bar (tests/test_torch_train.py:
    atol 1e-5) of JAX's ``run_supervised`` at head_dim 64, the JAX
    params carried across; the detected storm's ``scripted_equivalent``
    against the live timer column for column, and against JAX's;
  * one real SIGKILL against ``ProcWorkerPool`` subprocess workers, its
    ticks driven by heartbeats (``proc_crash_drill``);
  * the host metrics collectors, and the options that wait for A.14.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import simulator as jsim
from repro.configs import base as jbase
from repro.controlplane import events as jev
from repro.controlplane import faults as jfaults
from repro.controlplane import heartbeat as jhb
from repro.controlplane import supervisor as jsup
from repro.launch import supervised as jsupervised
from repro.models import model as JM
from repro.obs import metrics as jmetrics
from repro_torch import weights
from repro_torch.checkpoint import store
from repro_torch.cluster import simulator as tsim
from repro_torch.controlplane import events as tev
from repro_torch.controlplane import faults as tfaults
from repro_torch.controlplane import heartbeat as thb
from repro_torch.controlplane import supervisor as tsup
from repro_torch.launch import supervised as tsupervised
from repro_torch.obs import metrics as tmetrics

torch.set_num_threads(2)

LOSS_ATOL = 1e-5     # tests/test_torch_train.py, the Trainer against JAX's


def _clock():
    t = [1_700_000_000.0]

    def tick():
        t[0] += 0.123456789
        return t[0]
    return tick


def _emit_all(log):
    log.emit(0, "run", n=4, phase="start")
    log.emit(3, "suspect", 2, last_beat=0, silent_ticks=3)
    log.emit(5, "dead", 2, last_beat=0, silent_ticks=5)
    log.emit(5, "membership", n=3, members=[0, 1, 3])
    log.emit(7, "restart", 2, attempt=1, failures=0)
    log.emit(7, "recover", 2, step=7, warm=True)
    log.emit(7, "fault", None, fault="corrupt_ckpt", path="")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_event_logs_read_across_packages(tmp_path, writer):
    w, r = (tev, jev) if writer == "port" else (jev, tev)
    path = str(tmp_path / "ev.jsonl")
    with w.EventLog(path, clock=_clock()) as log:
        _emit_all(log)
    back = r.read_events(path)
    assert [(e.seq, e.tick, e.kind, e.worker, e.data) for e in back] == \
        [(e.seq, e.tick, e.kind, e.worker, e.data) for e in log.events]
    tailed = list(r.tail_events(path, stop=lambda: True, poll=0.001))
    assert [e.to_json() for e in tailed] == [e.to_json() for e in back]


def test_event_log_bytes_equal_the_reference(tmp_path):
    paths = []
    for name, mod in (("t", tev), ("j", jev)):
        path = tmp_path / f"{name}.jsonl"
        with mod.EventLog(str(path), clock=_clock()) as log:
            _emit_all(log)
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert tev.EVENT_KINDS == jev.EVENT_KINDS


def test_partial_trailing_line_and_malformed_line(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    with tev.EventLog(path) as log:
        log.emit(0, "run")
        log.emit(1, "dead", 3)
    with open(path, "a") as f:
        f.write('{"seq": 2, "tick": 2, "ki')
    assert [e.kind for e in tev.read_events(path)] == ["run", "dead"]
    with open(path, "a") as f:
        f.write("garbage }{\n")
    with pytest.raises(json.JSONDecodeError):
        tev.read_events(path)
    log = tev.EventLog()
    with pytest.raises(ValueError, match="unknown event kind"):
        # reprolint: disable=event-kind-drift -- negative test: 'explode' must stay unregistered for the ValueError to fire
        log.emit(0, "explode")
    log.emit(5, "dead", 0)
    with pytest.raises(ValueError, match="backwards"):
        log.emit(4, "rejoin", 0)


def _drive_monitor(mod, seed, n=5, ticks=60, grace=0):
    """A seeded beat stream: each worker beats with its own probability,
    dead workers are re-admitted a few ticks later.  Returns every
    transition, the events, and each death's (tick, last beat, whether it
    beat since its admit)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.3, 1.0, size=n)
    log = mod.EventLog(clock=lambda: 0.0)
    mon = mod.HeartbeatMonitor(range(n), suspect_after=2, dead_after=4,
                               grace=grace, log=log)
    trans, deaths, revive = [], [], {}
    for t in range(1, ticks):
        for w in range(n):
            if rng.uniform() < p[w]:
                mon.beat(w, t)
        before = {w: (mon._tracks[w].last_beat,
                      mon._tracks[w].beaten_since_admit) for w in range(n)}
        out = mon.advance(t)
        trans.append(out)
        for w, _old, new in out:
            if new == mod.DEAD:
                deaths.append((t,) + before[w])
                revive[w] = t + int(rng.integers(1, 4))
        for w, at in list(revive.items()):
            if at == t:
                mon.admit(w, t)
                del revive[w]
    return trans, [(e.tick, e.kind, e.worker, e.data) for e in log.events], \
        deaths


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("grace", [0, 6])
def test_heartbeat_monitor_matches_the_reference(seed, grace):
    ours = _drive_monitor(thb, seed, grace=grace)
    theirs = _drive_monitor(jhb, seed, grace=grace)
    assert ours[0] == theirs[0] and ours[1] == theirs[1]
    assert ours[2], "the stream must kill someone"
    for tick, last, beaten in ours[2]:
        # dead at EXACTLY last beat + dead_after + 1; a worker silent
        # since its admit gets the grace line instead when it is longer
        assert tick == last + (4 if beaten else max(4, grace)) + 1


def test_heartbeat_never_dead_before_the_deadline():
    mon = thb.HeartbeatMonitor([0, 1], suspect_after=2, dead_after=4)
    mon.beat(0, 3)
    for t in range(4, 8):
        assert (0, thb.SUSPECT, thb.DEAD) not in mon.advance(t)
        assert mon.state(0) != thb.DEAD
    assert (0, thb.SUSPECT, thb.DEAD) in mon.advance(8)
    mon.beat(0, 9)                       # a late beat is dropped
    assert mon.state(0) == thb.DEAD
    mon.admit(0, 9)
    assert mon.state(0) == thb.ALIVE and mon.members().tolist() == [0]
    with pytest.raises(ValueError):
        thb.HeartbeatMonitor([0], suspect_after=4, dead_after=4)


def _fault_tuple(f):
    return (f.at, f.kind, f.worker, f.factor, f.duration, f.fails, f.group)


@pytest.mark.parametrize("seed", range(5))
def test_fault_storms_equal_the_reference(seed):
    kinds = ("crash", "hang", "slowdown")
    a = tfaults.FaultPlan.storm(8, 4, 40, seed=seed, kinds=kinds)
    b = jfaults.FaultPlan.storm(8, 4, 40, seed=seed, kinds=kinds)
    assert [_fault_tuple(f) for f in a.faults] == \
        [_fault_tuple(f) for f in b.faults]
    assert a.horizon == b.horizon
    with pytest.raises(ValueError):
        tfaults.FaultPlan.storm(2, 3, 10)
    with pytest.raises(ValueError):
        tfaults.Fault(at=1, kind="meteor", worker=0)


def test_fault_injector_budgets_equal_the_reference():
    plans = [mod.FaultPlan([mod.Fault(at=3, kind="flaky_restart", worker=1,
                                      fails=2),
                            mod.Fault(at=3, kind="crash", worker=1),
                            mod.Fault(at=5, kind="hang", worker=0)])
             for mod in (tfaults, jfaults)]
    injs = [mod.FaultInjector(p, seed=1)
            for mod, p in zip((tfaults, jfaults), plans)]
    for inj in injs:
        seen = [[_fault_tuple(f) for f in inj.fire(t)] for t in range(8)]
        seen.append([_fault_tuple(f) for f in inj.fire(3)])   # once only
        seen.append([inj.restart_should_fail(1) for _ in range(4)])
        inj.result = seen
    assert injs[0].result == injs[1].result


def test_corrupted_checkpoint_is_caught_by_the_store(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    for step in (5, 10):
        store.save(ckpt, step, {"ctl": {"step": np.int64(step),
                                        "members": np.arange(4)}})
    inj = tfaults.FaultInjector(tfaults.FaultPlan(), seed=3)
    path = inj.corrupt_checkpoint(ckpt, "ctl")
    assert path.endswith("step_0000000010/ctl.npz")
    with pytest.raises(store.CheckpointError):
        store.verify_step(ckpt, 10)
    assert store.latest_valid_step(ckpt) == 5


# ---------------------------------------------------------------------------
# The supervisor against the reference's.
# ---------------------------------------------------------------------------


PLANS = {
    "default_plan_6": lambda mod: tsupervised.default_plan(6).faults
    if mod is tfaults else jsupervised.default_plan(6).faults,
    "flaky_evict": lambda mod: [
        mod.Fault(at=5, kind="crash", worker=2),
        mod.Fault(at=5, kind="flaky_restart", worker=2, fails=3)],
    "storm_s3": lambda mod: mod.FaultPlan.storm(6, 4, 30, seed=3).faults,
    "storm_s7": lambda mod: mod.FaultPlan.storm(6, 5, 30, seed=7).faults,
}


PORT = (tsim, tev, tfaults, tsup)
REFERENCE = (jsim, jev, jfaults, jsup)


def _supervise(mods, plan, ticks=60, jitter=0):
    sim, emod, fmod, smod = mods
    overlay = sim.OverlaySim(sim.paper_cluster_158(1, n_workers=6))
    pool = smod.SimWorkerPool(overlay, fmod.FaultInjector(
        fmod.FaultPlan(PLANS[plan](fmod)), seed=0))
    sup = smod.Supervisor(pool, suspect_after=2, dead_after=4,
                          restart_base=2, restart_cap=16,
                          restart_jitter=jitter, flap_limit=3, seed=0,
                          log=emod.EventLog(clock=lambda: 0.0))
    timer = smod.SupervisedTimer(overlay, sup)
    rows, changed = [], []
    for t in range(ticks):
        changed.append(sup.tick(t))
        rows.append((timer.active_ids.tolist(), timer.step().tolist()))
    return sup, rows, changed


@pytest.mark.parametrize("jitter", [0, 2])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_supervisor_matches_the_reference(plan, jitter):
    ts, trows, tchanged = _supervise(PORT, plan, jitter=jitter)
    js, jrows, jchanged = _supervise(REFERENCE, plan, jitter=jitter)
    key = lambda sup: [(e.seq, e.tick, e.kind, e.worker, e.data)
                       for e in sup.log.events]
    assert key(ts) == key(js)
    assert [e.to_json() for e in ts.log.events] == \
        [e.to_json() for e in js.log.events]
    assert trows == jrows and tchanged == jchanged
    assert tsup.drill_report(ts.log.events) == \
        jsup.drill_report(js.log.events)
    assert ts.evicted == js.evicted
    assert ts.membership().tolist() == js.membership().tolist()


def test_flaky_restarts_back_off_then_evict():
    sup, _, _ = _supervise(PORT, "flaky_evict", ticks=80)
    fails = sup.log.of_kind("restart_failed")
    assert [e.worker for e in fails] == [2, 2, 2]
    assert np.diff([e.tick for e in fails]).tolist() == [4, 8]
    assert sup.evicted == {2} and 2 not in sup.membership().tolist()
    rep = tsup.drill_report(sup.log.events)
    assert rep["evicted"] == [2] and rep["failed_restarts"] == 3


def test_overlay_sim_matches_the_reference():
    sims = [m.OverlaySim(m.ClusterSim(n_workers=6, n_nodes=2, seed=4))
            for m in (tsim, jsim)]
    rows = [[], []]
    for t in range(12):
        for s, r in zip(sims, rows):
            if t == 3:
                s.stall(1)
                s.slow(4, 2.5)
            if t == 8:
                s.stall(1, False)
            r.append(s.step())
    np.testing.assert_array_equal(np.stack(rows[0]), np.stack(rows[1]))
    assert rows[0][5][1] == tsim.OverlaySim.STALL
    with pytest.raises(ValueError):
        sims[0].slow(0, 0.0)


def test_host_metrics_match_the_reference():
    regs = [tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()]
    for reg in regs:
        reg.counter("restarts").inc()
        reg.counter("restarts").inc(2)
        reg.gauge("width").set(5)
        for v in (4, 5, 3):
            reg.series("detection_ticks").observe(v)
        reg.series("empty")
        for w in (3, 1, 3):
            reg.labels("evicted").add(w)
    a, b = (r.summary() for r in regs)
    assert a == b
    # the device collectors are ported too (their payloads against the
    # reference's: tests/test_torch_obs.py)
    for reg in regs:
        reg.ring("loss", ("loss",)).push((2.5,))
        reg.histogram("h", (1.0, 2.0)).add(1.5)
    a, b = (r.drain() for r in regs)
    assert a == b and [p["collector"] for p in a] == ["ring", "histogram"]
    assert regs[0].summary()["rings"] == {"loss": {"pushed": 1, "cap": 256}}


# ---------------------------------------------------------------------------
# The supervised trainer.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def supervised_runs():
    """The port's run_supervised(36, 6 workers) on the CPU from the JAX
    params, and JAX's run_supervised at the same head_dim 64."""
    jcfg = dataclasses.replace(jbase.bench_tiny_config(), head_dim=64)
    jparams = jax.tree.map(np.asarray,
                           JM.init_model(jcfg, jax.random.PRNGKey(0)))
    mp = pytest.MonkeyPatch()
    # the port's seeded init gives the JAX params, carried across, and
    # JAX's tiny config the port's head_dim 64
    mp.setattr(tsupervised.M, "init_model",
               lambda cfg, gen, device=None: weights.from_jax(
                   cfg, jparams, device))
    mp.setattr(jbase, "bench_tiny_config", lambda: jcfg)
    try:
        ours = tsupervised.run_supervised(steps=36, seed=0, n_workers=6,
                                          device="cpu", verbose=False)
        theirs = jsupervised.run_supervised(steps=36, seed=0, n_workers=6,
                                            verbose=False)
    finally:
        mp.undo()
    return ours, theirs


def test_run_supervised_on_the_cpu(supervised_runs):
    out, _ = supervised_runs
    assert out["match"], "supervised losses diverged from scripted replay"
    rep = out["report"]
    assert rep["n_detected"] == 2
    assert rep["max_detection_ticks"] <= 4 + 1
    assert rep["failed_restarts"] == 1
    assert rep["evicted"] == []
    assert sorted(set(out["widths"])) == [5, 6]
    assert np.all(np.isfinite([h["loss"] for h in out["history"]]))


def test_run_supervised_follows_jax(supervised_runs):
    ours, theirs = supervised_runs
    key = lambda e: (e.tick, e.kind, e.worker, e.data)
    assert [key(e) for e in ours["events"]] == \
        [key(e) for e in theirs["events"]]
    assert ours["report"] == theirs["report"]
    for h in ("history", "scripted_history"):
        assert [(r["n"], r["c"], r["clock"]) for r in ours[h]] == \
            [(r["n"], r["c"], r["clock"]) for r in theirs[h]]
        np.testing.assert_allclose([r["loss"] for r in ours[h]],
                                   [r["loss"] for r in theirs[h]],
                                   atol=LOSS_ATOL)


def test_scripted_equivalent_replays_the_detected_storm(supervised_runs):
    """Stepping the detected storm's scripted_equivalent gives the live
    supervised timer's active ids and runtime rows, column for column,
    and equals JAX's scripted replay of JAX's events."""
    out, theirs = supervised_runs
    overlay, sup, timer = tsupervised.build_supervised(
        6, tsupervised.default_plan(6), seed=0)
    live = []
    for t in range(36):
        sup.tick(t)
        live.append((timer.active_ids.tolist(), timer.step()))
    replays = [
        tsupervised.scripted_equivalent(
            out["events"], tsim.paper_cluster_158(1, n_workers=6)),
        jsupervised.scripted_equivalent(
            theirs["events"], jsim.paper_cluster_158(1, n_workers=6))]
    for replay in replays:
        for t, (ids, row) in enumerate(live):
            assert replay.active_ids.tolist() == ids, t
            np.testing.assert_array_equal(replay.step(), row, err_msg=t)
    assert {len(ids) for ids, _ in live} == {5, 6}


@pytest.mark.parametrize("argv", [["--obs-dir", "x"]])
def test_supervised_options_that_wait_raise(argv, tmp_path, capsys):
    """No option waits any more: ``--obs-dir`` writes the supervisor's
    tick spans and counters and the supervised trainer's streams, and the
    run still matches its scripted replay."""
    from repro_torch.controlplane.events import read_events

    d = tmp_path / argv[1]
    argv = [argv[0], str(d), "--device", "cpu", "--steps", "24"]
    assert tsupervised.main(argv) == 0
    assert "supervised fault-storm run OK" in capsys.readouterr().out
    streams = {k: read_events(str(d / f"{k}.jsonl"))
               for k in ("spans", "steps", "decisions", "metrics")}
    assert all(streams.values())
    names = [e.data["name"] for e in streams["spans"]]
    assert names.count("supervisor.tick") == 24
    assert names.count("trainer.step") == 24
    summary = streams["metrics"][-1].data["summary"]
    assert summary["counters"]["supervisor.ticks"] == 24
    assert summary["counters"]["supervisor.membership_changes"] >= 2


def test_supervised_needs_a_card_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsupervised.run_supervised(steps=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsupervised.main(["--steps", "2"])


def test_cli_runs_on_the_cpu(capsys):
    assert tsupervised.main(["--device", "cpu", "--steps", "24"]) == 0
    text = capsys.readouterr().out
    assert "crash on worker 5 at tick 12: detected=True (+4 ticks)" in text


def test_subprocess_crash_is_detected_and_restarted(tmp_path):
    out = tsupervised.proc_crash_drill(str(tmp_path / "run"))
    assert out["dead_tick"] == out["crash_tick"] + 4 + 1
    assert out["restart_tick"] == out["rejoin_tick"] == out["dead_tick"] + 2
    rep = out["report"]
    assert rep["n_detected"] == 1 and rep["max_detection_ticks"] == 5
    assert rep["restarts"] == 1 and rep["evicted"] == []
    assert out["members"] == [0, 1, 2]
    assert all(out["running_at_end"])
    kinds = [e.kind for e in out["events"] if e.worker == 1]
    assert kinds.index("dead") < kinds.index("restart")
