"""The port's multi-job launcher against the JAX package's, on the CPU.

``build_multi_job(2, 8, ...)`` through the reference's churn timeline
(tests/test_multi_job.py): a ChurnEvent kill -> PartitionView shrink ->
Trainer resize -> JobHandle.resize -> Elfving fallback -> refit -> rejoin,
global worker ids kept through every hop, the other tenant never leaving
the batched path.  With the JAX-fitted DMMs carried across (the initial
fits and every refit, asked for with identical rows, width and seed)
both launchers make the same cutoffs, widths and modes tick for tick.
Then the shared train step's worker buffers (one per width in use, the
old width's freed on a single job's resize), the CLI and the demo at a
small size.
"""
import jax
import numpy as np
import pytest
import torch

from repro.cluster.simulator import ChurnEvent as JChurnEvent
from repro.launch import multi_job as jmj
from repro.ps import make_scheduler as jmake
from repro.ps import server as jserver
from repro_torch import weights
from repro_torch.cluster.simulator import (ChurnEvent, ChurnSim,
                                           paper_cluster_158)
from repro_torch.core.runtime_model.api import RuntimeModel as TRM
from repro_torch.launch import multi_job as tmj
from repro_torch.ps import make_scheduler
from repro_torch.ps import server as tserver

torch.set_num_threads(2)

TICKS, KILL_AT, BACK_AT = 22, 6, 14
KW = dict(seed=0, fit_steps=40, refit_steps=30, refit_fresh=3,
          metrics_every=50)


def _port(rm):
    return weights.runtime_model_from_jax(
        jax.tree.map(np.asarray, rm.params), rm.norm_scale, lag=rm.lag,
        device="cpu")


def _timeline(pkg_run_ticks, server, jobs, sched):
    out = []
    for tick in range(TICKS):
        d = pkg_run_ticks(server, jobs, sched, 1)["dispatches"]
        j1 = server.registry["job1"]
        out.append({"tick": tick, "width": j1.width, "mode": j1.mode,
                    "members": j1.members.copy(), "dispatches": d,
                    "c": [jobs[j].trainer.history[-1]["c"]
                          for j in sorted(jobs)]})
    return out


@pytest.fixture(scope="module")
def churn_runs():
    """The JAX launcher (its fits recorded), then the port's with the same
    fitted models carried across."""
    fits, refits = {}, []
    real = jserver.PSServer._fit_model

    def recording(self, job, rows, n, seed):
        model = real(self, job, rows, n, seed)
        refits.append((np.array(rows), n, seed, _port(model)))
        return model

    events = [(KILL_AT, (8, 9), ()), (BACK_AT, (), (8, 9))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserver.PSServer, "_fit_model", recording)
        jsrv, jjobs, _ = jmj.build_multi_job(
            2, 8, churn_events=[JChurnEvent(step=s, kill=k, restore=r)
                                for s, k, r in events], **KW)
        for j in range(2):
            fits[j] = _port(jsrv.registry[f"job{j}"].model)
        jline = _timeline(jmj.run_ticks, jsrv, jjobs, jmake("rr"))

    asked = []

    def carried_fit(self, traces, *, steps=800, batch=16, lr=3e-3, seed=0,
                    verbose=False, clip=5.0):
        src = fits[seed]               # build_multi_job fits job j at seed j
        self.params, self.norm_scale = src.params, src.norm_scale
        return []

    def carried_refit(self, job, rows, n, seed):
        want_rows, want_n, want_seed, model = refits[len(asked)]
        asked.append((n, seed))
        assert (n, seed) == (want_n, want_seed)
        np.testing.assert_array_equal(np.asarray(rows), want_rows)
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TRM, "fit", carried_fit)
        mp.setattr(tserver.PSServer, "_fit_model", carried_refit)
        tsrv, tjobs, _ = tmj.build_multi_job(
            2, 8, churn_events=[ChurnEvent(step=s, kill=k, restore=r)
                                for s, k, r in events], device="cpu", **KW)
        tline = _timeline(tmj.run_ticks, tsrv, tjobs, make_scheduler("rr"))
    assert len(asked) == len(refits) == 2
    return jline, (tsrv, tjobs, tline)


def test_cutoffs_widths_and_modes_match_jax(churn_runs):
    jline, (_, _, tline) = churn_runs
    for a, b in zip(jline, tline):
        assert (b["c"], b["width"], b["mode"]) == (a["c"], a["width"],
                                                   a["mode"]), b["tick"]
        np.testing.assert_array_equal(b["members"], a["members"])
        assert b["dispatches"] == a["dispatches"], b["tick"]
    assert len({tuple(t["c"]) for t in tline}) > 1


def test_churn_shrinks_job_and_preserves_global_ids(churn_runs):
    _, (_, _, timeline) = churn_runs
    shrunk = [t for t in timeline if KILL_AT <= t["tick"] < BACK_AT]
    assert all(t["width"] == 6 for t in shrunk)
    for t in shrunk:
        np.testing.assert_array_equal(t["members"], np.arange(10, 16))
    assert shrunk[0]["mode"] == "fallback", "resize must degrade first"
    assert shrunk[-1]["mode"] == "dmm", "refit must rejoin the batch"


def test_churn_recovers_width_and_stays_batched(churn_runs):
    _, (server, jobs, timeline) = churn_runs
    final = timeline[-1]
    assert final["width"] == 8 and final["mode"] == "dmm"
    np.testing.assert_array_equal(
        np.sort(np.asarray(server.registry["job1"].members)),
        np.arange(8, 16))
    assert jobs["job0"].handle.mode == "dmm" and jobs["job0"].handle.n == 8
    assert len(jobs["job0"].trainer.history) == len(timeline)
    assert len(jobs["job1"].trainer.history) == len(timeline)
    assert sum(t["dispatches"] for t in timeline) < 2 * len(timeline)


# ---------------------------------------------------------------------------
# The shared step's worker buffers.
# ---------------------------------------------------------------------------


def _psum_trainer(step_fn, opt, cfg, timer, n, seed):
    from repro_torch.core.controller import FullSyncController
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import Trainer
    from repro_torch.models import model as M

    tr = Trainer(step_fn=step_fn, controller=FullSyncController(n),
                 data=SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=8,
                                      global_batch=12, seed=seed),
                 timer=timer, n_workers=n, mask_agg="psum")
    params = M.init_model(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")
    return tr.restore_or_init(lambda: {"params": params,
                                       "opt": opt.init(params)})


@pytest.fixture(scope="module")
def tiny():
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs.base import bench_tiny_config
    from repro_torch.launch.train import make_train_step

    cfg = dataclasses.replace(bench_tiny_config(), head_dim=64)
    opt = optim.adamw(3e-3, fused=True)
    return cfg, opt, (lambda: make_train_step(cfg, opt, mask_agg="psum"))


def test_shared_step_keeps_one_buffer_per_width(tiny, monkeypatch):
    """Two trainers at widths 4 and 6 alternate through ONE step: after
    the first two steps no buffer is allocated again."""
    from repro_torch.kernels import ops

    cfg, opt, make = tiny
    made = []
    real = ops.WorkerGrads.__init__

    def counted(self, *a, **kw):
        made.append(a[1] if len(a) > 1 else kw.get("n_workers"))
        real(self, *a, **kw)

    monkeypatch.setattr(ops.WorkerGrads, "__init__", counted)
    step_fn = make()
    a = _psum_trainer(step_fn, opt, cfg, None, 4, 0)
    b = _psum_trainer(step_fn, opt, cfg, None, 6, 1)
    for _ in range(3):
        a.run(1)
        b.run(1)
    assert made == [4, 6]
    assert sorted(k[0] for k in step_fn.buffers) == [4, 6]


def test_single_job_resize_frees_the_old_width(tiny):
    """One trainer through a 6 -> 4 churn: the width-6 buffer is gone
    before the width-4 one is made (they never coexist)."""
    from repro_torch.kernels import ops

    cfg, opt, make = tiny
    step_fn = make()
    seen = []
    real = ops.WorkerGrads.__init__

    def watched(self, params, W):
        seen.append((W, sorted(k[0] for k in step_fn.buffers)))
        real(self, params, W)

    timer = ChurnSim(paper_cluster_158(1, n_workers=6),
                     [ChurnEvent(step=2, kill=(4, 5))])
    tr = _psum_trainer(step_fn, opt, cfg, timer, 6, 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops.WorkerGrads, "__init__", watched)
        tr.run(4)
    assert [h["n"] for h in tr.history] == [6, 6, 4, 4]
    assert seen == [(6, []), (4, [])]
    assert sorted(k[0] for k in step_fn.buffers) == [4]


# ---------------------------------------------------------------------------
# Entry points at a small size.
# ---------------------------------------------------------------------------


def test_cli_runs_on_the_cpu_and_refuses_obs(capsys, tmp_path):
    """The CLI on the CPU, bare and with ``--obs-dir`` (which no longer
    refuses: it writes the four streams, every job's decisions scored and
    every tick in a ``multi_job.tick`` span)."""
    from repro_torch.controlplane.events import read_events

    assert tmj.main(["--device", "cpu", "--jobs", "2", "--ticks", "6"]) == 0
    assert "fused dispatches" in capsys.readouterr().out
    d = tmp_path / "obs"
    assert tmj.main(["--device", "cpu", "--jobs", "2", "--ticks", "6",
                     "--obs-dir", str(d)]) == 0
    assert "python -m repro_torch.obs" in capsys.readouterr().out
    streams = {k: read_events(str(d / f"{k}.jsonl"))
               for k in ("spans", "steps", "decisions", "metrics")}
    assert all(streams.values())
    names = [e.data["name"] for e in streams["spans"]]
    assert names.count("multi_job.tick") == 6 and "ps.flush" in names
    assert {e.data["policy"] for e in streams["decisions"]} \
        == {"job0", "job1"}
    assert {e.data["job"] for e in streams["steps"]} == {"job0", "job1"}


def test_demo_runs_on_the_cpu():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_multi_job_demo.py"
    spec = importlib.util.spec_from_file_location("torch_multi_job_demo",
                                                  path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    out = demo.main(device="cpu", ticks=15, fit_steps=30, refit_steps=20)
    assert out["phase1"]["widths"]["job1"] == 8
    assert out["phase1"]["dispatches"] < 2 * 15
    rr = out["phase2"]["rr"]
    assert sum(rr.values()) == 2 * 15 and max(rr.values()) - min(
        rr.values()) <= 1
