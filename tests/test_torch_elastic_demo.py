"""The port's elastic entry points at a small size on the CPU:
``launch.elastic`` (the seeded 8 -> 6 -> 8 churn run, its warm mid-churn
restart and the full-sync baseline) and
``examples/torch_fault_tolerance_demo.py`` (phases 1-5, phase 5 the
heartbeat-detected failures); ``--obs-dir`` writes the telemetry streams,
the option that waits for an unported slice raises, and without
``device`` they need a card."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.runtime_model.api import RuntimeModel
from repro_torch.launch import elastic

torch.set_num_threads(2)

EXAMPLE = (Path(__file__).resolve().parent.parent / "examples"
           / "torch_fault_tolerance_demo.py")


def test_churn_demo_runs_on_the_cpu(capsys):
    out = elastic.run_churn_demo(steps=12, device="cpu")
    widths = out["widths"]
    assert widths == [8] * 4 + [6] * 4 + [8] * 4
    assert out["resumed_n"] == 8 and out["resumed_step"] == 9
    assert out["fallback_steps"] > 0
    text = capsys.readouterr().out
    assert "resumed at step 6, width 6 (ckpt width 6), controller window " \
           "warm: True" in text
    assert "elastic degraded-capacity run OK" in text


@pytest.mark.parametrize("argv, slice_", [(["--aot"], "A.15")])
def test_unported_options_raise_naming_their_slice(argv, slice_):
    with pytest.raises(NotImplementedError, match=slice_):
        elastic.main(argv)


def test_obs_dir_writes_four_streams(tmp_path, capsys):
    """``--obs-dir`` at the smallest size the demo runs: four non-empty
    streams, the elastic trainer's steps and decisions among them, and
    the demo's own report unchanged."""
    from repro_torch.controlplane.events import read_events

    d = tmp_path / "obs"
    assert elastic.main(["--device", "cpu", "--steps", "6",
                         "--obs-dir", str(d)]) == 0
    assert "elastic degraded-capacity run OK" in capsys.readouterr().out
    streams = {k: read_events(str(d / f"{k}.jsonl"))
               for k in ("spans", "steps", "decisions", "metrics")}
    assert all(streams.values())
    assert [e.data["n"] for e in streams["steps"]] == [8, 8, 6, 6, 8, 8]
    assert {e.data["job"] for e in streams["steps"]} == {"elastic"}
    assert len(streams["decisions"]) == 6


def test_entry_points_need_a_card_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic.run_churn_demo(steps=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic.main(["--steps", "3"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RuntimeModel(8)


def test_fault_tolerance_demo_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location("torch_ft_demo", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(device="cpu", train_steps=10, resume_steps=2,
                   failure_steps=10, supervised_steps=32)
    assert [len(out[k]) for k in ("phase1", "phase2", "phase3", "phase4",
                                  "restart", "phase5")] \
        == [10, 2, 10, 20, 5, 32]
    assert out["phase2"][0]["step"] == 11           # resumed, not cold
    # the dead worker (runtime 1e6) is always cut once Elfving is warm
    assert all(h["c"] < 8 for h in out["phase3"][-5:])
    widths = [h["n"] for h in out["phase4"]]
    assert widths == [8] * 6 + [6] * 8 + [8] * 6
    assert [h["n"] for h in out["restart"]] == [6] * 5
    # phase 5: the crash and the hang detected from missed heartbeats
    # (deadline + 1 tick at most), the widths ridden off detection alone
    rep = out.pop("phase5_report")
    assert rep["n_detected"] == 2 and rep["max_detection_ticks"] <= 5
    assert rep["failed_restarts"] == 1 and rep["evicted"] == []
    assert [(i["worker"], i["detected"]) for i in rep["incidents"]] \
        == [(7, True), (6, True)]
    widths = [h["n"] for h in out["phase5"]]
    assert sorted(set(widths)) == [7, 8] and widths[-1] == 8
    for hist in out.values():
        assert np.all(np.isfinite([h["loss"] for h in hist]))
    text = capsys.readouterr().out
    assert "step-10 checkpoint membership: n=6" in text
    assert "widths ridden off detection alone: [7, 8]" in text
    assert "all phases OK" in text
