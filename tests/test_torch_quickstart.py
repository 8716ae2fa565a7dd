"""``examples/torch_quickstart.py`` at a small size on the CPU: the DMM
fit, the controller and the Trainer run end to end, with finite losses
and the controller cutting below the 8 workers at some step."""
import importlib.util
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(2)

EXAMPLE = (Path(__file__).resolve().parent.parent / "examples"
           / "torch_quickstart.py")


def test_torch_quickstart_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location("torch_quickstart",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    hist = mod.main(device="cpu", fit_steps=20, train_steps=8)
    assert len(hist) == 8
    assert np.all(np.isfinite([h["loss"] for h in hist]))
    assert min(h["c"] for h in hist) < 8
    out = capsys.readouterr().out
    assert "recorded trace" in out and "simulated wall-clock" in out
