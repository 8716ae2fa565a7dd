"""The port's cutoff-SGD CLI (``examples/torch_train_cutoff_sgd.py``,
``repro_torch.launch.cutoff_sgd``) on the CPU.

(a) The CLI's ``Trainer`` on 2 gloo ranks against the one-process port
``Trainer`` at a reduced size (qwen2-0.5b reduced to 2 layers, W 4,
batch 8): the DMM is fitted (20 steps) and decides on rank 0 alone, its
decision reaches rank 1 by one broadcast a step; the one-process run gives
the same cutoff sequence and clock, losses within 1e-5 and parameters
within 1e-5, and rank 0's telemetry holds one decision a step.  (b) The
example itself at its own model (~65M parameters by the reference's
count) and a small size, plainly and under ``torch.distributed.run`` with
2 gloo ranks (one worker each), as subprocesses: the two print the same
losses, and only rank 0 prints.  (c) The options are the reference
CLI's, plus ``--device``.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.controlplane.events import read_events
from repro_torch.launch import cutoff_sgd, ranks

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "torch_train_cutoff_sgd.py"


@pytest.mark.parametrize("mask_agg", ["psum", "weights"])
def test_two_rank_trainer_matches_the_one_process_trainer(tmp_path,
                                                          mask_agg):
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              n_layers=2)
    steps = 4

    def argv(tag):
        return ["--device", "cpu", "--steps", str(steps), "--seq", "8",
                "--batch", "8", "--workers", "4", "--method", "cutoff",
                "--mask-agg", mask_agg, "--ckpt", str(tmp_path / tag),
                "--obs-dir", str(tmp_path / f"obs_{tag}")]

    out = ranks.spawn(ranks.cutoff_sgd, 2, argv("dp"), cfg, 20,
                      init_method=f"file://{tmp_path}/pg")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # as each spawned rank runs
    try:
        tr = cutoff_sgd.train(cutoff_sgd.parser().parse_args(argv("one")),
                              cfg=cfg, fit_steps=20)
    finally:
        torch.set_num_threads(threads)
    want_c = [h["c"] for h in tr.history]
    want_params = [x.numpy() for x in tree.leaves(tr.state["params"])]
    assert len(want_c) == steps and min(want_c) < 4   # the DMM cuts
    for hist, params in out:
        assert [h["c"] for h in hist] == want_c
        assert [h["clock"] for h in hist] == [h["clock"]
                                              for h in tr.history]
        np.testing.assert_allclose([h["loss"] for h in hist],
                                   [h["loss"] for h in tr.history],
                                   rtol=0, atol=1e-5)
        dp = max(float(np.abs(a - b).max())
                 for a, b in zip(tree.leaves(params), want_params))
        assert dp < 1e-5, dp
    decisions = read_events(str(tmp_path / "obs_dp" / "decisions.jsonl"))
    assert len(decisions) == steps


def _run(cmd, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2",
               TMPDIR=str(tmp_path))
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _losses(text):
    return re.findall(r"^loss: (\S+) -> (\S+)$", text, re.M)


def test_example_runs_plainly_and_under_two_gloo_ranks(tmp_path):
    args = ["--device", "cpu", "--steps", "2", "--seq", "8", "--batch", "4",
            "--workers", "2", "--method", "sync", "--mask-agg", "psum"]
    plain = _run([sys.executable, str(EXAMPLE), *args,
                  "--ckpt", str(tmp_path / "ck1"),
                  "--obs-dir", str(tmp_path / "obs")], tmp_path)
    assert "1 rank(s) of 2 workers on cpu" in plain
    assert len(read_events(str(tmp_path / "obs" / "steps.jsonl"))) == 2
    dp = _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", str(EXAMPLE), *args,
               "--ckpt", str(tmp_path / "ck2")], tmp_path)
    assert "2 rank(s) of 1 workers on cpu" in dp
    assert dp.count("=== sync ===") == 1          # rank 0 alone prints
    assert _losses(plain) and _losses(dp) == _losses(plain)
    assert "mean cutoff: 2.0/2" in dp


def test_options_are_the_reference_clis():
    """The reference CLI's options and defaults, plus ``--device``."""
    ap = cutoff_sgd.parser()
    args = ap.parse_args([])
    assert (args.steps, args.seq, args.batch, args.workers, args.method,
            args.mask_agg, args.obs_dir, args.device) == (
        300, 128, 16, 16, "cutoff", "weights", None, None)
    opts = {o for a in ap._actions for o in a.option_strings}
    assert opts == {"-h", "--help", "--steps", "--seq", "--batch",
                    "--workers", "--ckpt", "--method", "--mask-agg",
                    "--obs-dir", "--device"}
    cfg = cutoff_sgd.model_100m()
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.dtype) == (
        10, 640, 32_000, "float32")
