"""Train a ~100M-parameter LM with cutoff SGD, on one process or across
data-parallel ranks (the port of ``examples/train_cutoff_sgd.py``).

The production loop: synthetic tokens, the DMM-driven dynamic cutoff (or
full sync), masked gradient aggregation, async checkpoints, telemetry.
The options are the reference CLI's, plus ``--device``:

  PYTHONPATH=src python examples/torch_train_cutoff_sgd.py --steps 300
  PYTHONPATH=src torchrun --nproc-per-node 2 \\
      examples/torch_train_cutoff_sgd.py --device cpu --steps 4 --seq 16 \\
      --batch 8 --workers 4

Started plainly it is the one-process trainer.  Started by ``torchrun``
(``RANK`` and ``WORLD_SIZE`` set) each of the R processes joins one
process group (NCCL on the card, gloo with ``--device cpu``) and trains on
a ``("data",)`` mesh of R ranks, each holding ``--workers``/R workers and
their rows of every batch; rank 0 alone fits the runtime model, decides,
prints and writes the checkpoints.  On one card that is NCCL at world size
1: every collective still runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import optim, resolve_device
from repro_torch.cluster.simulator import ClusterSim
from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.core.controller import CutoffController, FullSyncController
from repro_torch.core.runtime_model.api import RuntimeModel
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.launch.train import Trainer, make_train_step
from repro_torch.models import model as M


def model_100m() -> ArchConfig:
    """~100M-parameter dense LM (qwen2-family structure), the reference
    CLI's model."""
    return dataclasses.replace(
        get_config("qwen2-0.5b"), name="repro-100m",
        n_layers=10, d_model=640, n_heads=10, n_kv_heads=2, head_dim=64,
        d_ff=1792, vocab_size=32_000, dtype="float32", tie_embeddings=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt_100m"))
    ap.add_argument("--method", default="cutoff",
                    choices=["cutoff", "sync"])
    ap.add_argument("--mask-agg", default="weights",
                    choices=["weights", "psum"],
                    help="how the bit array meets the gradients: folded "
                         "per-example weights (production) or the explicit "
                         "per-worker gradient combine")
    ap.add_argument("--obs-dir", default=None,
                    help="write obs telemetry (spans/steps/decisions/"
                         "metrics JSONL) under this directory; render "
                         "with: python -m repro_torch.obs <dir>")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the card")
    return ap


def _launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def train(args, *, cfg: ArchConfig = None, fit_steps: int = 300):
    """Run the CLI's training on this process; returns the Trainer.

    Joins the process group already initialized (``launch.ranks.spawn``),
    or starts one when ``torchrun`` launched this process; otherwise it is
    the one-process trainer.  ``cfg`` and ``fit_steps`` default to the
    reference CLI's (``model_100m()``, 300 fit steps).
    """
    owns_group = not dist.is_initialized() and _launched_by_torchrun()
    if owns_group:
        init_distributed(args.device)
    try:
        return _train(args, cfg or model_100m(), fit_steps)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(args, cfg, fit_steps):
    if dist.is_initialized():
        R = dist.get_world_size()
        mesh = make_mesh((R,), ("data",))
        device, rank = mesh.device, mesh.rank
        # pure data parallelism: every rank a replica, the workers split
        lay = shd.Layout(mesh=mesh, mode="train_fsdp", dp=("data",))
    else:
        R, rank, lay = 1, 0, shd.LOCAL
        device = resolve_device(args.device)
    if args.workers % R:
        raise ValueError(f"{args.workers} workers do not split over {R} "
                         f"ranks")
    lead = rank == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"model: {cfg.name} ({cfg.n_params() / 1e6:.0f}M params), {R} "
        f"rank(s) of {args.workers // R} workers on {device}")

    ctl = obs = None
    if lead:
        sim = ClusterSim(n_workers=args.workers, n_nodes=4, seed=0)
        trace = sim.run(200)
        if args.method == "cutoff":
            rm = RuntimeModel(n_workers=args.workers, lag=20,
                              device=device).init(0)
            t0 = time.time()
            rm.fit(trace, steps=fit_steps, batch=8)
            say(f"runtime model fitted in {time.time() - t0:.1f}s")
            ctl = CutoffController(rm, k_samples=48)
            ctl.seed_window(trace)
        else:
            ctl = FullSyncController(args.workers)
        if args.obs_dir:
            from repro_torch.obs import ObsRun
            obs = ObsRun(args.obs_dir)
            ctl = obs.wrap(ctl, policy=args.method)

    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=0)
    opt = optim.clip_by_global_norm(
        optim.adamw(optim.cosine_schedule(3e-4, 50, args.steps), fused=True),
        1.0)
    step = make_train_step(cfg, opt, mask_agg=args.mask_agg)
    tr = Trainer(step_fn=step, data=data, controller=ctl,
                 timer=(ClusterSim(n_workers=args.workers, n_nodes=4, seed=9)
                        if lead else None),
                 n_workers=args.workers, mask_agg=args.mask_agg,
                 ckpt_dir=args.ckpt, ckpt_every=100, obs=obs,
                 name=args.method)

    def init_fn():
        # the same seed on every rank: identical replicas
        params = M.init_model(cfg, torch.Generator().manual_seed(0),
                              device=device)
        return {"params": params, "opt": opt.init(params)}

    tr.restore_or_init(init_fn)
    t0 = time.time()
    with shd.use_layout(lay):
        hist = tr.run(args.steps, verbose=lead)
    dt = time.time() - t0

    cs = [h["c"] for h in hist]
    say(f"\n=== {args.method} ===")
    say(f"loss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    say(f"simulated cluster wall-clock: {tr.sim_clock:.1f}s "
        f"({tr.sim_clock / len(hist):.3f}s/step)")
    say(f"mean cutoff: {np.mean(cs):.1f}/{args.workers}")
    say(f"host compute time: {dt:.1f}s ({dt / args.steps:.2f}s/step)")
    if obs is not None:
        obs.close()
        say(f"obs streams -> {args.obs_dir} "
            f"(render: python -m repro_torch.obs {args.obs_dir})")
    return tr


def main(argv=None) -> int:
    train(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
