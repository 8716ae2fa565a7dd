"""Quickstart on the PyTorch port: cutoff SGD end to end (paper Alg. 1).

The port's counterpart of ``examples/quickstart.py``, with the same steps:
a reduced qwen2-0.5b on synthetic tokens with 8 simulated workers; the DMM
runtime model predicts each step's joint worker runtimes, the controller
picks the throughput-optimal cutoff, stragglers' gradients are masked out
of the aggregation, and censored runtimes are imputed.  It runs on the
card (flash attention and the fused AdamW through their Hopper kernels,
the controller's decision as a CUDA graph).  The reduced config keeps
qwen2-0.5b's own head_dim of 64, the smallest the flash kernel is built
for (the JAX quickstart's reduced config has 16):

  PYTHONPATH=src python examples/torch_quickstart.py

``main(device="cpu")`` runs the same steps on the CPU, through the
kernels' plain versions.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import optim, resolve_device
from repro_torch.cluster.simulator import ClusterSim
from repro_torch.configs.base import get_config
from repro_torch.core.controller import CutoffController
from repro_torch.core.runtime_model.api import RuntimeModel
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.train import Trainer, make_train_step
from repro_torch.models import model as M


def main(device=None, fit_steps: int = 200, train_steps: int = 60):
    device = resolve_device(device)
    n_workers = 8
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              head_dim=64)

    # 1. instrument the cluster once, fit the runtime model (paper §3.1)
    sim = ClusterSim(n_workers=n_workers, n_nodes=2, seed=0)
    trace = sim.run(200)
    print(f"recorded trace: mean={trace.mean():.3f}s std={trace.std():.3f}s")
    rm = RuntimeModel(n_workers=n_workers, lag=20, device=device).init(0)
    rm.fit(trace, steps=fit_steps, batch=8, verbose=True)

    # 2. dynamic-cutoff controller (paper Alg. 1)
    ctl = CutoffController(rm, k_samples=48)
    ctl.seed_window(trace)

    # 3. train with masked gradient aggregation
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=16, seed=0)
    opt = optim.adamw(optim.cosine_schedule(3e-3, 10, 200), fused=True)
    step = make_train_step(cfg, opt)
    tr = Trainer(step_fn=step, data=data, controller=ctl,
                 timer=ClusterSim(n_workers=n_workers, n_nodes=2, seed=7),
                 n_workers=n_workers)

    def init_fn():
        params = M.init_model(cfg, torch.Generator().manual_seed(0),
                              device=device)
        return {"params": params, "opt": opt.init(params)}

    tr.restore_or_init(init_fn)
    hist = tr.run(train_steps, verbose=True)

    cs = [h["c"] for h in hist]
    print(f"\nloss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    print(f"cutoffs: min={min(cs)} max={max(cs)} mean={np.mean(cs):.1f} "
          f"of {n_workers} workers")
    print(f"simulated wall-clock: {tr.sim_clock:.1f}s "
          f"(full sync would have paid the max worker every step)")
    return hist


if __name__ == "__main__":
    main()
