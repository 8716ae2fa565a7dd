"""The paper's CNN: the card's f32 gradient against the CPU's, leaf by leaf.

Runs on the card.  At ``chip_smoke.py``'s cnn_parity inputs (batch 512 of
``SyntheticImages(seed=0, noise=0.9)``, ``cnn_init(0)``, the mean loss and
the cutoff-weighted one of 32 workers with every third cut) it prints one
JSON line per (run, loss): each leaf's max |difference| over the leaf's
max |value|, against the CPU in f32 and against the CPU in f64.  The runs:
the CPU in f32; the card in f32 (TF32 off) with cuDNN as it comes,
deterministic, benchmarked and off; and two lower-precision controls,
TF32 convolutions and bf16 autocast.

    PYTHONPATH=src python3 scripts/torch_cnn_grad_leaves.py
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

BATCH, WORKERS, SEED = 512, 32, 0


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.models import cnn as C

    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = SyntheticImages(seed=0, noise=0.9).batch(0, BATCH)
    bits = (np.arange(WORKERS) % 3 != 2).astype(np.float32)
    w = np.repeat(bits, BATCH // WORKERS)
    p0 = C.cnn_init(SEED, device="cpu")
    names = [f"{k}.{n}" for k, p in p0.items() for n in p]

    def grads(dev, dt=torch.float32, autocast=None):
        params = {k: {n: t.detach().to(dev, dt).requires_grad_(True)
                      for n, t in p.items()} for k, p in p0.items()}
        xx, yy, ww = (torch.from_numpy(a).to(dev) for a in (x, y, w))
        out = {}
        for kind, weights in (("mean", None), ("weighted", ww)):
            with torch.autocast("cuda", dtype=autocast or torch.bfloat16,
                                enabled=autocast is not None):
                loss = C.cnn_loss(params, xx.to(dt), yy, weights)
            g = torch.autograd.grad(
                loss, [t for p in params.values() for t in p.values()])
            out[kind] = [t.double().cpu() for t in g]
        return out

    def per_leaf(got, want):
        return {n: float((a - b).abs().max() / b.abs().max())
                for n, a, b in zip(names, got, want)}

    ref64, cpu32 = grads("cpu", torch.float64), grads("cpu")
    runs = {"cpu_f32": cpu32}
    for label, det, bench, enabled, tf32 in (
            ("card", False, False, True, False),
            ("card_cudnn_deterministic", True, False, True, False),
            ("card_cudnn_benchmark", False, True, True, False),
            ("card_cudnn_off", False, False, False, False),
            ("card_tf32_control", False, False, True, True)):
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench
        torch.backends.cudnn.enabled = enabled
        torch.backends.cudnn.allow_tf32 = tf32
        runs[label] = grads("cuda")
    torch.backends.cudnn.deterministic = torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32 = True, False
    runs["card_bf16_autocast_control"] = grads("cuda",
                                               autocast=torch.bfloat16)
    for label, r in runs.items():
        for kind in ("mean", "weighted"):
            vs32, vs64 = (per_leaf(r[kind], ref[kind])
                          for ref in (cpu32, ref64))
            print(json.dumps({"run": label, "loss": kind,
                              "max_vs_cpu_f32": max(vs32.values()),
                              "max_vs_cpu_f64": max(vs64.values()),
                              "vs_cpu_f32": vs32, "vs_cpu_f64": vs64}),
                  flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
