"""Where train_hymba_parity's second-step gradient gap comes from.

``chip_smoke.py``'s train_hymba_parity (hymba-1.5b at full width and depth
2, f32, the psum step, W 2, seq 32 x batch 4, fused AdamW) holds the
first step's aggregated gradient, taken at identical parameters on both
devices, and the second step's, taken after one Adam step on each.  Adam's
first update moves every entry by about lr times the sign of its gradient,
so where a gradient sits at rounding noise the two devices may move it
opposite ways, and the second gradients are taken at parameters up to 2
lr apart.  This script separates the two causes.  It runs the same two
steps three times:

  * cpu:  both steps on the CPU (the parity's CPU side);
  * card: both steps on the card (the parity's card side);
  * x:    step 1 on the CPU, then the card's state after step 1 copied
          into that trainer, then step 2 on the CPU: the CPU's second
          gradient at the card's parameters.

and prints, per step, the largest leaf error over the leaf's largest
|gradient| for card / cpu (the parity's number), card / x (the same
parameters, CPU against card: the computation's own gap) and x / cpu (the
parameters' divergence alone), with the worst leaves.  Needs the card
(about 40 s):

    PYTHONPATH=src python3 scripts/torch_hymba_step2_grad.py
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_hymba_step2_grad: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.configs.base import get_config
    from repro_torch.core.controller import StaticCutoffController

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(8)
    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=2,
                              dtype="float32")
    # train_hymba_parity's init: drawn on the card, copied to the host
    p0 = cs.cast(cs.init_on_card(torch, cfg, torch.float32, cs.SEED + 20),
                 "cpu", torch.float32)
    torch.cuda.empty_cache()
    names = cs._leaf_names(p0)
    grads = {}

    def trainer(tag, device):
        grads[tag] = []
        # a copy each: the update is in place (a CPU cast is no copy)
        params = cs.cast(tree.map(torch.clone, p0), device, torch.float32)
        return cs._train_setup(
            torch, cfg, params, n_workers=2,
            seq=32, batch=4,
            controller=StaticCutoffController(2, cutoff=1),
            timer=ClusterSim(n_workers=2, n_nodes=2, seed=7),
            record=lambda g: grads[tag].append(
                [x.float().cpu() for x in tree.leaves(g)]))[0]

    trainer("cpu", "cpu").run(2)
    card = trainer("card", "cuda")
    card.run(1)
    after1 = tree.map(lambda x: x.detach().cpu().clone()
                      if isinstance(x, torch.Tensor) else x, card.state)
    card.run(1)
    x = trainer("x", "cpu")
    x.run(1)
    x.state = after1
    x.run(1)

    def compare(a, b, step):
        errs = []
        for name, u, w in zip(names, grads[a][step], grads[b][step]):
            scale = float(w.abs().max())
            errs.append((float((u - w).abs().max()) / max(scale, 1e-30),
                         name))
        errs.sort(reverse=True)
        return {"max": errs[0][0],
                "worst": [{"leaf": n, "scaled_err": e} for e, n in errs[:4]]}

    out = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": "float32",
           "device": torch.cuda.get_device_name(0)}
    for step in (0, 1):
        for a, b in (("card", "cpu"), ("card", "x"), ("x", "cpu")):
            out[f"step{step + 1}_{a}/{b}"] = compare(a, b, step)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
