"""Where a training parity's second-step gradient gap comes from.

``chip_smoke.py``'s train_hymba_parity (hymba-1.5b at full width and depth
2, f32, the psum step, W 2, seq 32 x batch 4, fused AdamW) and
train_xlstm_parity (xlstm-350m at full width, one mLSTM and one sLSTM
block, f32, W 4, seq 32 x batch 8) hold the first step's aggregated
gradient, taken at identical parameters on both devices, and the second
step's, taken after one Adam step on each.  Adam's
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
parameters' divergence alone), with the worst leaves.  ``--embed-first``
(xlstm-350m) draws the seed's weights with the embedding before the
layers, an order ``init_model`` once had: other weights of the same
distribution.  Needs the card (about 40 s an arch):

    PYTHONPATH=src python3 scripts/torch_step2_grad.py --arch hymba-1.5b
    PYTHONPATH=src python3 scripts/torch_step2_grad.py --arch xlstm-350m \
        [--embed-first]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def embed_first(M, cfg, seed):
    """``init_model``'s CPU weights for ``seed`` with the embedding drawn
    before the layers, then the layers, then the head.  The layers are
    ``init_model``'s at vocab 0, whose empty tables take no draw."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32) * std

    table = normal((cfg.vocab_size, cfg.d_model), 0.02)
    p = M.init_model(dataclasses.replace(cfg, vocab_size=0), gen,
                     device="cpu", dtype=torch.float32)
    p["embed"]["table"] = table
    if "lm_head" in p:
        p["lm_head"]["w"] = normal((cfg.d_model, cfg.vocab_size),
                                   1.0 / math.sqrt(cfg.d_model))
    return p


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=("hymba-1.5b", "xlstm-350m"),
                    required=True)
    ap.add_argument("--embed-first", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step2_grad: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.configs.base import get_config
    from repro_torch.core.controller import StaticCutoffController
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(8)
    if args.arch == "hymba-1.5b":
        cfg = dataclasses.replace(get_config(args.arch), n_layers=2,
                                  dtype="float32")
        W, B, cutoff = 2, 4, 1
        # train_hymba_parity's init: drawn on the card, copied to the host
        p0 = cs.cast(cs.init_on_card(torch, cfg, torch.float32,
                                     cs.SEED + 20), "cpu", torch.float32)
        torch.cuda.empty_cache()
    else:   # train_xlstm_parity's config and CPU init
        cfg = dataclasses.replace(get_config(args.arch), n_layers=2,
                                  slstm_every=2, dtype="float32")
        W, B, cutoff = 4, 8, 3
        p0 = (embed_first(M, cfg, cs.SEED + 9) if args.embed_first else
              M.init_model(cfg, torch.Generator().manual_seed(cs.SEED + 9),
                           device="cpu", dtype=torch.float32))
    names = cs._leaf_names(p0)
    grads = {}

    def trainer(tag, device):
        grads[tag] = []
        # a copy each: the update is in place (a CPU cast is no copy)
        params = cs.cast(tree.map(torch.clone, p0), device, torch.float32)
        return cs._train_setup(
            torch, cfg, params, n_workers=W,
            seq=32, batch=B,
            controller=StaticCutoffController(W, cutoff=cutoff),
            timer=ClusterSim(n_workers=W, n_nodes=2, seed=7),
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
           "embed_first": args.embed_first,
           "device": torch.cuda.get_device_name(0)}
    for step in (0, 1):
        for a, b in (("card", "cpu"), ("card", "x"), ("x", "cpu")):
            out[f"step{step + 1}_{a}/{b}"] = compare(a, b, step)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
