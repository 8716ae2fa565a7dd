"""The MoE train loss's gradient leaf by leaf: the card against the CPU,
beside the CPU against itself with its sums in another order.

deepseek-moe-16b at full width and depth 2 (the dense first layer and one
MoE layer), f32, ``train_loss`` (aux_coef 0.01) on one worker's batch of
``chip_smoke.py``'s train_moe_parity (2 rows of seq 32, the same seed and
init).  For every leaf, the largest |difference| over the leaf's largest
|gradient| for three pairs:

  * card / cpu8: the card against the CPU at 8 threads (the parity's gap);
  * cpu1 / cpu8: the CPU at 1 thread against 8 (the same arithmetic, its
    sums in another order: the leaf's own f32 rounding floor);
  * card / cpu1.

Prints one JSON line with the worst leaves of each pair.  Needs the card
(about 40 s):

    PYTHONPATH=src python3 scripts/torch_moe_grad_leaves.py
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SEED = 0   # chip_smoke.py's; train_moe_parity inits from SEED + 14


def _names(node, pre=""):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _names(node[k], f"{pre}/{k}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _names(v, f"{pre}/{i}")
    else:
        yield pre


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_moe_grad_leaves: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=2,
                              dtype="float32")
    # train_moe_parity's init: drawn on the card, copied to the host
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    params = tree.map(lambda x: x.cpu(), M.init_model(
        cfg, gen, device="cuda", dtype=torch.float32))
    torch.cuda.empty_cache()
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=4, seed=SEED).batch(0)
    batch = {k: torch.as_tensor(v[:2]) for k, v in data.items()}

    def grads(device, threads=8):
        torch.set_num_threads(threads)
        flat = [x.to(device).requires_grad_(True)
                for x in tree.leaves(params)]
        b = {k: v.to(device) for k, v in batch.items()}
        loss, m = M.train_loss(cfg, tree.unflatten(params, flat), b)
        g = torch.autograd.grad(loss, flat)
        return [x.cpu() for x in g], loss.item(), m["aux"].item()

    runs = {"cpu8": grads("cpu", 8), "cpu1": grads("cpu", 1),
            "card": grads("cuda")}
    torch.set_num_threads(8)
    names = list(_names(params))
    out = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": "float32",
           "loss": {k: v[1] for k, v in runs.items()},
           "aux": {k: v[2] for k, v in runs.items()},
           "device": torch.cuda.get_device_name(0)}
    for a, b in (("card", "cpu8"), ("cpu1", "cpu8"), ("card", "cpu1")):
        errs = []
        for name, x, y in zip(names, runs[a][0], runs[b][0]):
            scale = float(y.abs().max())
            errs.append((float((x - y).abs().max()) / max(scale, 1e-30),
                         name, scale))
        errs.sort(reverse=True)
        out[f"{a}/{b}"] = [{"leaf": n, "scaled_err": e, "scale": s}
                           for e, n, s in errs[:6]]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
