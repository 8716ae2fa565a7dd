"""Serving example on the PyTorch port: batched prefill + decode with a
KV cache.

The port's counterpart of ``examples/serve_decode.py``: decodes from three
architecture families (dense GQA, xLSTM matrix-memory, Hymba hybrid) to
show the cache machinery is uniform.  On the card prefill runs eagerly
through the Hopper kernels and the decode loop is one CUDA graph replay a
token (captured at the first request of its shape, so the time printed
includes the capture).  On the CPU the configs are the JAX example's
``.reduced()`` ones; on the card their head_dim of 16 and SSM state of 8
are widened to 64 and 16, the smallest widths the flash and mlstm_chunk
kernels take:

  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.models import model as M
from repro_torch.serving.engine import ServeEngine

ARCHS = ("qwen2-0.5b", "xlstm-350m", "hymba-1.5b")
#: the card's kernels' smallest widths (a no-op where an arch has no such
#: part)
KERNEL_WIDTHS = {"head_dim": 64, "ssm_state": 16}


def main(device=None):
    device = resolve_device(device)
    for name in ARCHS:
        cfg = get_config(name).reduced()
        if device.type == "cuda":
            cfg = dataclasses.replace(cfg, **KERNEL_WIDTHS)
        params = M.init_model(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        eng = ServeEngine(cfg, params, device=device)
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size, size=(4, 12),
                               dtype=np.int32)
        t0 = time.time()
        out = eng.generate(prompts, n_new=16, temperature=0.8, seed=1)
        dt = time.time() - t0
        print(f"{name:14s} batch=4 prompt=12 new=16 "
              f"({dt:.2f}s incl. capture)")
        print(f"   sample continuation ids: {out[0][:10].tolist()}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(ap.parse_args().device)
