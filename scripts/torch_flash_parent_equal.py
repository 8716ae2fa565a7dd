"""The flash kernel given no device length, against an earlier build of its
source, bit for bit, on every ``chip_smoke.FLASH_CASES`` row (card only).

    PYTHONPATH=src python3 scripts/torch_flash_parent_equal.py --parent DIR

``DIR`` is a checkout of the commit to hold the kernel to (its
``src/repro_torch/kernels/csrc``): its flash source is built with the same
nvcc flags into ``build/parent_flash/`` and called through the wrapper of
this checkout, with the launch's length argument dropped (the earlier C
interface has none).  Each case's inputs are drawn as chip_smoke's flash
phase draws them; the two outputs must be equal bit for bit.  Prints one
JSON line a case and a summary; exits 1 on any difference.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", mod)   # its dataclass looks it up
    spec.loader.exec_module(mod)
    return mod


def _parent_fn(parent: Path):
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA

    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    out_dir = REPO / "build" / "parent_flash"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libflash_attention_parent.so"
    cmd = [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "--split-compile=0", "-Xcompiler", "-fPIC", "-o", str(lib),
           str(csrc / "flash_attention.cu")]
    subprocess.run(cmd, check=True)
    fn = ctypes.CDLL(str(lib)).flash_attention_fwd
    fn.argtypes = FA._ARGTYPES[:-2] + FA._ARGTYPES[-1:]   # no length
    fn.restype = ctypes.c_int

    def call(*args):
        if args[-2] is not None:
            raise ValueError("the earlier kernel takes no device length")
        return fn(*args[:-2], args[-1])

    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import flash_attention as FA

    cs = _chip_smoke()
    parent = _parent_fn(args.parent)
    ours = FA._kernel_fn()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    diffs = []
    for c in cs.FLASH_CASES:
        dt = getattr(torch, c.dtype)

        def rand(*shape):
            flat = torch.randn(math.prod(shape) + c.offset, generator=gen,
                               device="cuda")
            return flat.to(dt)[c.offset:].view(shape)

        q = rand(c.B, c.Sq, c.H, c.hd)
        if c.cache:
            k = rand(c.B, c.cache, c.KV, c.hd)[:, :c.Sk]
            v = rand(c.B, c.cache, c.KV, c.hd)[:, :c.Sk]
        else:
            k, v = (rand(c.B, c.Sk, c.KV, c.hd),
                    rand(c.B, c.Sk, c.KV, c.hd))
        out = {}
        for side, fn in (("ours", ours), ("parent", parent)):
            FA._kernel_fn = _fixed(fn)
            out[side] = FA.flash_attention(q, k, v, causal=c.causal,
                                           window=c.window)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out["ours"], out["parent"]))
        if not equal:
            diffs.append(c.name)
        print(json.dumps({"case": c.name, "bit_equal": equal,
                          "max_abs_diff": (out["ours"].float()
                                           - out["parent"].float()
                                           ).abs().max().item()}),
              flush=True)
    print(json.dumps({"flash_parent_equal": not diffs,
                      "cases": len(cs.FLASH_CASES), "differ": diffs}),
          flush=True)
    return 1 if diffs else 0


def _fixed(fn):
    """A stand-in for the wrapper's loader that returns ``fn``."""
    return lambda: fn


if __name__ == "__main__":
    sys.exit(main())
