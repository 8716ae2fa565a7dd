"""The masked_grad_agg kernel's mean mode against an earlier build of its
source, bit for bit (card only).

    PYTHONPATH=src python3 scripts/torch_agg_parent_equal.py --parent DIR

``DIR`` is a checkout of the commit to hold the kernel to (its
``src/repro_torch/kernels/csrc``): its ``masked_grad_agg.cu`` is built
with the same nvcc flags into ``build/parent_agg/`` and called through its
own C interface (the earlier one has no mode argument).  The cases are
chip_smoke's masked_grad_agg grid (W 2, 8, 158 by N 1, 1000, 2^20, f32
and bf16, 0/1, fractional and all-zero masks), each also with rows off
the 4-wide alignment (the scalar path), and the train step's (8,
494,032,768) f32 buffer; the two outputs must be equal bit for bit.
Prints one JSON line a shape and a summary; exits 1 on any difference.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
CASES_W = (2, 8, 158)
CASES_N = (1, 1000, 1 << 20)
FULL = (8, 494_032_768)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _parent_fn(parent: Path):
    from repro_torch.kernels import build

    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    out_dir = REPO / "build" / "parent_agg"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libmasked_grad_agg_parent.so"
    cmd = [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "--split-compile=0", "-Xcompiler", "-fPIC", "-o", str(lib),
           str(csrc / "masked_grad_agg.cu")]
    subprocess.run(cmd, check=True)
    fn = ctypes.CDLL(str(lib)).masked_grad_agg
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _parent_call(fn, g, mask):
    W, N = g.shape
    out = torch.empty(N, dtype=g.dtype, device=g.device)
    pitch = g.stride(0) if W > 1 else N
    elt = g.element_size()
    vector = (g.data_ptr() % (4 * elt) == 0 and pitch % 4 == 0
              and out.data_ptr() % (4 * elt) == 0)
    err = fn(g.data_ptr(), mask.data_ptr(), out.data_ptr(),
             _DTYPE_CODE[g.dtype], W, N, pitch, int(vector),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent kernel: code {err}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels.masked_grad_agg import masked_grad_agg

    parent = _parent_fn(args.parent)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(dt, W, N, off) for dt in (torch.float32, torch.bfloat16)
              for W in CASES_W for N in CASES_N for off in (0, 1)]
    shapes.append((torch.float32, *FULL, 0))
    diffs, checked = [], 0
    for dt, W, N, off in shapes:
        # off = 1: each row starts one element past a 4-wide boundary
        pitch = N + off
        flat = torch.randn(W * pitch + off, generator=gen, device="cuda")
        g = flat.to(dt)[off:].view(W, pitch)[:, :N] if off else \
            flat.to(dt).view(W, N)
        masks = {"bits": (torch.arange(W, device="cuda") % 3 != 0).float(),
                 "fractional": torch.rand(W, generator=gen, device="cuda"),
                 "zero": torch.zeros(W, device="cuda")}
        equal = True
        for name, mask in masks.items():
            ours = masked_grad_agg(g, mask)
            theirs = _parent_call(parent, g, mask)
            torch.cuda.synchronize()
            same = bool(torch.equal(ours, theirs))
            equal &= same
            checked += 1
            if not same:
                diffs.append(f"{W}x{N} {dt} off {off} {name}")
        print(json.dumps({"W": W, "N": N, "dtype": str(dt), "offset": off,
                          "bit_equal": equal}), flush=True)
        del flat, g
        torch.cuda.empty_cache()
    print(json.dumps({"agg_parent_equal": not diffs, "calls": checked,
                      "differ": diffs}), flush=True)
    return 1 if diffs else 0


if __name__ == "__main__":
    sys.exit(main())
