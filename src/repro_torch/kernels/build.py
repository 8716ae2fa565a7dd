"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), named by a hash
of its text and of every header under ``csrc/`` (``*.cuh``, which a source
may include), so a stale library is never loaded:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         --split-compile=0 -Xcompiler -fPIC -Xptxas -v \
         -o build/kernels/lib<name>-<hash>.so

No source builds TMA descriptors (the flash kernel fills its shared-memory
ring with cp.async), so nothing links libcuda (``-lcuda``).
``--split-compile=0`` lets nvcc optimize a source's kernels on every core
at once; the flash-attention source, with its unrolled head-dim
instances, builds in about half the time.

The libraries go to ``build/kernels/`` at the root of the checkout, at
first use.  ``build_all`` starts one nvcc per source, all at once.
``LAUNCHES`` counts kernel launches by name: each wrapper adds one where it
launches its kernel and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

#: kernel name -> its source under csrc/
SOURCES = {"flash_attention": "flash_attention.cu",
           "masked_grad_agg": "masked_grad_agg.cu",
           "fused_adam": "fused_adam.cu",
           "mlstm_chunk": "mlstm_chunk.cu"}

#: kernel name -> launches since the last ``LAUNCHES.clear()``
LAUNCHES: collections.Counter = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}
#: kernel name -> {"seconds": build time, "log": nvcc/ptxas output}
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path) -> list:
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "--split-compile=0", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(CSRC / SOURCES[name])]


def build_all(names=None) -> Dict[str, dict]:
    """Compile every named source that has no library yet, one nvcc each,
    all started together.  Raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "cached"})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # publish whole, never a half-written library
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {n: BUILD_INFO[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
