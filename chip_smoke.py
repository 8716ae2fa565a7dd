#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

  build          nvcc-builds every kernel under src/repro_torch/kernels/csrc
  kernels        lists the ported kernels
  flash_attention
                 the kernel against its plain version on the card, per case:
                 max error, kernel / plain / SDPA ms, and the least time the
                 card could take (bytes or operations, whichever bounds)
  serve          full-width qwen2-0.5b (bf16, seeded init) through
                 ServeEngine.generate: 4 prompts x 128 tokens, 32 greedy new
                 tokens; asserts the flash kernel launched 24 x (1 + 32) times
  serve_profile  the device's busy share of a short request (torch.profiler)
  serve_parity   the same seeded weights in f32, served on the CPU (plain
                 path) and on the card (kernel): logits and ids must agree

Then a ``{"kernels": [...]}`` summary line, the card's name and power limit
from nvidia-smi, and ``{"ok": true, "device": {...}}`` as the last line.
Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,       # dense tensor-core bf16
            "float32": 67e12}         # f32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # tests/test_kernels.py
PARITY_LOGIT_ATOL = 1e-3   # f32, 24 layers, sums in another order per device
SEED = 0

# (name, B, Sq, Sk, H, KV, hd, dtype, causal, window, cache_len)
FLASH_CASES = [
    ("prefill_s128", 4, 128, 128, 14, 2, 64, "bfloat16", True, 0, 0),
    ("prefill_s512", 4, 512, 512, 14, 2, 64, "bfloat16", True, 0, 0),
    ("ragged_s100", 4, 100, 100, 14, 2, 64, "bfloat16", True, 0, 0),
    ("sq16_sk144", 4, 16, 144, 14, 2, 64, "bfloat16", True, 0, 0),
    ("decode_pos131", 4, 1, 132, 14, 2, 64, "bfloat16", True, 0, 160),
    ("window128_s512", 4, 512, 512, 14, 2, 64, "bfloat16", True, 128, 0),
    ("f32_s256", 2, 256, 256, 14, 2, 64, "float32", True, 0, 0),
    ("hd128_s256", 2, 256, 256, 8, 2, 128, "bfloat16", True, 0, 0),
]
HEADLINE_CASE = "prefill_s128"   # the serve prompt's shape


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def eager_ms(torch, fn, reps=20, warmup=3):
    """Time per call of back-to-back eager calls: the host's launch cost
    included, as a caller sees it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, side, reps=20):
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so no host launch cost sits between the kernels.  ``side`` is
    the capture stream, one for every timing (each new stream would keep
    a cuBLAS workspace of its own)."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):   # warm-up off the capture: allocator, handles
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def valid_pairs(Sq, Sk, causal, window):
    """(query, key) pairs the masks leave, per (batch, head)."""
    n = 0
    for i in range(Sq):
        qpos = i + Sk - Sq
        hi = min(Sk - 1, qpos) if causal else Sk - 1
        lo = max(0, qpos - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    info = build.build_all()
    wall = time.perf_counter() - t0
    per = {}
    for name, rec in info.items():
        ptxas = [ln.strip() for ln in rec["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        per[name] = {"seconds": rec["seconds"], "ptxas": ptxas}
    emit("build", seconds=wall, kernels=per)
    emit("kernels", names=sorted(build.SOURCES))


def phase_flash(torch):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import reference_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    side = torch.cuda.Stream()
    results = {}
    for (name, B, Sq, Sk, H, KV, hd, dtname, causal, window,
         cache_len) in FLASH_CASES:
        dt = getattr(torch, dtname)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        q = rand(B, Sq, H, hd)
        if cache_len:   # decode: a view of the first Sk slots of a cache
            k = rand(B, cache_len, KV, hd)[:, :Sk]
            v = rand(B, cache_len, KV, hd)[:, :Sk]
        else:
            k, v = rand(B, Sk, KV, hd), rand(B, Sk, KV, hd)
        out = flash_attention(q, k, v, causal=causal, window=window)
        want = reference_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(out.shape == want.shape and out.dtype == q.dtype,
              f"{name}: output {tuple(out.shape)} {out.dtype}")
        err = (out.float() - want.float()).abs().max().item()
        check(err <= TOL[dtname], f"{name}: max error {err} > {TOL[dtname]}")

        qpos = torch.arange(Sq, device="cuda") + (Sk - Sq)
        kpos = torch.arange(Sk, device="cuda")
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device="cuda")
        if causal:
            mask &= kpos[None] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None] > qpos[:, None] - window
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

        lib_err = (sdpa().transpose(1, 2).float() - want.float()
                   ).abs().max().item()

        def kern():
            return flash_attention(q, k, v, causal=causal, window=window)

        def plain():
            return reference_attention(q, k, v, causal=causal, window=window)

        times = {}
        for label, fn in (("ms", kern), ("plain_ms", plain),
                          ("library_ms", sdpa)):
            times[label] = device_ms(torch, fn, side)
            times["eager_" + label] = eager_ms(torch, fn)

        elt = q.element_size()
        nbytes = elt * (2 * q.numel() + 2 * B * Sk * KV * hd)
        ops = 4 * B * H * hd * valid_pairs(Sq, Sk, causal, window)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[dtname] * 1e3
        rec = {"case": name, "shape": [B, Sq, Sk, H, KV, hd], "dtype": dtname,
               "causal": causal, "window": window, "max_abs_err": err,
               "tol": TOL[dtname], **times, "library_err": lib_err,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        results[name] = rec
        emit("flash_attention", **rec)
    return results


def init_weights(torch, cfg):
    from repro_torch.models import model as M

    g = torch.Generator().manual_seed(SEED)
    return M.init_model(cfg, g, device="cpu", dtype=torch.float32)


def cast(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: cast(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype)


def phase_serve(torch, cfg, params_f32):
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    B, S, n_new = 4, 128, 32
    params = cast(params_f32, "cuda", torch.bfloat16)
    engine = ServeEngine(cfg, params, max_len=S + n_new)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    engine.generate(prompts, 2)   # warm-up: cuBLAS handles, allocator

    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    ids = engine.generate(prompts, n_new)       # ends in one .cpu() copy
    gen_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    want = cfg.n_layers * (1 + n_new)
    check(launches.get("flash_attention", 0) == want,
          f"flash_attention launched {launches} times, want {want}")
    check(ids.shape == (B, n_new) and ids.dtype == np.int32,
          f"ids {ids.shape} {ids.dtype}")
    check(bool(np.all((ids >= 0) & (ids < cfg.vocab_size))),
          "ids out of vocabulary range")
    peak = torch.cuda.max_memory_allocated()

    toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    batch = {"tokens": toks,
             "positions": torch.arange(S, device="cuda").expand(B, S)}
    with torch.inference_mode():
        prefill_ms = eager_ms(torch, lambda: M.prefill(cfg, engine.params,
                                                       batch), reps=5)
    gen_ms = gen_s * 1e3

    emit("serve", arch=cfg.name, dtype="bfloat16", batch=B, prompt=S,
         n_new=n_new, flash_launches=launches.get("flash_attention", 0),
         generate_ms=gen_ms, prefill_ms=prefill_ms,
         decode_ms_per_token=(gen_ms - prefill_ms) / n_new,
         tokens_per_s=B * n_new / gen_s, max_memory_allocated=peak,
         first_ids=ids[0, :8].tolist())

    # device busy share of a short request: kernel time from the profiler
    # against the same request's unprofiled wall time
    from torch.profiler import ProfilerActivity, profile

    n_prof = 8
    t0 = time.perf_counter()
    engine.generate(prompts, n_prof)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts, n_prof)
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    emit("serve_profile", n_new=n_prof, wall_ms=wall_ms, device_ms=dev_ms,
         device_busy_share=dev_ms / wall_ms,
         device_events=sum(e.count for e in dev),
         top=[{"kernel": e.key[:100], "count": e.count,
               "device_ms": e.self_device_time_total / 1e3}
              for e in top[:8]])
    return launches


def phase_parity(torch, cfg, params_f32):
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    S, n_new = 64, 8
    prompt = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, size=(1, S), dtype=np.int32)
    cpu = ServeEngine(cfg, params_f32, max_len=S + n_new, device="cpu")
    gpu = ServeEngine(cfg, cast(params_f32, "cuda", torch.float32),
                      max_len=S + n_new)
    logits = {}
    for name, eng in (("cpu", cpu), ("cuda", gpu)):
        toks = torch.as_tensor(prompt, dtype=torch.int64, device=eng.device)
        batch = {"tokens": toks,
                 "positions": torch.arange(S, device=eng.device)[None]}
        with torch.inference_mode():
            logits[name] = M.prefill(cfg, eng.params, batch)[0].float().cpu()
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    ids_cpu = cpu.generate(prompt, n_new)
    ids_gpu = gpu.generate(prompt, n_new)
    same = bool(np.array_equal(ids_cpu, ids_gpu))
    top2 = torch.topk(logits["cpu"][0], 2).values
    rec = {"dtype": "float32", "prompt": S, "n_new": n_new,
           "logits_max_abs_err": err, "tol": PARITY_LOGIT_ATOL,
           "ids_equal": same, "ids_cpu": ids_cpu[0].tolist(),
           "ids_cuda": ids_gpu[0].tolist(),
           "first_logit_gap": (top2[0] - top2[1]).item()}
    emit("serve_parity", **rec)
    check(err <= PARITY_LOGIT_ATOL,
          f"prefill logits differ by {err} > {PARITY_LOGIT_ATOL}")
    check(same, "greedy ids differ between the CPU and the card")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(8)

    phase_build()
    flash = phase_flash(torch)
    cfg = get_config("qwen2-0.5b")
    params_f32 = init_weights(torch, cfg)
    launches = phase_serve(torch, cfg, params_f32)
    phase_parity(torch, cfg, params_f32)

    head = flash[HEADLINE_CASE]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:93",
        "launches": launches.get("flash_attention", 0),
        "max_abs_err": max(r["max_abs_err"] for r in flash.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "case": HEADLINE_CASE}]}),
        flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
