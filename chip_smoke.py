#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

  build          nvcc-builds every kernel under src/repro_torch/kernels/csrc
  kernels        lists the ported kernels
  flash_attention
                 the kernel against its plain version on the card, per case:
                 max error, kernel / plain / SDPA ms, and the least time the
                 card could take (bytes or operations, whichever bounds),
                 the kernel's path (wgmma, split_kv or simt; each case
                 asserts the path it must take), its splits and the CUDA
                 kernels one call makes (torch.profiler over 5 calls,
                 asserted against the path's).  Cases: the serve prefill
                 (B 4, S 128), S 512, ragged S 100, Sq 16 over Sk 144, a
                 window of 128, f32, hd 128, the train forward per worker
                 (B 2, 3 and 6, S 128), decode at the serve's positions 131
                 and 159
                 and over a 4096-slot cache, the f32 parity decode, bf16
                 inputs off 16-byte alignment, decode over 48 keys (one
                 split), Sq 4 over Sk 200 (two 16-row tiles) and decode at
                 hd 128
  mlstm_chunk    the kernel against its plain version (the chunked
                 linear_recurrence) and the sequential oracle on the card,
                 for y and for a decode step taken from the returned state:
                 xlstm-350m's serve shape (B 4, S 128, H 4, hd 512, bf16),
                 ragged S 100, S 300, S 1, f32, hd 16/32/64 and extreme
                 gates; each case asserts its path (wgmma or simt) and the
                 CUDA kernels a call makes (5 profiled calls); kernel /
                 plain ms, the bound (bytes, or operations in the Pallas
                 kernel's chunks over the tensor cores' rates) and the
                 f32-FMA floor of the same count
  serve          full-width qwen2-0.5b (bf16, seeded init) through
                 ServeEngine.generate: 4 prompts x 128 tokens, 32 greedy new
                 tokens; asserts the flash kernel launched 24 x (1 + 32) times
  serve_profile  the device's busy share of a short request (torch.profiler)
  serve_parity   the same seeded weights in f32, served on the CPU (plain
                 path) and on the card (kernel): logits and ids must agree
  masked_grad_agg
                 the kernel against its plain version: W in {2, 8, 158} x
                 N in {1, 1000, 2^20}, f32 and bf16, 0/1, fractional and
                 all-zero masks, W at the kernel's worker limit (and one
                 more, which must raise), plus the full-width
                 (8, 494,032,768) f32 buffer; kernel / plain / library
                 ((mask @ g) / c) / bound ms
  fused_adam     the kernel against reference_adam at steps 1 and 100, wd 0
                 and 0.01, bf16 and f32 p (f32 m/v), on every distinct layer
                 shape plus ragged and unaligned leaves; then one checked
                 step over the 290 full-width leaves (bf16 p), timed:
                 kernel / plain / library (torch AdamW fused=True) / bound ms
  train          full-width qwen2-0.5b cutoff SGD (bf16, seeded init):
                 SyntheticTokens(seq 128, batch 16), 8 workers,
                 FirstKController(8, backup=2), ClusterSim(8, 2 nodes, seed
                 7), adamw(cosine_schedule(3e-4, 2, 20), fused=True), 5
                 psum steps then 1 weights step; asserts the launch counts
                 of every step and finite losses, and counts the optimizer's
                 leaf-table uploads per step
  train_profile  the device's busy share of one more psum step
  train_parity   the same psum step at full width and 2 layers, f32, W = 4,
                 2 steps, on the CPU (plain versions) and on the card
                 (kernels): loss, aggregated gradient, m, v and p
  dmm_twin       the jax.random twin on the card against the CPU at the
                 controller's shapes: split, fold_in, uniform and
                 categorical bits equal, normals within rtol 1e-6
  dmm_fit        RuntimeModel(158, lag 20), the same init on the CPU and
                 the card, 60 ELBO steps at batch 8 on paper_cluster_158:
                 the loss trajectories agree within 2e-3 of their scale
  dmm_parity     CutoffController(k_samples=32, seed=0, device backend) on
                 the card against the numpy backend over 100
                 paper_cluster_158(seed=7) steps: identical cutoffs, window
                 rows within 2e-3, >= 50 censored steps, > 1 cutoff, one
                 graph a mode and one replay a decision
  dmm_timing     n = 8 and 158, K = 64: device µs of one decision (graph
                 replay), wall µs of observe and of predict_cutoff, the
                 CUDA kernels of one replay, the graphs captured
  train_dmm      the train phase's full-width psum setup driven by
                 CutoffController(k_samples=48) on a DMM fitted on the card
                 (ClusterSim(8, 2 nodes, seed 0), 200 steps): 5 steps, each
                 asserting the launch counts, a finite loss and one graph
                 replay a decision; prints c, the clock (and the first-k
                 clock of train), wall ms, predict_cutoff µs and the
                 decision's device µs; then 6 more steps alternating
                 first-k and the DMM, wall ms each (train_dmm_ab)
  obs            telemetry (repro_torch.obs) on the paths above, each held
                 against its bare twin: train_dmm's setup and model for 6
                 steps drained every 3, bare, with an ObsRun writing its
                 streams and with a synchronous peek at every decision:
                 losses and cutoffs equal, every decision scored from its
                 own samples (pred_iter equal to the peek's), the
                 synchronizing calls between drains (sync debug mode
                 "warn") equal, the launches asserted; PSServer J = 3 (K
                 16, train_dmm's model) on against off, then the host µs
                 of ps.flush and ps.dispatch (its wait and launch) at J =
                 1, 3, 8 (K 64), idle and beside looped controllers; the
                 supervised storm on against off and supervisor.tick's
                 µs; a short full-width request served on against off;
                 step wall bare against obs (supervised's small config and
                 full width), ring push, drain and span µs; the streams
                 rendered by python -m repro_torch.obs (and --chrome)
  train_policies the same full-width psum setup under the other straggler
                 policies, reusing train_dmm's fitted model: stale reuse
                 (StaleReuseController over the DMM, decay 0.5, 5 steps
                 with 2 masked_grad_agg launches each) checkpointed at
                 step 2 (seconds and bytes of the save and the restore;
                 ~6 GB in the temporary directory, checked free first);
                 a fresh trainer resumed from it bit-equal to the
                 uninterrupted run over 2 steps; decay 0 bit-equal to
                 discard from the same checkpoint; Elfving (a cut after
                 its warm-up); anytime (n_micro 2, grad_accum 2, a
                 fractional contribution); int8 error-feedback
                 compression (the residual within half a quantization
                 step); launches asserted every step, peak memory
  elastic_capture
                 RuntimeModel(8, lag 10) fitted on the card on
                 paper_cluster_158(0, 8).run(120), 150 steps; then a
                 width-8 refit of 60 steps through _spawn_refit (on a
                 thread and a stream of its own) while the main thread
                 builds a CutoffController and makes 5 decisions (graph
                 captures, then replays): no capture error, the cutoffs of
                 the same decisions with no fit running, the loss
                 trajectory of the same fit alone (within 2e-3 of its
                 scale; bit-equality reported); both walls
  train_elastic  the full-width psum setup (batch 24: divisible by 8 and
                 6) through an 8 -> 6 -> 8 churn under ElasticController
                 (k_samples 32, refit_steps 60, refit_fresh 3,
                 fallback_warmup 2, refit_async) on that model:
                 ChurnSim(paper_cluster_158(1, 8)) kills workers 6 and 7 at
                 step 6 and restores them after a gap sized from the
                 refit's measured wall; each step asserts the launches at
                 its width (flash 24 x W), a finite loss and 1 <= c <= n
                 and prints n, c, mode, whether a refit was in flight and
                 wall ms; at each width the fallback decides, then the
                 refitted DMM, before the next event; a checkpoint at step
                 12 (width 6, ~4.94 GB under TMPDIR, checked free first)
                 restored by a fresh trainer built at width 8: width 6,
                 members 0..5, the window warm; 2 steps; masked_grad_agg
                 timed on the trainer's own (6, N) buffer; refit seconds,
                 memory by width, the first step after each resize, the
                 median step with and without a refit in flight
  ps_parity      the multi-tenant server (repro_torch.ps.PSServer): J = 3
                 jobs of widths 16/10/6 (DMMs fitted on the card, K 16) in
                 one bucket over 100 paper_cluster_158 ticks: identical
                 cutoffs from the card's server, three looped device
                 CutoffControllers and the server on the CPU, flush() == 1
                 every tick, >= 50 censored observations, windows within
                 1e-4 (the reference's server bar), 2 graphs captured and
                 101 replays; then J = 1 at n = 158 against the card's own
                 controller (identical cutoffs, windows within 1e-4)
  ps_timing      J in {1, 3, 8} at n = 8 and the ragged 16/10/6 bucket (K
                 64, lag 20): device µs and CUDA kernels of one replay of
                 the bucket's observe+decide graph beside J looped
                 controllers' (device µs summed, kernels J x one's); host
                 µs of a tick's flush and predict_cutoff fetches beside
                 the looped controllers' observe + predict
  cnn_parity     the paper's CNN (models.cnn), loss and gradient at batch
                 512 in f32, mean and cutoff-weighted, card against CPU
                 (the CPU's max-pools routed as the card's; the windows
                 that flipped must be near-ties)
  cnn_fig4       the reference's Fig. 4 setting: a RuntimeModel(32, lag
                 20) fitted on the card on a 300-row ClusterSim(32, 4
                 nodes) trace for 300 steps; then full sync,
                 CutoffController(k_samples 48) and Elfving each drive
                 150 steps of launch.cnn.run_cnn_cutoff (batch 512,
                 momentum 0.05/0.9, ClusterSim seed 21): the validation
                 curve every 10 steps on 2,000 images, the final loss, the
                 simulated clock, the median wall ms of a step, the DMM's
                 decision device µs; no controller is required to win
  supervised     launch.supervised.run_supervised on the card (36 steps, 6
                 workers, default_plan's crash, hang, flaky restart and
                 slowdown): match, 2 detections within 5 ticks, 1 failed
                 restart, no evictions, widths {5, 6}; every launch a
                 flash_attention one (2 layers x 36 steps x 2 trainers);
                 losses within train_parity's 1e-4 of the same run on the
                 CPU; the host µs of Supervisor.tick
  supervised_proc_drill
                 one SIGKILL of a ProcWorkerPool subprocess worker, its
                 ticks following heartbeats: dead at crash + 5, restarted
                 2 ticks later
  train_multi_job
                 three full-width qwen2-0.5b jobs of 6 workers through
                 launch.multi_job (build_multi_job over
                 PartitionedSim(paper_cluster_158(1, 18), partition_ids(18,
                 3)), batch 24, seq 128, psum, fused AdamW, each job's
                 RuntimeModel(6, lag 10) fitted on the card, PSServer with
                 refit_async, refit_steps 60, refit_fresh 3; run_ticks
                 under round robin): a ChurnEvent kills job1's workers 6
                 and 7 at tick 8, the restore is appended once job1 has
                 decided through its width-4 DMM for 2 ticks (tick 18 at
                 the earliest), the run ends 2 ticks after it is back on
                 its width-6 DMM (26 ticks at least); every step asserts
                 its launches (flash 24 x W, masked_grad_agg 1, fused_adam
                 1), every tick at most 2 decision launches and captures
                 only where the stack changed; job1's modes run dmm,
                 fallback, dmm at W 4, fallback, dmm at W 6, jobs 0 and 2
                 stay on the DMM; the shared step keeps a (6, N) and a
                 (4, N) buffer at width 4 (masked_grad_agg timed on job1's
                 own) and frees the (4, N) one after; wall per tick and
                 per step with and without a refit in flight, spawn to
                 install of each refit, memory by period
  serve_xlstm    full-width xlstm-350m (bf16, seeded init) through
                 ServeEngine.generate: 4 prompts x 128 tokens, 32 greedy new
                 tokens; asserts 21 mlstm_chunk launches (the mLSTM
                 prefills) and no flash_attention launch
  serve_xlstm_profile
                 the device's busy share of a short xLSTM request
  serve_xlstm_parity
                 the same weights in f32 at full width and 8 layers (one
                 7 mLSTM + 1 sLSTM period), served on the CPU (plain path)
                 and on the card (kernel): logits and ids must agree
  mlstm_grad     MLSTMChunk (the kernel forward, the plain recurrence's
                 backward) against autograd of the plain path on the card,
                 bf16 q/k/v and f32 gates, at train_xlstm's per-worker
                 shape (B 2, S 128, H 4, hd 512) and S 300: y and the five
                 gradients; forward and backward device ms beside the
                 backward's bound
  train_xlstm    full-width, full-depth xlstm-350m (bf16) trained by the
                 psum step under train_dmm's DMM controller
                 (CutoffController(rm, 48), ClusterSim(8, 2 nodes, seed
                 7)): seq 128 x batch 16, W 8, fused AdamW, 3 steps, each
                 asserting 21 x 8 mlstm_chunk, 1 masked_grad_agg and 1
                 fused_adam launches and a finite loss
  train_xlstm_parity
                 xlstm-350m at full width, depth 2 (one mLSTM, one sLSTM
                 block), f32, W 4: train_parity's comparisons, CPU against
                 the card
  serve_moe      full-depth deepseek-moe-16b (28 layers, 16,375,728,128
                 parameters, bf16, drawn on the card) through
                 ServeEngine.generate: 4 x 128 prompts, 32 greedy new
                 tokens; asserts 28 x 33 flash launches and ids in range;
                 prefill ms, ms per token, tokens/s, peak memory, the share
                 of routed slots dropped at capacity in a prefill
  serve_moe_profile
                 the device's busy share of a short MoE request
  serve_moe_parity
                 deepseek-moe-16b at full width and depth 2, f32: prefill
                 logits and greedy ids, CPU against the card
  train_moe      deepseek-moe-16b at depth 2 (layer 0 dense, layer 1 MoE;
                 1,091,315,712 parameters, bf16) under train_dmm's DMM
                 controller: seq 128 x batch 16, W 8, psum, fused AdamW; 2
                 steps, then a replay from the same state that must match
                 them bit for bit (losses, cutoffs, aux, parameters) and
                 goes on to 4 steps, each asserting its launches (flash 2
                 x 8, masked_grad_agg 1, fused_adam 1), a finite loss and
                 aux; c, aux, wall ms, peak memory, the dropped share; the
                 device's busy share of one more step; then
                 masked_grad_agg and fused_adam at this N on the trainer's
                 own buffer and state, beside their bounds
  train_moe_parity
                 the same depth-2 model in f32, W 2, seq 32 x batch 4, 2
                 steps: train_parity's comparisons and the aux, CPU against
                 the card; the host's resident bytes

Then the wall seconds of every phase, a ``{"kernels": [...]}`` summary
line, the card's name and power limit from nvidia-smi, and
``{"ok": true, "device": {...}}`` as the last line.
Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,       # dense tensor-core bf16
            "float32": 67e12}         # f32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # tests/test_kernels.py
# tests/test_kernels.py: masked agg 1e-5 (f32) and 1e-2 (bf16), atol=rtol
AGG_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# tests/test_kernels.py fused adam: (atol, rtol) for m and v, atol for p
ADAM_TOL = {"m": (1e-5, 1e-5), "v": (1e-6, 1e-5),
            "p": {"float32": 1e-5, "bfloat16": 2e-3}}
PARITY_LOGIT_ATOL = 1e-3   # f32, 24 layers, sums in another order per device
SEED = 0



@dataclasses.dataclass(frozen=True)
class FlashCase:
    name: str
    B: int
    Sq: int
    Sk: int
    H: int
    KV: int
    hd: int
    dtype: str
    path: str          # the kernel path the case must take
    causal: bool = True
    window: int = 0
    cache: int = 0     # decode: k/v are the first Sk slots of a longer cache
    offset: int = 0    # q, k, v start this many elements past an allocation


FLASH_CASES = [
    FlashCase("prefill_s128", 4, 128, 128, 14, 2, 64, "bfloat16", "wgmma"),
    FlashCase("prefill_s512", 4, 512, 512, 14, 2, 64, "bfloat16", "wgmma"),
    FlashCase("ragged_s100", 4, 100, 100, 14, 2, 64, "bfloat16", "wgmma"),
    FlashCase("sq16_sk144", 4, 16, 144, 14, 2, 64, "bfloat16", "wgmma"),
    FlashCase("decode_pos131", 4, 1, 132, 14, 2, 64, "bfloat16", "split_kv",
              cache=160),
    FlashCase("window128_s512", 4, 512, 512, 14, 2, 64, "bfloat16", "wgmma",
              window=128),
    FlashCase("f32_s256", 2, 256, 256, 14, 2, 64, "float32", "simt"),
    FlashCase("hd128_s256", 2, 256, 256, 8, 2, 128, "bfloat16", "wgmma"),
    FlashCase("train_b2_s128", 2, 128, 128, 14, 2, 64, "bfloat16", "wgmma"),
    FlashCase("train_b3_s128", 3, 128, 128, 14, 2, 64, "bfloat16", "wgmma"),
    # a train_multi_job worker at width 4 (batch 24 / 4)
    FlashCase("train_b6_s128", 6, 128, 128, 14, 2, 64, "bfloat16", "wgmma"),
    FlashCase("decode_sk4096", 4, 1, 4096, 14, 2, 64, "bfloat16", "split_kv",
              cache=4096),
    FlashCase("decode_pos159", 4, 1, 160, 14, 2, 64, "bfloat16", "split_kv",
              cache=160),
    # serve_parity's decode (one prompt, a 72-slot f32 cache)
    FlashCase("f32_decode_sk71", 1, 1, 71, 14, 2, 64, "float32", "simt",
              cache=72),
    # one element past the allocation: pointers off 16 bytes
    FlashCase("unaligned_s96", 2, 96, 96, 14, 2, 64, "bfloat16", "simt",
              offset=1),
    # fewer keys than two splits' floor: one split writes the output
    FlashCase("decode_sk48", 4, 1, 48, 14, 2, 64, "bfloat16", "split_kv",
              cache=160),
    # 28 packed rows: two 16-row tiles of the split kernel
    FlashCase("sq4_sk200", 4, 4, 200, 14, 2, 64, "bfloat16", "split_kv"),
    FlashCase("decode_hd128", 2, 1, 300, 8, 2, 128, "bfloat16", "split_kv",
              cache=512),
    # launch.supervised's trainer: bench_tiny_config at head_dim 64, f32,
    # the weights aggregation's global batch 60 at seq 8 (a query block
    # shorter than one tile; 2 heads over 1 KV head)
    FlashCase("supervised_b60_s8", 60, 8, 8, 2, 1, 64, "float32", "simt"),
    # phase 5 of examples/torch_fault_tolerance_demo.py: the reduced
    # qwen2-0.5b at head_dim 64, f32, global batch 56 at seq 32
    FlashCase("demo_b56_s32", 56, 32, 32, 4, 2, 64, "float32", "simt"),
]
# (name, B, S, H, hd, dtype, gates, path the case must take): xlstm-350m's
# mLSTM has 4 heads of 512
MLSTM_CASES = [
    ("serve_s128", 4, 128, 4, 512, "bfloat16", "normal", "wgmma"),
    ("ragged_s100", 4, 100, 4, 512, "bfloat16", "normal", "wgmma"),
    ("s300", 2, 300, 4, 512, "bfloat16", "normal", "wgmma"),
    ("s1", 4, 1, 4, 512, "bfloat16", "normal", "wgmma"),
    ("f32_s128", 4, 128, 4, 512, "float32", "normal", "simt"),
    ("hd16_s77", 2, 77, 4, 16, "float32", "normal", "simt"),
    ("hd32_s128", 4, 128, 4, 32, "bfloat16", "normal", "simt"),
    ("hd64_s130", 2, 130, 4, 64, "bfloat16", "normal", "wgmma"),
    ("extreme_gates", 4, 128, 4, 512, "bfloat16", "extreme", "wgmma"),
]
MLSTM_HEADLINE = "serve_s128"
# the mLSTM yardstick counts the work in the Pallas kernel's chunks,
# min(128, S) (src/repro/kernels/mlstm_chunk.py:88), whatever chunk the
# port's kernel takes
PALLAS_MLSTM_CHUNK = 128
TF32_OPS = 495e12   # dense tensor-core TF32: products with an f32 operand
# kernel vs plain and vs the oracle, y and a decode step: atol = rtol, as
# tests/test_kernels.py holds the Pallas kernel (both sides compute in f32
# from the same inputs; they differ in chunking and summation order)
MLSTM_TOL = 5e-4
HEADLINE_CASE = "prefill_s128"   # the serve prompt's shape
DECODE_CASE = "decode_pos131"    # a serve decode step: 768 of 792 launches
# the CUDA kernels of src/repro_torch/kernels/csrc, by function name
PORT_KERNELS = ("flash_fwd", "flash_fwd_tc", "flash_split_tc",
                "flash_combine", "masked_agg", "fused_adam", "mlstm_fwd",
                "mlstm_state_tc", "mlstm_out_tc")
AGG_HEADLINE = "full_w8_f32"      # the train step's (8, N) buffer
ADAM_HEADLINE = "full_bfloat16"   # the train step's leaves


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


def device_profile(torch, fn, n_top=10):
    """Run ``fn`` under torch.profiler, recording the device's activity
    only (kernels and copies; recording the host's ops as well costs seconds
    of post-processing per 10^4 kernels): device ms, device events, the
    port's own kernels by name and the kernels that took longest."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    ours = {}   # the port's kernels by name
    for e in dev:
        name = kernel_name(e.key)
        if name in PORT_KERNELS:
            n, ms = ours.get(name, (0, 0.0))
            ours[name] = (n + e.count, ms + e.self_device_time_total / 1e3)
    return {"device_ms": sum(e.self_device_time_total for e in dev) / 1e3,
            "device_events": sum(e.count for e in dev),
            "ours": {k: {"count": n, "device_ms": ms}
                     for k, (n, ms) in ours.items()},
            "top": [{"kernel": e.key[:100], "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in top[:n_top]]}


def kernels_per_call(torch, fn, calls=5):
    """The CUDA kernels one call of ``fn`` launches, by name: launches a
    call and device µs a launch, from ``calls`` profiled calls.  One call
    before them is traced and dropped, since the first moments of a trace
    can lose kernels.  A trace that lost events all the same (none at all,
    or a kernel counted a fractional number of times a call: every wrapper
    here launches the same kernels on every call) is taken again, up to 5
    traces; the caller asserts the counts.  The phases that call
    this run first: late in a long run (after the serve and train
    profiles) the profiler has lost the first kernel of every trace."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(5):
        per = {}
        got = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=calls,
                                       repeat=1),
                     on_trace_ready=lambda p: got.append(p.key_averages())
                     ) as prof:
            for _ in range(1 + calls):
                fn()
                torch.cuda.synchronize()
                prof.step()
        for e in got[0]:
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = per.get(kernel_name(e.key), (0, 0.0))
                per[kernel_name(e.key)] = (n + e.count,
                                           us + e.self_device_time_total)
        if per and all(n % calls == 0 for n, _ in per.values()):
            break
    return {k: {"per_call": n / calls, "us": us / n}
            for k, (n, us) in per.items()}


def kernel_name(key):
    """``flash_fwd`` of ``void (anonymous namespace)::flash_fwd<...>``."""
    m = re.search(r"::(\w+)[<(]", key)
    return m.group(1) if m else key[:60]


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
        ptxas, fn = [], None   # each line under its (mangled) kernel name
        for ln in rec["log"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                fn = m.group(1)
            elif "registers" in ln or "spill" in ln:
                ptxas.append(f"{fn}: {ln.strip()}")
        per[name] = {"seconds": rec["seconds"], "ptxas": ptxas}
    emit("build", seconds=wall, kernels=per)
    emit("kernels", names=sorted(build.SOURCES))


def phase_flash(torch):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        aligned16, choose_path, flash_attention, split_plan)
    from repro_torch.kernels.ref import reference_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    side = torch.cuda.Stream()
    results = {}
    for c in FLASH_CASES:
        name, B, Sq, Sk, H, KV, hd = (c.name, c.B, c.Sq, c.Sk, c.H, c.KV,
                                      c.hd)
        causal, window, dt = c.causal, c.window, getattr(torch, c.dtype)

        def rand(*shape):
            n = math.prod(shape)
            flat = torch.randn(n + c.offset, generator=gen, device="cuda")
            return flat.to(dt)[c.offset:].view(shape)

        q = rand(B, Sq, H, hd)
        if c.cache:   # decode: a view of the first Sk slots of a cache
            k = rand(B, c.cache, KV, hd)[:, :Sk]
            v = rand(B, c.cache, KV, hd)[:, :Sk]
        else:
            k, v = rand(B, Sk, KV, hd), rand(B, Sk, KV, hd)
        path = choose_path(q.dtype, Sq, H // KV, aligned16(q, k, v))
        check(path == c.path, f"{name}: takes {path}, not {c.path}")
        out = flash_attention(q, k, v, causal=causal, window=window)
        want = reference_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(out.shape == want.shape and out.dtype == q.dtype,
              f"{name}: output {tuple(out.shape)} {out.dtype}")
        err = (out.float() - want.float()).abs().max().item()
        tol = TOL[c.dtype]
        check(err <= tol, f"{name}: max error {err} > {tol}")

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
        # the library is a yardstick only: a wrong result voids its time
        # (SDPA on views off 16-byte alignment), the run goes on
        lib_invalid = None
        if not lib_err <= tol:
            lib_invalid = (f"library_err {lib_err} > tol {tol}: the "
                           f"library time {times['library_ms']} ms is of a "
                           f"wrong result")
            times["library_ms"] = times["eager_library_ms"] = None
        plan = (split_plan(Sq, Sk, causal, window, B * KV)
                if path == "split_kv" else None)
        # the CUDA kernels a call makes, against what its path launches
        per_call = kernels_per_call(torch, kern)
        expect = {"simt": {"flash_fwd"}, "wgmma": {"flash_fwd_tc"},
                  "split_kv": {"flash_split_tc"}}[path]
        if plan and plan.splits > 1:
            expect = expect | {"flash_combine"}
        check(set(per_call) == expect
              and all(r["per_call"] == 1 for r in per_call.values()),
              f"{name}: a call launched {per_call}, not one each of "
              f"{sorted(expect)}")

        elt = q.element_size()
        nbytes = elt * (2 * q.numel() + 2 * B * Sk * KV * hd)
        ops = 4 * B * H * hd * valid_pairs(Sq, Sk, causal, window)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[c.dtype] * 1e3
        rec = {"case": name, "shape": [B, Sq, Sk, H, KV, hd],
               "dtype": c.dtype, "causal": causal, "window": window,
               "cache": c.cache, "offset": c.offset, "max_abs_err": err,
               "tol": tol, **times, "library_err": lib_err,
               "library_invalid": lib_invalid,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops, "path": path,
               "splits": plan.splits if plan else None,
               "cuda_kernels_per_call": sum(r["per_call"]
                                            for r in per_call.values()),
               "kernel_us": {k: r["us"] for k, r in per_call.items()},
               "ms_over_library": (None if lib_invalid else
                                   times["ms"] / times["library_ms"])}
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
    n_prof = 8
    t0 = time.perf_counter()
    engine.generate(prompts, n_prof)
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = device_profile(torch, lambda: engine.generate(prompts, n_prof))
    emit("serve_profile", n_new=n_prof, wall_ms=wall_ms,
         device_busy_share=prof["device_ms"] / wall_ms, **prof)
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


def _allclose_excess(torch, got, want, atol, rtol):
    """max(|got - want| - rtol |want|): at most ``atol`` when allclose."""
    d = (got.float() - want.float()).abs() - rtol * want.float().abs()
    return d.max()


AGG_CASES_W = (2, 8, 158)
AGG_CASES_N = (1, 1000, 1 << 20)
FULL_N = 494_032_768           # qwen2-0.5b parameters (tied head)


def _agg_masks(torch, W, gen):
    bits = (torch.arange(W, device="cuda") % 3 != 0).float()
    frac = torch.rand(W, generator=gen, device="cuda")
    return {"bits": bits, "fractional": frac,
            "zero": torch.zeros(W, device="cuda")}


def _agg_times(torch, side, g, mask, reps):
    from repro_torch.kernels.masked_grad_agg import masked_grad_agg
    from repro_torch.kernels.ref import reference_masked_agg

    W, N = g.shape
    m2 = mask.reshape(1, W).to(g.dtype)
    c = torch.clamp(mask.sum(), min=1.0)
    fns = {"ms": lambda: masked_grad_agg(g, mask),
           "plain_ms": lambda: reference_masked_agg(g, mask.reshape(-1, 1)),
           "library_ms": lambda: (m2 @ g) / c}
    times = {k: device_ms(torch, f, side, reps=reps) for k, f in fns.items()}
    elt = g.element_size()
    nbytes = W * N * elt + N * elt + 4 * W
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * W * N / PEAK_OPS["float32"] * 1e3
    return dict(times, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes)


def phase_masked_agg(torch):
    from repro_torch.kernels.masked_grad_agg import (MAX_WORKERS,
                                                      masked_grad_agg)
    from repro_torch.kernels.ref import reference_masked_agg

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    side = torch.cuda.Stream()
    worst, cases = 0.0, 0
    for dtname in ("float32", "bfloat16"):
        dt = getattr(torch, dtname)
        for W in AGG_CASES_W:
            for N in AGG_CASES_N:
                g = torch.randn(W, N, generator=gen, device="cuda").to(dt)
                for mname, mask in _agg_masks(torch, W, gen).items():
                    out = masked_grad_agg(g, mask)
                    want = reference_masked_agg(g, mask.reshape(-1, 1))[0]
                    check(out.shape == (N,) and out.dtype == dt,
                          f"masked_grad_agg {W}x{N} {dtname}: output "
                          f"{tuple(out.shape)} {out.dtype}")
                    tol = AGG_TOL[dtname]
                    ex = _allclose_excess(torch, out, want, tol, tol).item()
                    check(ex <= tol, f"masked_grad_agg {W}x{N} {dtname} "
                          f"{mname} mask: off by {ex} beyond rtol > {tol}")
                    if mname == "zero":
                        check(bool((out == 0).all()), "masked_grad_agg: an "
                              "all-zero mask must give exact zeros")
                    err = (out.float() - want.float()).abs().max().item()
                    worst = max(worst, err)
                    cases += 1
                del g
    # the worker limit: the kernel takes MAX_WORKERS rows and refuses more
    g = torch.randn(MAX_WORKERS + 1, 1000, generator=gen, device="cuda")
    mask = _agg_masks(torch, MAX_WORKERS + 1, gen)["fractional"]
    out = masked_grad_agg(g[:-1], mask[:-1])
    want = reference_masked_agg(g[:-1], mask[:-1].reshape(-1, 1))[0]
    ex = _allclose_excess(torch, out, want, AGG_TOL["float32"],
                          AGG_TOL["float32"]).item()
    check(ex <= AGG_TOL["float32"], f"masked_grad_agg at the worker limit "
          f"{MAX_WORKERS}: off by {ex}")
    worst = max(worst, (out - want).abs().max().item())
    cases += 1
    try:
        masked_grad_agg(g, mask)
    except ValueError:
        pass
    else:
        raise RuntimeError(f"masked_grad_agg took {MAX_WORKERS + 1} workers")
    del g, out, want
    emit("masked_grad_agg", checked_cases=cases, max_abs_err=worst,
         max_workers=MAX_WORKERS)

    results = {}
    timed = [("w158_n2^20_f32", 158, 1 << 20, "float32", 20),
             ("w8_n2^20_bf16", 8, 1 << 20, "bfloat16", 20),
             ("full_w8_f32", 8, FULL_N, "float32", 5)]
    for name, W, N, dtname, reps in timed:
        dt = getattr(torch, dtname)
        g = torch.randn(W, N, generator=gen, device="cuda", dtype=dt)
        mask = _agg_masks(torch, W, gen)["bits"]
        out = masked_grad_agg(g, mask)
        want = reference_masked_agg(g, mask.reshape(-1, 1))[0]
        err = (out.float() - want.float()).abs().max().item()
        tol = AGG_TOL[dtname]
        ex = _allclose_excess(torch, out, want, tol, tol).item()
        check(ex <= tol, f"masked_grad_agg {name}: off by {ex} > {tol}")
        del out, want
        torch.cuda.empty_cache()
        rec = {"case": name, "W": W, "N": N, "dtype": dtname,
               "max_abs_err": err, "tol": tol,
               **_agg_times(torch, side, g, mask, reps)}
        results[name] = rec
        emit("masked_grad_agg", **rec)
        del g
        torch.cuda.empty_cache()
    return results, worst


def _adam_inputs(torch, shapes, p_dt, gen, offset=()):
    """Random p, g, m, v leaves; the leaves whose index is in ``offset``
    start one element past an aligned address (the kernel's scalar path)."""
    def rand(i, shape, dt, scale=1.0):
        x = (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)
        if i not in offset:
            return x
        y = torch.empty(x.numel() + 1, dtype=dt, device="cuda")[1:]
        return y.view(shape).copy_(x)

    ps = [rand(i, s, p_dt) for i, s in enumerate(shapes)]
    gs = [rand(i, s, p_dt) for i, s in enumerate(shapes)]
    ms = [rand(i, s, torch.float32, 0.1) for i, s in enumerate(shapes)]
    vs = [rand(i, s, torch.float32, 0.01).abs_() for i, s in enumerate(shapes)]
    return ps, gs, ms, vs


def _adam_check(torch, ps, gs, ms, vs, step, wd, dtname):
    """One kernel step on copies of the leaves against reference_adam,
    leaf by leaf; returns the max abs error of p, m and v."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_adam import fused_adam_
    from repro_torch.kernels.ref import reference_adam

    scal = ops.adam_scalars(step - 1, 1e-3, 0.9, 0.999)
    kp = [x.clone() for x in ps]
    km = [x.clone() for x in ms]
    kv = [x.clone() for x in vs]
    fused_adam_(kp, gs, km, kv, scal, wd=wd)
    errs = {"p": [], "m": [], "v": []}
    excess = {"p": [], "m": [], "v": []}
    for i in range(len(ps)):
        wp, wm, wv = reference_adam(ps[i], gs[i], ms[i], vs[i], scal, wd=wd)
        for key, got, want in (("p", kp[i], wp), ("m", km[i], wm),
                               ("v", kv[i], wv)):
            errs[key].append((got.float() - want.float()).abs().max())
            atol, rtol = ((ADAM_TOL["p"][dtname], 0.0) if key == "p"
                          else ADAM_TOL[key])
            excess[key].append(_allclose_excess(torch, got, want, atol, rtol)
                               - atol)
        del wp, wm, wv
    err = {k: torch.stack(v).max().item() for k, v in errs.items()}
    over = {k: torch.stack(v).max().item() for k, v in excess.items()}
    for k in over:
        check(over[k] <= 0.0, f"fused_adam {dtname} step {step} wd {wd}: "
              f"{k} beyond tolerance by {over[k]}")
    return err


def _adam_grid_shapes(shapes):
    """The correctness grid's leaves: each distinct shape of the model up
    to 2^24 elements (every layer leaf; not the embedding), and ragged
    sizes around the kernel's chunk of 4096 elements."""
    from repro_torch.kernels.fused_adam import CHUNK

    distinct = [s for s in dict.fromkeys(shapes) if np.prod(s) <= 1 << 24]
    return distinct + [(1,), (3,), (CHUNK - 1,), (CHUNK + 5,),
                       (7, 3 * CHUNK + 1)]


def phase_fused_adam(torch, shapes):
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_adam import LeafTable, fused_adam_
    from repro_torch.kernels.ref import reference_adam

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    side = torch.cuda.Stream()
    worst = 0.0
    # the grid of steps and weight decays on a subset of leaves that holds
    # every layer shape, ragged chunk tails and unaligned leaves
    grid = _adam_grid_shapes(shapes)
    offset = set(range(len(grid) - 3, len(grid)))
    for dtname in ("bfloat16", "float32"):
        ps, gs, ms, vs = _adam_inputs(torch, grid, getattr(torch, dtname),
                                      gen, offset)
        for step in (1, 100):
            for wd in (0.0, 0.01):
                err = _adam_check(torch, ps, gs, ms, vs, step, wd, dtname)
                worst = max(worst, *err.values())
                emit("fused_adam", dtype=dtname, step=step, wd=wd,
                     leaves=len(ps), unaligned=len(offset),
                     params=sum(x.numel() for x in ps), max_abs_err=err,
                     tol={"p": ADAM_TOL["p"][dtname], "m": ADAM_TOL["m"],
                          "v": ADAM_TOL["v"]})
        del ps, gs, ms, vs

    # the full-width leaves, as the train step hands them in (bf16 p and
    # g, f32 m and v): one checked step, then the times
    n_params = sum(int(np.prod(s)) for s in shapes)
    results = {}
    dtname = "bfloat16"
    p_dt = getattr(torch, dtname)
    ps, gs, ms, vs = _adam_inputs(torch, shapes, p_dt, gen)
    err = _adam_check(torch, ps, gs, ms, vs, 1, 0.01, dtname)
    worst = max(worst, *err.values())
    # times: in place on the same leaves, as the optimizer runs it
    scal = ops.adam_scalars(0, 1e-3, 0.9, 0.999)
    table = LeafTable()
    lib_params = [x.clone() for x in ps]
    for lp, g in zip(lib_params, gs):
        lp.grad = g
    lib = torch.optim.AdamW(lib_params, lr=1e-3, weight_decay=0.01,
                            fused=True, capturable=True)
    fns = {"ms": lambda: fused_adam_(ps, gs, ms, vs, scal, wd=0.01,
                                     table=table),
           "plain_ms": lambda: [reference_adam(p, g, m, v, scal, wd=0.01)
                                for p, g, m, v in zip(ps, gs, ms, vs)],
           "library_ms": lib.step}
    # the plain version: 290 leaves x ~15 ops a call, few calls a graph
    times = {k: device_ms(torch, f, side, reps=3 if k == "plain_ms"
                          else 10) for k, f in fns.items()}
    times["eager_ms"] = eager_ms(torch, fns["ms"], reps=10)
    times["eager_library_ms"] = eager_ms(torch, lib.step, reps=10)
    pe = ps[0].element_size()
    nbytes = n_params * (2 * pe + pe + 2 * 4 * 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 12 * n_params / PEAK_OPS["float32"] * 1e3
    rec = {"case": f"full_{dtname}", "leaves": len(ps),
           "params": n_params, "dtype": dtname, "step": 1, "wd": 0.01,
           "max_abs_err": err, **times,
           "library": f"torch.optim.AdamW(fused=True, capturable=True), "
                      f"{dtname} params, grads and moments",
           "table_uploads": table.uploads,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes}
    results[rec["case"]] = rec
    emit("fused_adam", **rec)
    del ps, gs, ms, vs, lib_params, lib, fns
    torch.cuda.empty_cache()
    return results, worst


def _train_setup(torch, cfg, params, *, n_workers, seq, batch, controller,
                 timer, record=None, metrics_out=None, opt=None,
                 step_fn=None):
    """A psum Trainer with the slice's optimizer; ``record``, when given,
    is called with each step's aggregated gradient on its device;
    ``metrics_out`` (a list) receives each step's device ``aux`` and
    ``ce``.  ``opt`` and ``step_fn`` are reused when given (one (W, N)
    buffer for two runs)."""
    from repro_torch import optim
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import Trainer, make_train_step

    if opt is None:
        opt = optim.adamw(optim.cosine_schedule(3e-4, 2, 20), fused=True)
        if record is not None:
            inner = opt

            def update(grads, state, params_=None):
                record(grads)
                return inner.update(grads, state, params_)

            opt = optim.Optimizer(inner.init, update)
    if step_fn is None:
        step_fn = make_train_step(cfg, opt, mask_agg="psum")
    run_fn = step_fn
    if metrics_out is not None:
        def run_fn(state, b):
            state, m = step_fn(state, b)
            metrics_out.append({k: m[k] for k in ("aux", "ce")})
            return state, m

        run_fn.hold, run_fn.buffers = step_fn.hold, step_fn.buffers
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=batch, seed=SEED)
    tr = Trainer(step_fn=run_fn, data=data, controller=controller,
                 timer=timer, n_workers=n_workers, mask_agg="psum",
                 metrics_every=1)
    tr.restore_or_init(lambda: {"params": params, "opt": opt.init(params)})
    return tr, opt


def phase_train(torch, cfg, params_f32):
    from repro_torch import tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import FirstKController
    from repro_torch.kernels import build
    from repro_torch.launch.train import make_train_step

    W, S, B, n_steps = 8, 128, 16, 5
    t_setup = time.perf_counter()
    params = cast(params_f32, "cuda", torch.bfloat16)
    tr, opt = _train_setup(torch, cfg, params, n_workers=W, seq=S, batch=B,
                           controller=FirstKController(W, backup=2),
                           timer=ClusterSim(n_workers=W, n_nodes=2, seed=7))
    want = {"flash_attention": cfg.n_layers * W, "masked_grad_agg": 1,
            "fused_adam": 1}
    totals, clocks = {}, []
    torch.cuda.synchronize()
    seconds = {"setup": time.perf_counter() - t_setup}
    t_steps = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n_steps):
        build.LAUNCHES.clear()
        uploads = opt.table.uploads
        t0 = time.perf_counter()
        rec = tr.run(1)[-1]        # drains the loss: ends in a device sync
        wall = time.perf_counter() - t0
        uploads = opt.table.uploads - uploads
        launches = dict(build.LAUNCHES)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        check(launches == want, f"psum step {rec['step']}: launches "
              f"{launches}, want {want}")
        check(bool(np.isfinite(rec["loss"])),
              f"step {rec['step']}: loss {rec['loss']}")
        clocks.append(rec["clock"])
        emit("train", mask_agg="psum", step=rec["step"], wall_ms=wall * 1e3,
             tokens_per_s=B * S / wall, c=rec["c"], n=rec["n"],
             loss=rec["loss"], clock=rec["clock"], launches=launches,
             leaf_table_uploads=uploads,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    peak = torch.cuda.max_memory_allocated()
    seconds["psum_steps"] = time.perf_counter() - t_steps

    # the device's busy share of one more psum step
    t_prof = time.perf_counter()
    wall = []

    def one_step():
        t0 = time.perf_counter()
        tr.run(1)
        wall.append((time.perf_counter() - t0) * 1e3)

    prof = device_profile(torch, one_step)
    seconds["profile"] = time.perf_counter() - t_prof
    emit("train_profile", mask_agg="psum", wall_ms=wall[0],
         device_busy_share=prof["device_ms"] / wall[0],
         seconds=seconds["profile"], **prof)

    # one step of the weights path, from the same state and optimizer
    t_weights = time.perf_counter()
    tr.step_fn = make_train_step(cfg, opt, mask_agg="weights")
    tr.mask_agg = "weights"
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    rec = tr.run(1)[-1]
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    want_w = {"flash_attention": cfg.n_layers, "fused_adam": 1}
    check(launches == want_w, f"weights step: launches {launches}, "
          f"want {want_w}")
    check(bool(np.isfinite(rec["loss"])), f"weights step: loss {rec['loss']}")
    emit("train", mask_agg="weights", step=rec["step"], wall_ms=wall * 1e3,
         tokens_per_s=B * S / wall, c=rec["c"], n=rec["n"], loss=rec["loss"],
         launches=launches, leaves=len(tree.leaves(params)),
         psum_max_memory_allocated=peak,
         seconds=dict(seconds, weights_step=time.perf_counter() - t_weights))
    del tr, opt, params
    torch.cuda.empty_cache()
    return totals, clocks


def _scaled_err(torch, got, want):
    """Per leaf: max |got - want| over max |want| (the leaf's own scale)."""
    out = []
    for a, b in zip(got, want):
        scale = b.abs().max().clamp(min=1e-30)
        out.append(((a - b).abs().max() / scale).item())
    return max(out)


PARITY_TOL = {"loss": 1e-4, "grad": 1e-4, "m": 1e-4, "v": 3e-4}


def _host_rss():
    """(current, process peak) resident bytes of this process."""
    import resource

    with open("/proc/self/statm") as f:
        cur = int(f.read().split()[1]) * resource.getpagesize()
    return cur, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _train_parity(torch, cfg, p_cpu, *, W, S, B, n_steps, cutoff):
    """The psum step (StaticCutoffController(W, cutoff), ClusterSim(W, 2
    nodes, seed 7), fused AdamW) for ``n_steps`` on the CPU (plain
    versions), then on the card (kernels), from the f32 params ``p_cpu``
    (updated in place by the CPU run).  The CPU run keeps its gradients;
    the card's are compared with them as they come, on the card, so the
    host holds one run's state and gradients, not two.  Returns the record
    of train_parity's comparisons (losses, the aggregated gradient, m, v,
    p held tightly where every step's |g| is above 1e-3 of its leaf's
    largest and within 2 lr per step elsewhere) and the per-step aux of
    both runs."""
    from repro_torch import tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import StaticCutoffController
    from repro_torch.optim import cosine_schedule

    p_gpu = cast(p_cpu, "cuda", torch.float32)
    seconds, hist, aux = {}, {}, {}
    g_cpu, sure, grad_errs = [], None, []
    names = _leaf_names(p_cpu)

    def check_gpu(g):
        nonlocal sure
        want = [x.to("cuda") for x in g_cpu.pop(0)]
        per_leaf = [_scaled_err(torch, [a.float()], [b])
                    for a, b in zip(tree.leaves(g), want)]
        worst = int(np.argmax(per_leaf))
        grad_errs.append((per_leaf[worst], names[worst]))
        # where the CPU's |g| is well above noise on every step
        s = [x.abs() > 1e-3 * x.abs().max() for x in want]
        sure = s if sure is None else [a & b for a, b in zip(sure, s)]

    state = {}
    for dev, params, rec in (
            ("cpu", p_cpu,
             lambda g: g_cpu.append([x.float() for x in tree.leaves(g)])),
            ("cuda", p_gpu, check_gpu)):
        t0 = time.perf_counter()
        mets = []
        tr, _ = _train_setup(
            torch, cfg, params, n_workers=W, seq=S, batch=B,
            controller=StaticCutoffController(W, cutoff=cutoff),
            timer=ClusterSim(n_workers=W, n_nodes=2, seed=7), record=rec,
            metrics_out=mets)
        hist[dev] = tr.run(n_steps)
        aux[dev] = [float(m["aux"]) for m in mets]
        state[dev] = {"p": tr.state["params"],
                      "m": tr.state["opt"]["m"], "v": tr.state["opt"]["v"]}
        del tr, mets
        gc.collect()
        seconds[dev] = time.perf_counter() - t0
    t0 = time.perf_counter()
    h_c, h_g = hist["cpu"], hist["cuda"]
    check([(h["c"], h["clock"]) for h in h_c]
          == [(h["c"], h["clock"]) for h in h_g], "cutoffs/clock differ")
    loss_err = max(abs(a["loss"] - b["loss"]) for a, b in zip(h_c, h_g))

    def pairs(key):   # (card leaf, CPU leaf on the card), one at a time
        for a, b in zip(tree.leaves(state["cuda"][key]),
                        tree.leaves(state["cpu"][key])):
            yield a, b.to("cuda")

    m_err = max(_scaled_err(torch, [a], [b]) for a, b in pairs("m"))
    v_err = max(_scaled_err(torch, [a], [b]) for a, b in pairs("v"))
    # Adam's first steps move each entry by about lr times the sign of its
    # gradient, whatever the gradient's size: where |g| sits at rounding
    # noise the two devices may disagree on that sign, so p is held tightly
    # only where every step's |g| is above 1e-3 of its leaf's largest, and
    # within 2 lr per step elsewhere.
    sched = cosine_schedule(3e-4, 2, 20)
    lr_sum = float(sum(sched(s) for s in range(n_steps)))
    tight_tol, loose_tol = 0.05 * lr_sum, 2.0 * lr_sum
    tight_err = loose_err = 0.0
    n_tight = n_all = 0
    for i, (a, b) in enumerate(pairs("p")):
        d = (a - b).abs()
        if bool(sure[i].any()):
            tight_err = max(tight_err, d[sure[i]].max().item())
        loose_err = max(loose_err, d.max().item())
        n_tight += int(sure[i].sum())
        n_all += d.numel()
    seconds["compare"] = time.perf_counter() - t0
    rec = {"dtype": "float32", "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "workers": W, "seq": S, "batch": B,
           "steps": n_steps, "c": [h["c"] for h in h_g],
           "loss_cpu": [h["loss"] for h in h_c],
           "loss_cuda": [h["loss"] for h in h_g],
           "loss_max_abs_err": loss_err,
           "grad_scaled_err": max(e for e, _ in grad_errs),
           "grad_scaled_err_by_step": [e for e, _ in grad_errs],
           "grad_worst_leaf_by_step": [n for _, n in grad_errs],
           "m_scaled_err": m_err, "v_scaled_err": v_err,
           "p_tight_max_abs_err": tight_err, "p_tight_tol": tight_tol,
           "p_tight_share": n_tight / n_all,
           "p_max_abs_err": loose_err, "p_tol": loose_tol, "tol": PARITY_TOL,
           "seconds": seconds}
    del state, p_gpu, sure
    gc.collect()
    torch.cuda.empty_cache()
    return rec, aux


def _leaf_names(node, pre=""):
    """'/layers/1/moe/router'-style names, in ``tree.leaves`` order."""
    if isinstance(node, dict):
        return [n for k in sorted(node) for n in
                _leaf_names(node[k], f"{pre}/{k}")]
    if isinstance(node, (list, tuple)):
        return [n for i, v in enumerate(node) for n in
                _leaf_names(v, f"{pre}/{i}")]
    return [pre]


def _check_train_parity(rec, what, tol=None):
    """train_parity's bars (``PARITY_TOL``), or ``tol``: the first step's
    gradient (identical params on both devices) at ``tol["grad"]``, the
    later steps' at ``tol["grad_later"]`` where given."""
    tol = tol or PARITY_TOL
    by_step = rec["grad_scaled_err_by_step"]
    check(rec["loss_max_abs_err"] <= tol["loss"],
          f"{what}: loss differs by {rec['loss_max_abs_err']}")
    check(by_step[0] <= tol["grad"], f"{what}: step 1's aggregated "
          f"gradient differs by {by_step[0]} of its scale")
    check(max(by_step) <= tol.get("grad_later", tol["grad"]),
          f"{what}: aggregated gradient differs by {max(by_step)} of its "
          f"scale ({by_step} by step)")
    check(rec["m_scaled_err"] <= tol["m"],
          f"{what}: m differs by {rec['m_scaled_err']} of its scale")
    check(rec["v_scaled_err"] <= tol["v"],
          f"{what}: v differs by {rec['v_scaled_err']} of its scale")
    check(rec["p_tight_max_abs_err"] <= rec["p_tight_tol"],
          f"{what}: p differs by {rec['p_tight_max_abs_err']} > "
          f"{rec['p_tight_tol']} where |g| is well above noise")
    check(rec["p_max_abs_err"] <= rec["p_tol"],
          f"{what}: p differs by {rec['p_max_abs_err']} > {rec['p_tol']}")


def phase_train_parity(torch, cfg_full):
    from repro_torch.models import model as M

    cfg = dataclasses.replace(cfg_full, n_layers=2, dtype="float32")
    p_cpu = M.init_model(cfg, torch.Generator().manual_seed(SEED + 3),
                         device="cpu", dtype=torch.float32)
    rec, _ = _train_parity(torch, cfg, p_cpu, W=4, S=32, B=8, n_steps=2,
                           cutoff=3)
    emit("train_parity", **rec)
    _check_train_parity(rec, "train_parity")


# ---------------------------------------------------------------------------
# The DMM decision path.  It has no kernel of its own: plain torch ops,
# captured as one CUDA graph per controller mode and replayed once a step.
# ---------------------------------------------------------------------------

NORMAL_TOL = (1e-6, 1e-7)   # (rtol, atol) of tests/test_torch_random.py
FIT_TOL = 2e-3              # of the loss trajectory's largest |value|
WINDOW_TOL = 2e-3           # rtol = atol, tests/test_controller_device.py
# The server's windows against the card's controllers and the CPU server
# (ps_parity, ps_parity_158): the reference's server bar, rtol = atol
# (tests/test_ps_server.py:130).  The card meets it since the
# controller's decision divides its ring by the norm scale as a tensor
# (C.12): CUDA divides by a python float as a product with the
# reciprocal, one ulp off the bucket's true division in up to 500 of
# the 3,318 ring entries, and the censored imputation's f32 tail (a
# truncation CDF within ~1e-5 of 1, where its spacing is 6e-8) turned
# those ulps into 1.82e-4 of window at J = 1, n = 158 (1.47e-4 at
# J = 3).  Since: 0.0 at J = 1, 4.3e-6 at J = 3, 1.6e-5 against the CPU
# server (H100).
SERVER_WINDOW_TOL = 1e-4


def _twin_check(torch):
    """(a) The jax.random twin on the card against the twin on the CPU, at
    the shapes the controller draws: bits equal for split, fold_in,
    uniform and categorical; normals within NORMAL_TOL."""
    from repro_torch import random as R
    from repro_torch.core.runtime_model import api

    logits = torch.randn((4, 151936), generator=torch.Generator()
                         .manual_seed(SEED)) * 3.0
    out = {"bits_equal": [], "normal_max_abs_err": 0.0,
           "normal_bit_equal_share": 1.0, "tol": NORMAL_TOL}

    def draws(seed, dev):
        key = R.PRNGKey(seed, device=dev)
        k1, k2, k3, _ = R.split(key, 4)
        steps = R.split(k1, 21)
        return {"split": R.split(key, 4),
                "split_steps": steps,
                "fold_in": api._colwise_keys(k3, 158),
                "uniform": api.colwise_uniform(k2, 158).view(torch.int32),
                "categorical": R.categorical(key, logits.to(dev)),
                "normal_guide": R.normal(steps, (64, 32)),
                "normal_transition": R.normal(k2, (64, 32)),
                "normal_colwise": api.colwise_normal(k3, 64, 158)}

    for seed in (0, 7, 1_000_010):
        cpu, gpu = draws(seed, "cpu"), draws(seed, "cuda")
        for name, a in cpu.items():
            b = gpu[name].cpu()
            if name.startswith("normal"):
                err = float((a - b).abs().max())
                out["normal_max_abs_err"] = max(out["normal_max_abs_err"],
                                                err)
                share = float((a.view(torch.int32) == b.view(torch.int32))
                              .float().mean())
                out["normal_bit_equal_share"] = min(
                    out["normal_bit_equal_share"], share)
                check(torch.allclose(b, a, rtol=NORMAL_TOL[0],
                                     atol=NORMAL_TOL[1]),
                      f"twin {name} (seed {seed}): card and CPU normals "
                      f"differ by {err}")
            else:
                check(torch.equal(a, b), f"twin {name} (seed {seed}): card "
                      f"and CPU bits differ")
    out["bits_equal"] = [k for k in cpu if not k.startswith("normal")]
    return out


def _rel_close(a, b, tol):
    return bool(np.all(np.abs(a - b) <= tol + tol * np.abs(b)))


def phase_dmm(torch):
    """(a) the twin, (b) the fit on card and CPU, (c) 100 steps of the
    device backend on the card against the numpy backend, (d) timing."""
    from repro_torch.cluster.simulator import ClusterSim, paper_cluster_158
    from repro_torch.core.controller import CutoffController
    from repro_torch.core.cutoff import order_stats
    from repro_torch.core.runtime_model.api import RuntimeModel

    t0 = time.perf_counter()
    twin = _twin_check(torch)
    emit("dmm_twin", **twin, seconds=time.perf_counter() - t0)

    # (b) the same init on both devices, 60 ELBO steps at batch 8
    trace = paper_cluster_158(seed=0).run(60)
    losses, fit_s, models = {}, {}, {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        rm = RuntimeModel(158, lag=20, device=dev).init(0)
        losses[dev] = np.asarray(rm.fit(trace, steps=60, batch=8, seed=0))
        fit_s[dev] = time.perf_counter() - t0
        models[dev] = rm
    scale = float(np.abs(losses["cpu"]).max())
    fit_err = float(np.abs(losses["cuda"] - losses["cpu"]).max())
    emit("dmm_fit", n=158, lag=20, steps=60, batch=8,
         loss_first=[losses[d][0] for d in ("cpu", "cuda")],
         loss_last=[losses[d][-1] for d in ("cpu", "cuda")],
         max_abs_err=fit_err, scale=scale, tol=FIT_TOL * scale,
         seconds=fit_s)
    check(fit_err <= FIT_TOL * scale, f"fit: card and CPU losses differ by "
          f"{fit_err} > {FIT_TOL} x {scale}")

    # (c) the card's device backend against the port's f64 numpy backend,
    # both on the card-fitted params
    rm = models["cuda"]
    dev = CutoffController(rm, k_samples=32, seed=0, backend="device")
    ref = CutoffController(rm.to("cpu"), k_samples=32, seed=0,
                           backend="numpy")
    dev.seed_window(trace)
    ref.seed_window(trace)
    sim = paper_cluster_158(seed=7)
    cutoffs, censored, win_err = [], 0, 0.0
    t0 = time.perf_counter()
    for step in range(100):
        c_dev, c_ref = dev.predict_cutoff(), ref.predict_cutoff()
        check(c_dev == c_ref, f"dmm parity step {step}: cutoff {c_dev} on "
              f"the card, {c_ref} from the numpy backend")
        cutoffs.append(c_dev)
        times = sim.step()
        mask = times <= order_stats.iter_time(times, c_dev) + 1e-12
        censored += int(not mask.all())
        dev.observe(times, mask)
        ref.observe(times, mask)
        a, b = dev.window_array()[-1], ref.window_array()[-1]
        win_err = max(win_err, float(np.abs(a - b).max()))
        check(_rel_close(a, b, WINDOW_TOL), f"dmm parity step {step}: "
              f"window rows differ by {win_err}")
    modes = sorted(k[0] for k in dev.graphs)
    emit("dmm_parity", steps=100, k_samples=32, cutoffs=cutoffs,
         distinct_cutoffs=len(set(cutoffs)), censored_steps=censored,
         window_max_abs_err=win_err, window_tol=WINDOW_TOL,
         graphs=[list(map(str, k)) for k in dev.graphs],
         replays=dev.replays, seconds=time.perf_counter() - t0)
    check(censored >= 50, f"only {censored} censored steps")
    check(len(set(cutoffs)) > 1, "one cutoff for every step")
    check(len(modes) == len(set(modes)) and all(k[1] for k in dev.graphs),
          f"graphs {list(dev.graphs)}: want one decision graph a mode")
    check(dev.replays == 101, f"{dev.replays} graph replays for 101 "
          f"decisions")

    # (d) timing at n = 8 and n = 158, K = 64, lag 20
    timing = {}
    for n in (8, 158):
        sims = ((lambda s: ClusterSim(n_workers=8, n_nodes=2, seed=s))
                if n == 8 else (lambda s: paper_cluster_158(seed=s)))
        tr = sims(3).run(40)
        rm = RuntimeModel(n, lag=20, device="cuda").init(1)
        rm.norm_scale = float(2.0 * tr[:21].mean())
        ctl = CutoffController(rm, k_samples=64, seed=0)
        ctl.seed_window(tr)
        sim = sims(4)
        obs_us, pred_us = [], []
        for i in range(45):
            t0 = time.perf_counter()
            c = ctl.predict_cutoff()
            t1 = time.perf_counter()
            times = sim.step()
            mask = times <= order_stats.iter_time(times, c) + 1e-12
            t2 = time.perf_counter()
            ctl.observe(times, mask)
            t3 = time.perf_counter()
            if i >= 5:        # the first steps capture the graphs
                pred_us.append((t1 - t0) * 1e6)
                obs_us.append((t3 - t2) * 1e6)
        key = max(ctl.graphs, key=lambda k: k[0] == "censored")
        graph = ctl.graphs[key]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reps = 50
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        per = kernels_per_call(torch, graph.replay)
        top = sorted(per.items(), key=lambda kv: -kv[1]["per_call"]
                     * kv[1]["us"])[:5]
        timing[n] = {
            "graph": list(map(str, key)),
            "decision_device_us": start.elapsed_time(end) / reps * 1e3,
            "observe_wall_us": float(np.median(obs_us)),
            "predict_cutoff_wall_us": float(np.median(pred_us)),
            "observe_plus_predict_wall_us": float(np.median(
                np.add(obs_us, pred_us))),
            "cuda_kernels_per_replay": sum(v["per_call"]
                                           for v in per.values()),
            "top_kernels": {k[:60]: v for k, v in top},
            "graphs_captured": len(ctl.graphs)}
        emit("dmm_timing", n=n, k_samples=64, lag=20, **timing[n])
        del ctl, graph
    torch.cuda.empty_cache()
    return timing


def phase_train_dmm(torch, cfg, params_f32, firstk_clocks):
    """Full-width qwen2-0.5b psum training (the train phase's setup) with
    the paper's controller: the DMM fitted on the card as
    examples/quickstart.py fits it, CutoffController(rm, k_samples=48)
    seeded with that trace.  Each step asserts the train phase's launch
    counts, a finite loss and one graph replay a decision; per step it
    prints the cutoff, the simulated clock, wall ms, predict_cutoff's
    wall µs and the device µs of the decision(s) launched in the step (CUDA
    events on the controller's stream around its launches).  Then the
    same trainer alternates first-k and the DMM for 6 steps, adjacent in
    time, to compare their wall per step."""
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import CutoffController, FirstKController
    from repro_torch.core.runtime_model.api import RuntimeModel
    from repro_torch.kernels import build

    W, S, B, n_steps = 8, 128, 16, 5
    t_setup = time.perf_counter()
    trace = ClusterSim(n_workers=W, n_nodes=2, seed=0).run(200)
    rm = RuntimeModel(n_workers=W, lag=20, device="cuda").init(0)
    t0 = time.perf_counter()
    fit = rm.fit(trace, steps=200, batch=8)
    fit_s = time.perf_counter() - t0
    ctl = CutoffController(rm, k_samples=48)
    ctl.seed_window(trace)
    params = cast(params_f32, "cuda", torch.bfloat16)
    tr, _ = _train_setup(torch, cfg, params, n_workers=W, seq=S, batch=B,
                         controller=ctl,
                         timer=ClusterSim(n_workers=W, n_nodes=2, seed=7))

    # instrumentation on this instance only: host clock around
    # predict_cutoff, CUDA events around each fused launch
    predict_us, launches_ev = [], []
    predict, launch = ctl.predict_cutoff, ctl._launch

    def timed_predict():
        t0 = time.perf_counter()
        c = predict()
        predict_us.append((time.perf_counter() - t0) * 1e6)
        return c

    def timed_launch(mode, decide):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(ctl._stream)
        launch(mode, decide)
        ev[1].record(ctl._stream)
        launches_ev.append(ev)

    ctl.predict_cutoff, ctl._launch = timed_predict, timed_launch
    want = {"flash_attention": cfg.n_layers * W, "masked_grad_agg": 1,
            "fused_adam": 1}
    totals = {}
    torch.cuda.synchronize()
    emit("train_dmm_setup", fit_steps=200, fit_batch=8, fit_seconds=fit_s,
         fit_loss_first=fit[0], fit_loss_last=fit[-1],
         norm_scale=rm.norm_scale, k_samples=48,
         seconds=time.perf_counter() - t_setup)
    for i in range(n_steps):
        build.LAUNCHES.clear()
        n_ev, replays = len(launches_ev), ctl.replays
        t0 = time.perf_counter()
        rec = tr.run(1)[-1]        # drains the loss: ends in a device sync
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        step_ev = launches_ev[n_ev:]
        for ev in step_ev:
            ev[1].synchronize()
        check(launches == want, f"dmm psum step {rec['step']}: launches "
              f"{launches}, want {want}")
        check(bool(np.isfinite(rec["loss"])),
              f"dmm step {rec['step']}: loss {rec['loss']}")
        check(ctl.replays - replays == len(step_ev) == (2 if i == 0 else 1),
              f"dmm step {rec['step']}: {ctl.replays - replays} replays "
              f"for {len(step_ev)} decisions")
        emit("train_dmm", mask_agg="psum", step=rec["step"],
             wall_ms=wall * 1e3, tokens_per_s=B * S / wall, c=rec["c"],
             n=rec["n"], loss=rec["loss"], clock=rec["clock"],
             firstk_clock=(firstk_clocks[i] if i < len(firstk_clocks)
                           else None),
             predict_cutoff_wall_us=predict_us[-1],
             decision_device_us=[s.elapsed_time(e) * 1e3
                                 for s, e in step_ev],
             launches=launches, graphs=len(ctl.graphs),
             max_memory_allocated=torch.cuda.max_memory_allocated())
    # the wall cost of the controller itself: psum steps of the same
    # trainer alternating first-k and the DMM (A B A B A B), adjacent in
    # time; not asserted
    firstk = FirstKController(W, backup=2)
    walls = {"firstk": [], "dmm": []}
    for i in range(6):
        name = "dmm" if i % 2 else "firstk"
        tr.controller = ctl if i % 2 else firstk
        t0 = time.perf_counter()
        tr.run(1)
        walls[name].append((time.perf_counter() - t0) * 1e3)
    emit("train_dmm_ab", order="firstk,dmm x3", wall_ms=walls,
         median_ms={k: float(np.median(v)) for k, v in walls.items()})
    del tr, params, ctl
    torch.cuda.empty_cache()
    return totals, rm


# ---------------------------------------------------------------------------
# Telemetry (repro_torch.obs) attached to the full-width DMM training, the
# multi-tenant server, the supervisor and serving: no kernel of its own;
# the training path runs flash_attention, masked_grad_agg and fused_adam.
# ---------------------------------------------------------------------------

OBS_STEPS, OBS_EVERY = 6, 3    # two drains of three decisions each
OBS_PS_TICKS, OBS_PS_WARM = 25, 5
OBS_PS_J = (1, 3, 8)           # the flush breakdown's job counts (K 64)


def _is_sync(w):
    return "synchroniz" in str(w.message)


class _Stamped:
    """A timer that stamps the host clock at each step's draw (one a
    step): the gaps are the step walls, warm-up step excluded."""

    def __init__(self, inner):
        self.inner, self.stamps = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self):
        self.stamps.append(time.perf_counter())
        return self.inner.step()


def _obs_train(torch, cfg, params_f32, rm, trace, obs=None, wrap=None):
    """train_dmm's setup (full width, bf16, CutoffController(rm, 48)
    seeded with ``trace``, psum, fused AdamW, ClusterSim seed 7) with
    drains every OBS_EVERY steps, run OBS_STEPS steps in one ``run`` with
    the sync debug mode at "warn".  ``obs`` is attached and the controller
    wrapped for it (``wrap``, when given, goes between the two).  Returns
    the history, the controller wrapper, the run's wall seconds with the
    gaps between step starts (ms), where the steps made synchronizing
    calls outside the drains (file:line of each) and how many each drain
    made."""
    import warnings

    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import CutoffController

    ctl = CutoffController(rm, k_samples=48)
    ctl.seed_window(trace)
    inner = wrap(ctl) if wrap is not None else ctl
    params = cast(params_f32, "cuda", torch.bfloat16)
    tr, _ = _train_setup(
        torch, cfg, params, n_workers=8, seq=128, batch=16,
        controller=obs.wrap(inner, policy="dmm") if obs else inner,
        timer=_Stamped(ClusterSim(n_workers=8, n_nodes=2, seed=7)))
    tr.metrics_every, tr.obs, tr.name = OBS_EVERY, obs, "dmm"
    drain, in_drains, drain_idx = tr._drain_metrics, [], set()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def counted():
            k = len(caught)
            drain()
            in_drains.append(sum(map(_is_sync, caught[k:])))
            drain_idx.update(range(k, len(caught)))

        tr._drain_metrics = counted
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            tr.run(OBS_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            del tr._drain_metrics
        wall = time.perf_counter() - t0
    syncs = [f"{Path(w.filename).name}:{w.lineno}"
             for i, w in enumerate(caught)
             if _is_sync(w) and i not in drain_idx]
    hist, step_ms = tr.history, np.diff(tr.timer.stamps) * 1e3
    del tr, params
    gc.collect()
    torch.cuda.empty_cache()
    return hist, inner, (wall, step_ms), syncs, in_drains


def _obs_ps(torch, rm, J, k_samples, obs=None, looped=False):
    """J jobs on train_dmm's width-8 model in one PSServer bucket
    (windows ClusterSim(8, 2 nodes, seed 30 + j), seeds 7 j), OBS_PS_TICKS
    ticks of the tick protocol (prefetch, predict, observe, flush).
    ``looped``: after each flush J looped CutoffControllers decide, as
    in ps_timing, so the next tick's launches meet a busy device.
    Returns the cutoff sequences, the final windows and, inside each
    flush, the host µs of the bucket's wait for its last launch and of
    its launch (upload, replay, fetch)."""
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import CutoffController
    from repro_torch.core.cutoff import order_stats
    from repro_torch.ps import PSServer

    srv = PSServer(obs=obs)
    ctls, loops = [], []
    for j in range(J):
        window = ClusterSim(n_workers=8, n_nodes=2, seed=30 + j).run(40)
        h = srv.admit(f"job{j}", rm, window=window, k_samples=k_samples,
                      seed=7 * j)
        ctls.append(obs.wrap(h, policy=f"job{j}") if obs else h)
        if looped:
            loops.append(CutoffController(rm, k_samples=k_samples,
                                          seed=7 * j))
            loops[-1].seed_window(window)
    b = next(iter(srv._buckets.values()))
    # host µs a flush spends in the bucket's waits and launches, summed
    # over the flush (its first launch captures, and the capture waits)
    parts, flushing = {"wait": [], "launch": []}, [False]

    def timed(name, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            if flushing[0]:
                parts[name][-1] += (time.perf_counter() - t0) * 1e6
            return out
        return run

    b.wait, b.launch = timed("wait", b.wait), timed("launch", b.launch)
    sims = [ClusterSim(n_workers=8, n_nodes=2, seed=50 + j)
            for j in range(J)]
    seqs = [[] for _ in range(J)]
    for _ in range(OBS_PS_TICKS):
        srv.prefetch()
        for j, ctl in enumerate(ctls):
            c = ctl.predict_cutoff()
            t = sims[j].step()
            ctl.observe(t, t <= order_stats.iter_time(t, c) + 1e-12)
            seqs[j].append(int(c))
        for v in parts.values():
            v.append(0.0)
        flushing[0] = True
        srv.flush()
        flushing[0] = False
        for j, ctl in enumerate(loops):
            c = ctl.predict_cutoff()
            t = sims[j].step()
            ctl.observe(t, t <= order_stats.iter_time(t, c) + 1e-12)
    if obs is not None:
        obs.drain()
    windows = [srv.window_array(f"job{j}") for j in range(J)]
    return seqs, windows, parts


def _obs_small_cost(torch, obs_cls, steps=36, reps=2):
    """Wall per step of supervised's small config (bench_tiny_config at
    head_dim 64, f32, Elfving over 6 workers), bare against obs attached
    (controller wrapped), in turns bare, obs, obs, bare."""
    from repro_torch import optim
    from repro_torch.cluster.simulator import paper_cluster_158
    from repro_torch.core.controller import ElfvingController
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import supervised as S
    from repro_torch.launch.train import Trainer, make_train_step
    from repro_torch.models import model as M

    cfg = S.supervised_config()
    opt = optim.adamw(3e-3)
    step_fn = make_train_step(cfg, opt)

    def run(with_obs, n):
        obs = obs_cls() if with_obs else None
        ctl = ElfvingController(SUP_WORKERS)
        tr = Trainer(step_fn=step_fn, data=SyntheticTokens(
            vocab_size=cfg.vocab_size, seq_len=8, global_batch=60, seed=0),
            controller=obs.wrap(ctl, policy="elfving") if obs else ctl,
            timer=paper_cluster_158(1, n_workers=SUP_WORKERS),
            n_workers=SUP_WORKERS, obs=obs, name="small")
        params = M.init_model(cfg, torch.Generator().manual_seed(0),
                              device="cuda")
        tr.restore_or_init(lambda: {"params": params,
                                    "opt": opt.init(params)})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6, tr.history

    run(False, 5)                       # warm-up: allocator, cuBLAS
    us = {"bare": [], "obs": []}
    hists = {}
    for with_obs in (False, True) * reps:
        key = "obs" if with_obs else "bare"
        step_us, hists[key] = run(with_obs, steps)
        us[key].append(step_us)
    same = [h["loss"] for h in hists["bare"]] == [h["loss"]
                                                  for h in hists["obs"]]
    return us, same


def phase_obs(torch, cfg, params_f32, rm):
    """Telemetry attached to the paths already on the card, each held
    against its bare twin bit for bit:

    * full-width qwen2-0.5b DMM training (train_dmm's setup and fitted
      model): a checking run whose controller is peeked synchronously
      (``.cpu()`` of the sample cloud) at every decision, then bare, then
      with an ObsRun writing its four streams.  Losses and cutoffs equal;
      every decision scored from its own samples (each recorded pred_iter
      equals the peek's); the synchronizing calls between drains equal
      with obs on and off; the kernel launches of the obs run;
    * PSServer at J = 3 (K 16) obs on against off: cutoffs and windows
      equal, ps.dispatch one level inside ps.flush, every record scored;
      then the host µs of ps.flush and ps.dispatch at J = 1, 3, 8 (K 64),
      the dispatch split into the bucket's wait and its launch, on an
      idle device and with J looped controllers between ticks;
    * the supervised storm obs on against off (losses, cutoffs, the drill
      report equal) and supervisor.tick's µs from its spans;
    * one short full-width request served obs on against off (ids equal);
    * the cost: step wall bare against obs at supervised's small config
      and at full width; ring push, drain and span µs;
    * the artifacts rendered by ``python -m repro_torch.obs`` (and
      ``--chrome``), the timeline summary on one line."""
    import os
    import tempfile

    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import _PolicyWrapper
    from repro_torch.kernels import build
    from repro_torch.launch import supervised as S
    from repro_torch.obs import ObsRun, report
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.engine import ServeEngine

    trace = ClusterSim(n_workers=8, n_nodes=2, seed=0).run(200)

    class Peek(_PolicyWrapper):
        """Checking run only: E[x_(c)] from a synchronous fetch of the
        sample cloud at each decision (the scorer's formula)."""

        def __init__(self, inner):
            super().__init__(inner)
            self.pred = []

        def predict_cutoff(self):
            c = self.inner.predict_cutoff()
            s = self.inner.predicted_samples()
            self.pred.append(None if s is None else float(np.sort(
                s.cpu().numpy().astype(np.float64), axis=1)[:, c - 1]
                .mean()))
            return c

    # -- full width: the checking run first (it also takes whatever a
    # first run after train_dmm does once), then bare and obs -----------
    chk_obs = ObsRun()
    chk, peek, _, _, _ = _obs_train(torch, cfg, params_f32, rm, trace,
                                    obs=chk_obs, wrap=Peek)
    bare, _, bare_s, bare_syncs, bare_drains = _obs_train(
        torch, cfg, params_f32, rm, trace)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as d:
        obs = ObsRun(os.path.join(d, "run"))
        build.LAUNCHES.clear()
        inst, _, obs_s, obs_syncs, obs_drains = _obs_train(
            torch, cfg, params_f32, rm, trace, obs=obs)
        launches = dict(build.LAUNCHES)
        obs.close()
        key = lambda h: [(r["c"], r["loss"]) for r in h]
        check(key(inst) == key(bare) == key(chk),
              f"obs: losses or cutoffs differ with obs on: bare "
              f"{key(bare)}, obs {key(inst)}, checking {key(chk)}")
        recs = obs.decisions.records
        check(len(recs) == OBS_STEPS and all(
            r["pred_iter"] is not None for r in recs),
            f"obs: {len(recs)} decisions recorded, "
            f"{sum(r['pred_iter'] is None for r in recs)} without samples")
        got = [r["pred_iter"] for r in chk_obs.decisions.records]
        check(got == peek.pred and [r["pred_iter"] for r in recs] == got,
              f"obs: recorded pred_iter {got} (obs run "
              f"{[r['pred_iter'] for r in recs]}) against the peeks "
              f"{peek.pred}")
        check(len(bare_drains) == len(obs_drains) >= 2,
              f"obs: drains {bare_drains} bare, {obs_drains} obs")
        check(obs_syncs == bare_syncs,
              f"obs: synchronizing calls between drains with obs "
              f"{obs_syncs}, bare {bare_syncs}")
        want = {"flash_attention": cfg.n_layers * 8 * OBS_STEPS,
                "masked_grad_agg": OBS_STEPS, "fused_adam": OBS_STEPS}
        check(launches == want, f"obs run launched {launches}, want {want}")
        spans = obs.trace.spans
        step_us = [s["dur_us"] for s in spans if s["name"] == "trainer.step"]
        emit("obs_train", arch=cfg.name, steps=OBS_STEPS,
             metrics_every=OBS_EVERY, cutoffs=[r["c"] for r in inst],
             losses_equal=True, decisions=len(recs),
             pred_iter=[r["pred_iter"] for r in recs],
             peek_pred_iter=peek.pred,
             syncs_between_drains={"bare": len(bare_syncs),
                                   "obs": len(obs_syncs)},
             sync_sites=sorted(set(bare_syncs)),
             syncs_in_drains={"bare": bare_drains, "obs": obs_drains},
             run_seconds={"bare": bare_s[0], "obs": obs_s[0]},
             step_gap_ms={"bare": bare_s[1].tolist(),
                          "obs": obs_s[1].tolist()},
             step_gap_ms_median={"bare": float(np.median(bare_s[1])),
                                 "obs": float(np.median(obs_s[1]))},
             trainer_step_span_us_median=float(np.median(step_us)),
             launches=launches)
        rows = report.timeline_summary(spans)
        emit("obs_timeline", rows=rows)
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(
            Path(__file__).resolve().parent / "src"))
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs", os.path.join(d, "run"),
             "--chrome", os.path.join(d, "trace.json")],
            capture_output=True, text=True, env=env, timeout=120)
        check(cli.returncode == 0 and "decision quality" in cli.stdout
              and "trainer.step" in cli.stdout,
              f"obs: the CLI failed ({cli.returncode}): {cli.stderr[-2000:]}")
        with open(os.path.join(d, "trace.json")) as f:
            n_chrome = len(json.load(f)["traceEvents"])
        emit("obs_cli", seconds=time.perf_counter() - t0,
             chrome_events=n_chrome, lines=len(cli.stdout.splitlines()))
    del bare, inst, chk

    # -- the multi-tenant server ----------------------------------------
    bare_seqs, bare_w, _ = _obs_ps(torch, rm, 3, 16)
    ps_obs = ObsRun()
    inst_seqs, inst_w, _ = _obs_ps(torch, rm, 3, 16, obs=ps_obs)
    check(inst_seqs == bare_seqs and all(
        np.array_equal(a, b) for a, b in zip(inst_w, bare_w)),
        "obs: the server's cutoffs or windows differ with obs on")
    by = {}
    for s in ps_obs.trace.spans:
        by.setdefault(s["name"], []).append(s)
    depth = by["ps.flush"][0]["depth"]
    check(len(by["ps.flush"]) == len(by["ps.dispatch"]) == OBS_PS_TICKS
          and all(s["depth"] == depth + 1 for s in by["ps.dispatch"]),
          "obs: ps.dispatch is not one level inside every ps.flush")
    recs = ps_obs.decisions.records
    check(len(recs) == 3 * OBS_PS_TICKS
          and all(r["pred_iter"] is not None for r in recs),
          "obs: server decisions unscored")
    breakdown = {}
    for looped in (False, True):
        for J in OBS_PS_J:
            t_obs = ObsRun()
            _, _, parts = _obs_ps(torch, rm, J, 64, obs=t_obs,
                                  looped=looped)
            flush = [s["dur_us"] for s in t_obs.trace.spans
                     if s["name"] == "ps.flush"][OBS_PS_WARM:]
            disp = [s["dur_us"] for s in t_obs.trace.spans
                    if s["name"] == "ps.dispatch"][OBS_PS_WARM:]
            wait = parts["wait"][OBS_PS_WARM:]
            launch = parts["launch"][OBS_PS_WARM:]
            med = lambda v: float(np.median(v))
            breakdown[("looped_" if looped else "") + f"J{J}"] = {
                "flush_us": med(flush), "dispatch_us": med(disp),
                "flush_minus_dispatch_us": med(np.subtract(flush, disp)),
                "wait_us": med(wait), "launch_us": med(launch),
                "dispatch_rest_us": med(np.subtract(
                    disp, np.add(wait, launch))),
                "ticks": len(flush)}
    emit("obs_ps", J=3, k_samples=16, ticks=OBS_PS_TICKS,
         cutoffs_equal=True, windows_equal=True, decisions=len(recs),
         breakdown_k64=breakdown)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the supervisor ---------------------------------------------------
    sup_bare = S.run_supervised(steps=SUP_STEPS, n_workers=SUP_WORKERS,
                                device="cuda", verbose=False)
    sup_obs = ObsRun()
    sup_inst = S.run_supervised(steps=SUP_STEPS, n_workers=SUP_WORKERS,
                                device="cuda", verbose=False, obs=sup_obs)
    sk = lambda out: [(h["n"], h["c"], h["loss"]) for h in out["history"]]
    check(sk(sup_inst) == sk(sup_bare) and sup_inst["match"]
          and sup_inst["report"] == sup_bare["report"],
          "obs: the supervised storm differs with obs on")
    tick_us = [s["dur_us"] for s in sup_obs.trace.spans
               if s["name"] == "supervisor.tick"]
    counters = sup_obs.metrics.summary()["counters"]
    check(len(tick_us) == SUP_STEPS
          and counters["supervisor.ticks"] == SUP_STEPS,
          f"obs: {len(tick_us)} supervisor.tick spans, counters {counters}")
    small_us, small_same = _obs_small_cost(torch, ObsRun)
    check(small_same, "obs: the small config's losses differ with obs on")

    # -- serving ----------------------------------------------------------
    params = cast(params_f32, "cuda", torch.bfloat16)
    engine = ServeEngine(cfg, params, device="cuda")
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(1, 16), dtype=np.int32)
    ids_bare = engine.generate(prompt, 8)
    engine.obs = serve_obs = ObsRun()
    ids_obs = engine.generate(prompt, 8)
    names = [s["name"] for s in serve_obs.trace.spans]
    check(np.array_equal(ids_bare, ids_obs)
          and names == ["serve.prefill", "serve.decode", "serve.fetch"],
          f"obs: served ids differ with obs on ({names})")
    del engine, params
    torch.cuda.empty_cache()

    # -- the collectors' own costs ---------------------------------------
    ring = MetricsRegistry().ring("cost", ("loss", "gnorm", "c",
                                           "iter_time"))
    loss = torch.ones((), device="cuda")
    for _ in range(20):
        ring.push((loss, loss, 5.0, 0.5))
    ring.drain()
    t0 = time.perf_counter()
    for _ in range(200):
        ring.push((loss, loss, 5.0, 0.5))
    push_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drained = ring.drain()
    drain_us = (time.perf_counter() - t0) * 1e6
    check(len(drained["rows"]) == 200, "obs: ring drain lost rows")
    tracer = Tracer()
    t0 = time.perf_counter()
    for _ in range(1000):
        with tracer.span("cost", track="t"):
            pass
    span_us = (time.perf_counter() - t0) / 1000 * 1e6
    emit("obs_cost", small_config_step_us=small_us,
         small_config_obs_over_bare=(float(np.median(small_us["obs"]))
                                     / float(np.median(small_us["bare"]))),
         full_width_step_gap_ms_median={
             "bare": float(np.median(bare_s[1])),
             "obs": float(np.median(obs_s[1]))},
         full_width_obs_over_bare=(float(np.median(obs_s[1]))
                                   / float(np.median(bare_s[1]))),
         ring_push_us=push_us, ring_drain_200_rows_us=drain_us,
         span_us=span_us, supervisor_tick_us_median=float(
             np.median(tick_us)), supervisor_tick_us_max=float(
             np.max(tick_us)), supervisor_counters=counters,
         serve_spans=names)
    return launches


# ---------------------------------------------------------------------------
# The straggler-policy frontier, compression and the checkpoint store on
# the full-width psum setup: no kernel of their own; the fold, the Elfving
# math and the compression are plain torch, the dropped mean and the
# anytime combine go through masked_grad_agg.
# ---------------------------------------------------------------------------

CKPT_SLACK = 1.05   # free space wanted beyond the checkpoint's bytes


def _cpu_copy(torch, t):
    """Leaves of a tree as a list of CPU copies (bit-exact compares)."""
    from repro_torch import tree

    return [x.detach().to("cpu", copy=True) for x in tree.leaves(t)]


def _bit_equal(torch, a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_train_policies(torch, cfg, params_f32, rm):
    """Full-width qwen2-0.5b psum training (train's setup: bf16, W 8, seq
    128, batch 16, fused AdamW, ClusterSim(8, 2 nodes, seed 7)) under the
    other straggler policies, with checkpoint/resume and compression:

      1. stale reuse: StaleReuseController(CutoffController(rm, 48),
         decay 0.5), 5 steps, 2 masked_grad_agg launches a step (the
         fresh and the dropped mean); the Trainer checkpoints at step 2
         (AsyncCheckpointer, a temporary directory);
      2. resume: a fresh Trainer restored from step 2 (the timer advanced
         to step 2) takes steps 3-4: params, m and v bit-equal to the
         uninterrupted run's, the same c; then from the same checkpoint 2
         steps with decay 0 against 2 discard steps (a plain psum step,
         the bare CutoffController): params bit-equal;
      3. Elfving: ElfvingController(8, warmup 2), 3 steps on
         paper_cluster_158(seed 0, n_workers 8): c below 8 after the
         warm-up (on ClusterSim(8, 2 nodes, seed 7) the runtimes' sd is
         9% of their mean and Eq. 3 keeps every worker);
      4. anytime: AnytimeController(FirstKController(8, 2), n_micro 2),
         grad_accum 2, 2 steps: flash 2 x 24 x 8 a step, a contribution
         strictly inside (0, 1);
      5. compression: compress_pod_grads, 2 steps, the ef residual's
         largest magnitude against the quantization step.

    ``rm`` is train_dmm's fitted RuntimeModel; the window is seeded with
    the trace it was fitted on.  Each trainer is freed before the next:
    a psum step holds its (8, 494,032,768) f32 buffer."""
    import shutil
    import tempfile

    from repro_torch import optim, tree
    from repro_torch.checkpoint import store
    from repro_torch.cluster.simulator import ClusterSim, paper_cluster_158
    from repro_torch.core.controller import (AnytimeController,
                                             CutoffController,
                                             ElfvingController,
                                             FirstKController,
                                             StaleReuseController)
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import build
    from repro_torch.launch.train import Trainer, make_train_step

    W, S, B, L = 8, 128, 16, cfg.n_layers
    want = {"flash_attention": L * W, "masked_grad_agg": 1, "fused_adam": 1}
    want_stale = dict(want, masked_grad_agg=2)
    trace = ClusterSim(n_workers=W, n_nodes=2, seed=0).run(200)
    opt = optim.adamw(optim.cosine_schedule(3e-4, 2, 20), fused=True)
    totals, out = {}, {"seconds": {}}
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    def timer(steps=0):
        sim = ClusterSim(n_workers=W, n_nodes=2, seed=7)
        for _ in range(steps):
            sim.step()
        return sim

    def dmm():
        ctl = CutoffController(rm, k_samples=48)
        ctl.seed_window(trace)
        return ctl

    def trainer(step_fn, controller, sim, params=None, **kw):
        params = (params if params is not None
                  else cast(params_f32, "cuda", torch.bfloat16))
        tr = Trainer(step_fn=step_fn, data=SyntheticTokens(
            vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=SEED),
            controller=controller, timer=sim, n_workers=W, mask_agg="psum",
            metrics_every=1, **kw)
        return tr.restore_or_init(
            lambda: {"params": params, "opt": opt.init(params)})

    def drive(tr, n_steps, policy, want_l):
        recs = []
        for _ in range(n_steps):
            build.LAUNCHES.clear()
            t0 = time.perf_counter()
            rec = tr.run(1)[-1]     # drains the loss: ends in a device sync
            wall = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            check(launches == want_l, f"{policy} step {rec['step']}: "
                  f"launches {launches}, want {want_l}")
            check(bool(np.isfinite(rec["loss"])),
                  f"{policy} step {rec['step']}: loss {rec['loss']}")
            emit("train_policies", policy=policy, step=rec["step"],
                 wall_ms=wall * 1e3, c=rec["c"], n=rec["n"],
                 loss=rec["loss"], clock=rec["clock"], launches=launches,
                 max_memory_allocated=torch.cuda.max_memory_allocated())
            recs.append(rec)
        return recs

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # (1) stale reuse, checkpointed at step 2
        n_params = sum(x.numel() for x in tree.leaves(params_f32))
        need = n_params * (2 + 4 + 4 + 2)   # bf16 p, f32 m and v, bf16 stale
        free = shutil.disk_usage(ckpt_dir).free
        check(free >= CKPT_SLACK * need, f"{ckpt_dir}: {free} bytes free, "
              f"the checkpoint needs {need} (x {CKPT_SLACK})")
        stale_step = make_train_step(cfg, opt, mask_agg="psum",
                                     stale_reuse=True)
        tr = trainer(stale_step, StaleReuseController(dmm(), decay=0.5),
                     timer(), ckpt_dir=ckpt_dir, ckpt_every=2)
        ckpt_s = {}
        write, snapshot = store.save, store.AsyncCheckpointer.save

        def timed_write(*args, **kw):
            t0 = time.perf_counter()
            path = write(*args, **kw)
            ckpt_s["write"] = time.perf_counter() - t0
            return path

        def timed_snapshot(self, *args, **kw):
            t0 = time.perf_counter()
            snapshot(self, *args, **kw)
            ckpt_s["snapshot"] = time.perf_counter() - t0

        store.save, store.AsyncCheckpointer.save = timed_write, timed_snapshot
        try:
            recs = drive(tr, 2, "stale_reuse", want_stale)
        finally:
            store.save, store.AsyncCheckpointer.save = write, snapshot
        tr.ckpt_dir = None                  # one checkpoint, at step 2
        step_dir = Path(ckpt_dir) / f"step_{2:010d}"
        ckpt_bytes = {p.name: p.stat().st_size for p in step_dir.iterdir()}
        check(store.list_steps(ckpt_dir) == [2]
              and store.groups(ckpt_dir, 2) == ["ctl", "meta", "stale",
                                                "state"],
              f"checkpoint {store.list_steps(ckpt_dir)}: groups "
              f"{store.groups(ckpt_dir, 2)}")
        recs += drive(tr, 2, "stale_reuse", want_stale)
        after4 = (_cpu_copy(torch, tr.state["params"]),
                  _cpu_copy(torch, tr.state["opt"]["m"]),
                  _cpu_copy(torch, tr.state["opt"]["v"]))
        recs += drive(tr, 1, "stale_reuse", want_stale)
        check(min(r["c"] for r in recs) < W, f"stale reuse: no step "
              f"dropped a worker: c {[r['c'] for r in recs]}")
        out["stale_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["stale_c"] = [r["c"] for r in recs]
        emit("train_policies_checkpoint", step=2, bytes=ckpt_bytes,
             total_bytes=sum(ckpt_bytes.values()),
             snapshot_s=ckpt_s["snapshot"], write_s=ckpt_s["write"],
             free_bytes=free, stale_max_memory_allocated=out[
                 "stale_peak_bytes"])
        del tr
        torch.cuda.empty_cache()

        # (2) resume from step 2: bit-equal to the uninterrupted steps 3-4
        t0 = time.perf_counter()
        tr = trainer(stale_step, StaleReuseController(dmm(), decay=0.5),
                     timer(2), ckpt_dir=ckpt_dir)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(tr.step == 2 and tr.controller._step == 2
              and tr._stale is not None, f"restored step {tr.step}, "
              f"controller step {tr.controller._step}")
        resumed = drive(tr, 2, "stale_reuse_resumed", want_stale)
        got = (_cpu_copy(torch, tr.state["params"]),
               _cpu_copy(torch, tr.state["opt"]["m"]),
               _cpu_copy(torch, tr.state["opt"]["v"]))
        same = {k: _bit_equal(torch, a, b)
                for k, a, b in zip(("params", "m", "v"), got, after4)}
        same_c = [r["c"] for r in resumed] == out["stale_c"][2:4]
        emit("train_policies_resume", restore_s=restore_s,
             c=[r["c"] for r in resumed], uninterrupted_c=out["stale_c"][2:4],
             bit_equal=same)
        check(all(same.values()) and same_c, f"resumed run differs from "
              f"the uninterrupted one: {same}, c {same_c}")
        del tr, got, after4
        torch.cuda.empty_cache()

        # decay 0 against discard, both from the step-2 checkpoint
        tr = trainer(stale_step, StaleReuseController(dmm(), decay=0.0),
                     timer(2), ckpt_dir=ckpt_dir)
        d0 = drive(tr, 2, "stale_decay0", want_stale)
        d0_params = _cpu_copy(torch, tr.state["params"])
        del tr, stale_step
        torch.cuda.empty_cache()
        plain_step = make_train_step(cfg, opt, mask_agg="psum")
        tr = trainer(plain_step, dmm(), timer(2), ckpt_dir=ckpt_dir)
        discard = drive(tr, 2, "discard", want)
        same = _bit_equal(torch, _cpu_copy(torch, tr.state["params"]),
                          d0_params)
        emit("train_policies_decay0", c=[r["c"] for r in d0],
             discard_c=[r["c"] for r in discard], params_bit_equal=same)
        check(same and [r["c"] for r in d0] == [r["c"] for r in discard],
              "decay 0 differs from discard")
        del tr, d0_params
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # (3) Elfving, on the discard step (its buffer reused)
    tr = trainer(plain_step, ElfvingController(W, warmup=2),
                 paper_cluster_158(seed=0, n_workers=W))
    elf = drive(tr, 3, "elfving", want)
    check(elf[-1]["c"] < W, f"elfving: c {[r['c'] for r in elf]}, want a "
          f"cut after the warm-up")
    del tr, plain_step
    torch.cuda.empty_cache()

    # (4) anytime: fractional contributions through the same kernel
    contribs = []
    ctl = AnytimeController(FirstKController(W, backup=2), n_micro=2)
    contribution = ctl.contribution

    def recorded(times, c):
        contribs.append(contribution(times, c))
        return contribs[-1]

    ctl.contribution = recorded
    tr = trainer(make_train_step(cfg, opt, mask_agg="psum", grad_accum=2),
                 ctl, timer())
    drive(tr, 2, "anytime", dict(want, flash_attention=2 * L * W))
    fractional = [float(f) for fs in contribs for f in fs if 0 < f < 1]
    emit("train_policies_anytime", contributions=[c.tolist()
                                                  for c in contribs])
    check(bool(fractional), f"anytime: no fractional contribution in "
          f"{[c.tolist() for c in contribs]}")
    del tr, ctl
    torch.cuda.empty_cache()

    # (5) compression: the optimizer sees the dequantized gradient
    qstep = []

    def update(grads, state, params=None):
        qstep.append(torch.stack([g.float().abs().max()
                                  for g in tree.leaves(grads)]) / 127.0)
        return opt.update(grads, state, params)

    qopt = optim.Optimizer(opt.init, update, opt.table)
    tr = trainer(make_train_step(cfg, qopt, mask_agg="psum",
                                 compress_pod_grads=True),
                 FirstKController(W, backup=2), timer())
    drive(tr, 2, "compressed", want)
    ef_max = torch.stack([e.abs().max() for e in tree.leaves(
        tr.state["ef"])])
    ratio = float((ef_max / qstep[-1].clamp(min=1e-30)).max())
    emit("train_policies_compression", ef_max_abs=float(ef_max.max()),
         quant_step_max=float(qstep[-1].max()), ef_over_step_max=ratio,
         ef_bytes=sum(e.numel() * 4 for e in tree.leaves(tr.state["ef"])))
    # |ef| <= step / 2 per leaf; the step is read back from bf16 values
    check(bool((ef_max <= 0.51 * qstep[-1] + 1e-12).all()),
          f"ef residual beyond half a quantization step: {ratio}")
    del tr, qopt
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    emit("train_policies_summary", **out, launches=totals)
    return totals


# ---------------------------------------------------------------------------
# Elastic membership on the full-width psum setup: the ElasticController
# with its async DMM refit through an 8 -> 6 -> 8 churn.  No kernel of its
# own; the psum step's three kernels run at W = 6.
# ---------------------------------------------------------------------------

ELASTIC_BATCH = 24     # divisible by 8 and by 6 (train's 16 is not by 6)
ELASTIC_LAG = 10       # launch/elastic.py's DMM
REFIT_STEPS = 60
REFIT_FRESH = 3
KILL_AT = 6            # ChurnSim steps: kill (6, 7) here, restore later
ELASTIC_CKPT = 12      # the mid-churn checkpoint (width 6)
# the schedule's sizing: a width's first REFIT_FRESH steps feed the refit,
# which may run REFIT_SLOWDOWN x its lone wall beside the trainer (they
# share the interpreter lock: up to 5.3x in a run on an H100 80GB HBM3 at
# 700 W), over steps of at least STEP_S_MIN seconds (medians of 0.84-2.11
# s there); then 2 DMM steps.  Both bounds sit outside what was measured.
REFIT_SLOWDOWN = 6.0
STEP_S_MIN = 0.7


def _elastic_capture(torch, rm, trace):
    """A width-8 refit of REFIT_STEPS steps on the card through
    ``_spawn_refit`` (``ElasticController._fit_model``: a stream of its
    own) while the main thread builds a CutoffController on ``rm`` and
    makes 5 decisions (2 graph captures, then replays).  Against the
    same decisions with no fit running (identical cutoffs) and the same
    fit alone (its loss trajectory)."""
    from repro_torch.cluster.simulator import paper_cluster_158
    from repro_torch.core.controller import (CutoffController,
                                             ElasticController,
                                             _poll_refit_task, _spawn_refit)
    from repro_torch.core.runtime_model.api import RuntimeModel

    ectl = ElasticController(rm, k_samples=32, seed=0,
                             refit_steps=REFIT_STEPS)
    losses = []
    fit = RuntimeModel.fit

    def recorded_fit(self, *args, **kw):
        out = fit(self, *args, **kw)
        losses.append(out)
        return out

    def decide():
        t0 = time.perf_counter()
        ctl = CutoffController(rm, k_samples=32, seed=0)
        ctl.seed_window(trace)
        sim = paper_cluster_158(seed=5, n_workers=8)
        cutoffs = []
        for _ in range(5):
            c = ctl.predict_cutoff()
            cutoffs.append(c)
            times = sim.step()
            mask = np.zeros(8, bool)
            mask[np.argsort(times)[:c]] = True
            ctl.observe(times, mask)
        ctl._wait()
        return {"cutoffs": cutoffs, "graphs": len(ctl.graphs),
                "replays": ctl.replays, "s": time.perf_counter() - t0}

    def refit():
        return _spawn_refit(lambda: ectl._fit_model(trace, 8, 1), 0)

    def finish(task):
        task[0].join(timeout=600)
        check(not task[0].is_alive(), "refit thread still running")
        done, model, err = _poll_refit_task(task, 0, 8)
        if err is not None:
            raise RuntimeError(f"refit raised: {err!r}") from err
        check(done and model is not None, "refit gave no model")
        return model

    RuntimeModel.fit = recorded_fit
    try:
        alone = decide()
        t0 = time.perf_counter()
        finish(refit())
        refit_alone_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        task = refit()
        time.sleep(0.3)             # the fit is inside its step loop
        busy = decide()
        alive = task[0].is_alive()
        finish(task)
        refit_busy_s = time.perf_counter() - t0
    finally:
        RuntimeModel.fit = fit
    a, b = (np.asarray(x) for x in losses)
    scale = float(np.abs(a).max())
    fit_err = float(np.abs(a - b).max())
    out = {"refit_steps": REFIT_STEPS, "refit_alone_s": refit_alone_s,
           "refit_beside_captures_s": refit_busy_s,
           "decisions_alone_s": alone["s"],
           "decisions_beside_refit_s": busy["s"],
           "cutoffs": busy["cutoffs"], "cutoffs_no_fit": alone["cutoffs"],
           "graphs": busy["graphs"], "replays": busy["replays"],
           "fit_alive_after_decisions": alive,
           "fit_losses_bit_equal": bool(np.array_equal(a, b)),
           "fit_loss_max_abs_err": fit_err, "fit_loss_tol": FIT_TOL * scale,
           "fit_loss_first_last": [a[0], a[-1]]}
    emit("elastic_capture", **out)
    check(alive, "the refit ended before the decisions did: nothing was "
          "captured beside it")
    check(busy["cutoffs"] == alone["cutoffs"], f"cutoffs beside a refit "
          f"{busy['cutoffs']}, alone {alone['cutoffs']}")
    check(busy["graphs"] == alone["graphs"] >= 2, f"graphs {busy['graphs']} "
          f"beside the refit, {alone['graphs']} alone")
    check(fit_err <= FIT_TOL * scale, f"the refit beside the captures "
          f"drifted from the lone fit by {fit_err} > {FIT_TOL} x {scale}")
    return out


def phase_train_elastic(torch, cfg, params_f32):
    """Full-width qwen2-0.5b psum training (bf16, seq 128, batch 24, fused
    AdamW) through an 8 -> 6 -> 8 churn under ElasticController(rm,
    k_samples 32, refit_steps 60, refit_fresh 3, fallback_warmup 2,
    refit_async): rm is RuntimeModel(8, lag 10) fitted on the card on
    paper_cluster_158(0, 8).run(120) for 150 steps (launch/elastic.py's
    fit), seeded with the trace's last 40 rows; the timer
    ChurnSim(paper_cluster_158(1, 8)) kills workers 6 and 7 at step 6 and
    restores them after a gap sized from the refit's measured wall.

    First the concurrency check (``_elastic_capture``).  Then every step
    asserts the launches at its width, a finite loss and 1 <= c <= n; the
    widths run 8, 6, 8, and at each new width the fallback decides first,
    then the refitted DMM, before the next event.  A checkpoint at step 12
    (width 6); once the first trainer is freed, a fresh trainer built at
    width 8 restores it: width 6, members 0..5, the window allclose to the
    saved one; 2 steps.  One masked_grad_agg call timed on the trainer's
    own (6, N) buffer."""
    import shutil
    import tempfile

    from repro_torch import optim, tree
    from repro_torch.checkpoint import store
    from repro_torch.cluster.simulator import (ChurnEvent, ChurnSim,
                                               paper_cluster_158)
    from repro_torch.core.controller import ElasticController
    from repro_torch.core.runtime_model.api import RuntimeModel
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import reference_masked_agg
    from repro_torch.launch.train import Trainer, make_train_step

    W, S, B, L = 8, 128, ELASTIC_BATCH, cfg.n_layers
    t_phase = time.perf_counter()
    trace = paper_cluster_158(0, n_workers=W).run(120)
    rm = RuntimeModel(W, lag=ELASTIC_LAG, device="cuda").init(0)
    t0 = time.perf_counter()
    fit = rm.fit(trace, steps=150, batch=8, seed=0)
    fit_s = time.perf_counter() - t0
    capture = _elastic_capture(torch, rm, trace)

    gap = REFIT_FRESH + math.ceil(REFIT_SLOWDOWN * capture["refit_alone_s"]
                                  / STEP_S_MIN) + 2
    gap = max(gap, ELASTIC_CKPT - KILL_AT + 1)
    restore_at, n_steps = KILL_AT + gap, KILL_AT + 2 * gap
    opt = optim.adamw(optim.cosine_schedule(3e-4, 2, 20), fused=True)
    out = {"fit_seconds": fit_s, "fit_loss_first_last": [fit[0], fit[-1]],
           "schedule": {"kill": KILL_AT, "restore": restore_at,
                        "steps": n_steps, "checkpoint": ELASTIC_CKPT}}

    def churn(steps_done=0):
        sim = ChurnSim(paper_cluster_158(1, n_workers=W),
                       [ChurnEvent(step=KILL_AT, kill=(6, 7)),
                        ChurnEvent(step=restore_at, restore=(6, 7))])
        for _ in range(steps_done):
            sim.step()
        return sim

    def elastic():
        ctl = ElasticController(rm, k_samples=32, seed=0,
                                refit_steps=REFIT_STEPS,
                                refit_fresh=REFIT_FRESH, fallback_warmup=2,
                                refit_async=True)
        ctl.seed_window(trace[-40:])
        return ctl

    def trainer(ctl, sim, **kw):
        params = cast(params_f32, "cuda", torch.bfloat16)
        tr = Trainer(step_fn=make_train_step(cfg, opt, mask_agg="psum"),
                     data=SyntheticTokens(vocab_size=cfg.vocab_size,
                                          seq_len=S, global_batch=B,
                                          seed=SEED),
                     controller=ctl, timer=sim, n_workers=W,
                     mask_agg="psum", metrics_every=1, **kw)
        return tr.restore_or_init(
            lambda: {"params": params, "opt": opt.init(params)})

    totals = {}

    def one_step(tr, phase, ctl, extra=None):
        job = ctl._refit_job
        alive0 = job is not None and job[0].is_alive()
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        rec = tr.run(1)[-1]        # drains the loss: ends in a device sync
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        n, c = rec["n"], rec["c"]
        want = {"flash_attention": L * n, "masked_grad_agg": 1,
                "fused_adam": 1}
        check(launches == want, f"{phase} step {rec['step']} (n {n}): "
              f"launches {launches}, want {want}")
        check(bool(np.isfinite(rec["loss"])),
              f"{phase} step {rec['step']}: loss {rec['loss']}")
        check(1 <= c <= n, f"{phase} step {rec['step']}: c {c} of {n}")
        job = ctl._refit_job
        r = {"step": rec["step"], "n": n, "c": c, "mode": modes[-1],
             "refit_in_flight": [alive0,
                                 job is not None and job[0].is_alive()],
             "graphs": len(ctl._dmm.graphs) if ctl._dmm is not None else 0,
             "wall_ms": wall * 1e3, "loss": rec["loss"],
             "clock": rec["clock"], "launches": launches,
             "max_memory_allocated": torch.cuda.max_memory_allocated(),
             "memory_reserved": torch.cuda.memory_reserved(), **(extra or {})}
        emit(phase, **r)
        return r

    # instrumentation on this instance only: the mode of each decision,
    # the refits' fit time on their thread, and when each install happened
    modes, refits = [], []
    ctl = elastic()
    predict, fit_model, install = (ctl.predict_cutoff, ctl._fit_model,
                                   ctl._install_dmm)

    def traced_predict():
        c = predict()
        modes.append(ctl.mode)
        return c

    def timed_fit(rows, n, seed):
        r = {"n": n, "seed": seed, "rows": len(rows),
             "spawned": time.perf_counter(), "spawn_step": tr.step}
        refits.append(r)
        model = fit_model(rows, n, seed)
        r["fit_s"] = time.perf_counter() - r["spawned"]
        return model

    def timed_install(model):
        install(model)
        r = refits[-1]
        r["spawn_to_install_s"] = time.perf_counter() - r["spawned"]
        r["install_step"] = tr.step + 1

    ctl.predict_cutoff, ctl._fit_model = traced_predict, timed_fit
    ctl._install_dmm = timed_install
    bufs = []
    aggregate = ops.WorkerGrads.aggregate

    def kept_aggregate(self, mask):
        bufs[:] = [self]           # the psum step's own (W, N) buffer
        return aggregate(self, mask)

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    steps, mem, ckpt_s = [], {}, {}
    try:
        n_params = sum(x.numel() for x in tree.leaves(params_f32))
        need = n_params * (2 + 4 + 4)       # bf16 p, f32 m and v
        free = shutil.disk_usage(ckpt_dir).free
        check(free >= CKPT_SLACK * need, f"{ckpt_dir}: {free} bytes free, "
              f"the checkpoint needs {need} (x {CKPT_SLACK})")
        tr = trainer(ctl, churn(), ckpt_dir=ckpt_dir,
                     ckpt_every=ELASTIC_CKPT)
        write, snapshot = store.save, store.AsyncCheckpointer.save

        def timed_write(*args, **kw):
            t0 = time.perf_counter()
            path = write(*args, **kw)
            ckpt_s["write"] = time.perf_counter() - t0
            return path

        def timed_snapshot(self, *args, **kw):
            t0 = time.perf_counter()
            snapshot(self, *args, **kw)
            ckpt_s["snapshot"] = time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        agg = None
        for i in range(n_steps):
            if i in (KILL_AT, restore_at):
                torch.cuda.reset_peak_memory_stats()
            if i + 1 == ELASTIC_CKPT:
                store.save = timed_write
                store.AsyncCheckpointer.save = timed_snapshot
            if i == restore_at - 1:
                # keep the buffer of the last width-6 step only: held
                # across a resize, it would sit beside the next width's
                ops.WorkerGrads.aggregate = kept_aggregate
            try:
                steps.append(one_step(tr, "train_elastic", ctl))
            finally:
                store.save, store.AsyncCheckpointer.save = write, snapshot
                ops.WorkerGrads.aggregate = aggregate
            if tr.step == ELASTIC_CKPT:
                tr.ckpt_dir = None          # one checkpoint, at width 6
            n = steps[-1]["n"]
            m = mem.setdefault(str(n) if i < restore_at else f"{n}_again",
                               {})
            m["max_memory_allocated"] = steps[-1]["max_memory_allocated"]
            m["memory_reserved"] = max(m.get("memory_reserved", 0),
                                       steps[-1]["memory_reserved"])
            if i == restore_at - 1:
                # the trainer's own (6, N) buffer, the DMM back (no fit
                # thread beside the timing's graph capture)
                check(ctl._refit_job is None and n == 6, "a refit is still "
                      "in flight at the end of width 6")
                g = bufs[0].buf
                mask = _agg_masks(torch, g.shape[0], torch.Generator(
                    device="cuda").manual_seed(SEED))["bits"]
                got = ops.masked_aggregate(g, mask)
                want = reference_masked_agg(g, mask.reshape(-1, 1))[0]
                err = (got - want).abs().max().item()
                ex = _allclose_excess(torch, got, want, AGG_TOL["float32"],
                                      AGG_TOL["float32"]).item()
                del got, want
                agg = {"W": g.shape[0], "N": g.shape[1], "max_abs_err": err,
                       **_agg_times(torch, torch.cuda.Stream(), g, mask, 5)}
                emit("train_elastic_masked_grad_agg", **agg)
                check(ex <= AGG_TOL["float32"], f"masked_grad_agg on the "
                      f"(6, N) buffer: off by {ex}")
                del g, mask, bufs[:]
        saved = store.restore_group(ckpt_dir, "ctl", step=ELASTIC_CKPT)
        step_dir = Path(ckpt_dir) / f"step_{ELASTIC_CKPT:010d}"
        ckpt_bytes = {p.name: p.stat().st_size for p in step_dir.iterdir()}
        out["checkpoint"] = dict(ckpt_s, bytes=ckpt_bytes,
                                 total_bytes=sum(ckpt_bytes.values()),
                                 free_bytes=free)
        del tr, ctl
        torch.cuda.empty_cache()

        # a fresh trainer at width 8 restores the mid-churn checkpoint
        ctl2 = elastic()
        modes.clear()
        predict2 = ctl2.predict_cutoff

        def traced_predict2():
            c = predict2()
            modes.append(ctl2.mode)
            return c

        ctl2.predict_cutoff = traced_predict2
        t0 = time.perf_counter()
        tr = trainer(ctl2, churn(ELASTIC_CKPT), ckpt_dir=ckpt_dir)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        warm = bool(np.allclose(ctl2.window_array(), saved["window"]))
        out["restart"] = {"restore_s": restore_s, "step": tr.step,
                          "n": tr.n_workers, "members": tr.members.tolist(),
                          "window_allclose": warm, "mode": ctl2.mode}
        check(tr.step == ELASTIC_CKPT and tr.n_workers == 6
              and tr.members.tolist() == list(range(6)) and warm,
              f"restart: {out['restart']}")
        tr.ckpt_dir = None
        resumed = [one_step(tr, "train_elastic_resumed", ctl2)
                   for _ in range(2)]
        out["restart"]["c"] = [r["c"] for r in resumed]
        out["restart"]["wall_ms"] = [r["wall_ms"] for r in resumed]
        del tr, ctl2
        torch.cuda.empty_cache()
    finally:
        ops.WorkerGrads.aggregate = aggregate
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # the summary, printed before it is checked
    widths = [s["n"] for s in steps]
    runs = [(s["n"], s["mode"]) for i, s in enumerate(steps)
            if i == 0 or (steps[i - 1]["n"], steps[i - 1]["mode"])
            != (s["n"], s["mode"])]
    first = {f"{steps[i]['n']}@{steps[i]['step']}": steps[i]["wall_ms"]
             for i in (KILL_AT, restore_at)}
    skip = {0, KILL_AT, restore_at, ELASTIC_CKPT - 1}
    skip |= {i for i in range(1, len(steps))
             if steps[i]["graphs"] != steps[i - 1]["graphs"]}
    medians = {}
    for n in (8, 6):
        kept = [s for i, s in enumerate(steps) if i not in skip
                and s["n"] == n]
        busy = [s["wall_ms"] for s in kept if all(s["refit_in_flight"])]
        idle = [s["wall_ms"] for s in kept if not any(s["refit_in_flight"])]
        medians[str(n)] = {
            "refit_in_flight": float(np.median(busy)) if busy else None,
            "no_refit": float(np.median(idle)) if idle else None,
            "steps": [len(busy), len(idle)]}
    for r in refits:
        r.pop("spawned")
    out.update(widths=widths, mode_runs=runs, refits=refits,
               first_step_after_resize_ms=first,
               median_wall_ms_by_width=medians,
               memory_by_width=mem, masked_grad_agg_w6=agg,
               launches=totals, seconds=time.perf_counter() - t_phase)
    emit("train_elastic_summary", **out)
    check([w for i, w in enumerate(widths) if i == 0 or widths[i - 1] != w]
          == [8, 6, 8], f"widths {widths}")
    check(runs == [(8, "dmm"), (6, "fallback"), (6, "dmm"), (8, "fallback"),
                   (8, "dmm")], f"mode runs {runs}: a refit did not land "
          f"in time (refits {refits}; steps of {capture['refit_alone_s']:.2f}"
          f" s alone)")
    check(len(refits) == 2 and all("spawn_to_install_s" in r
                                    for r in refits), f"refits {refits}")
    return totals, agg


# ---------------------------------------------------------------------------
# The multi-tenant parameter server: no kernel of its own (the decision is
# torch ops in one CUDA graph a bucket); its parity, its timing beside the
# looped controllers, and three full-width jobs through a worker churn.
# ---------------------------------------------------------------------------

PS_WIDTHS = (16, 10, 6)   # the ragged bucket (tests/test_torch_ps.py)
PS_TICKS = 100
PS_K = 16
PS_TIMING = (("j1_n8", (8,)), ("j3_n8", (8,) * 3), ("j8_n8", (8,) * 8),
             ("ragged_16_10_6", PS_WIDTHS))
MJ_JOBS, MJ_W = 3, 6       # three jobs of 6 workers: partitions of 18
MJ_VICTIMS = (6, 7)        # job1's first two workers
MJ_KILL = 8                # the kill takes effect at this tick
MJ_RESTORE_MIN = 18        # the restore no earlier than this tick ...
MJ_DMM_TICKS = 2           # ... and after this many DMM ticks at width 4
MJ_TICKS_MIN = 26
MJ_TICKS_MAX = 60


def _runs(seq):
    """Consecutive runs of equal items, each kept once."""
    return [x for i, x in enumerate(seq) if i == 0 or seq[i - 1] != x]


def _graph_device_us(torch, graph, reps=50):
    """Device µs of one replay of ``graph``: ``reps`` back-to-back replays
    between CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def _ps_parity(torch):
    """J = 3 ragged jobs (16/10/6) over PS_TICKS ticks: the card's server
    against three looped device controllers and against the server on the
    CPU; then J = 1 at n = 158 against the card's own controller."""
    from repro_torch.cluster.simulator import paper_cluster_158
    from repro_torch.core.controller import CutoffController
    from repro_torch.core.cutoff import order_stats
    from repro_torch.core.runtime_model.api import RuntimeModel
    from repro_torch.ps import PSServer

    t0 = time.perf_counter()
    card, cpu = PSServer(), PSServer()
    refs, hc, hp, sims = [], [], [], []
    for j, n in enumerate(PS_WIDTHS):
        trace = paper_cluster_158(seed=n, n_workers=n).run(40)
        rm = RuntimeModel(n, lag=10, device="cuda").init(0)
        rm.fit(trace, steps=50, batch=8, seed=0)
        ref = CutoffController(rm, k_samples=PS_K, seed=11 * j)
        ref.seed_window(trace)
        refs.append(ref)
        hc.append(card.admit(f"job{j}", rm, window=trace, k_samples=PS_K,
                             seed=11 * j))
        hp.append(cpu.admit(f"job{j}", rm.to("cpu"), window=trace,
                            k_samples=PS_K, seed=11 * j))
        sims.append(paper_cluster_158(seed=300 + j, n_workers=n))
    fit_s = time.perf_counter() - t0
    check(len(card._buckets) == 1, "mixed widths must share one bucket")
    b = next(iter(card._buckets.values()))
    censored, seqs = 0, [[] for _ in PS_WIDTHS]
    t0 = time.perf_counter()
    for tick in range(PS_TICKS):
        card.prefetch()
        cpu.prefetch()
        for j in range(len(PS_WIDTHS)):
            c = (refs[j].predict_cutoff(), hc[j].predict_cutoff(),
                 hp[j].predict_cutoff())
            check(c[0] == c[1] == c[2], f"ps_parity tick {tick} job{j}: "
                  f"cutoffs {c} (looped controller, card server, CPU server)")
            seqs[j].append(c[0])
            t = sims[j].step()
            mask = t <= order_stats.iter_time(t, c[0]) + 1e-12
            censored += int(not mask.all())
            for h in (refs[j], hc[j], hp[j]):
                h.observe(t, mask)
        fl = (card.flush(), cpu.flush())
        check(fl == (1, 1), f"ps_parity tick {tick}: flush {fl}, want 1 "
              f"launch a tick on each server")
    err_ref = err_cpu = 0.0
    for j in range(len(PS_WIDTHS)):
        a, r, p = (hc[j].window_array(), refs[j].window_array(),
                   hp[j].window_array())
        err_ref = max(err_ref, float(np.abs(a - r).max()))
        err_cpu = max(err_cpu, float(np.abs(a - p).max()))
        check(_rel_close(a, r, SERVER_WINDOW_TOL)
              and _rel_close(a, p, SERVER_WINDOW_TOL),
              f"ps_parity job{j}: windows differ by {err_ref} (controller) "
              f"and {err_cpu} (CPU server)")
    out = {"J": len(PS_WIDTHS), "widths": list(PS_WIDTHS), "n_pad": b.n_pad,
           "ticks": PS_TICKS, "k_samples": PS_K,
           "cutoffs": {f"job{j}": s for j, s in enumerate(seqs)},
           "distinct_cutoffs": [len(set(s)) for s in seqs],
           "censored_observations": censored,
           "window_max_abs_err_vs_controllers": err_ref,
           "window_max_abs_err_vs_cpu_server": err_cpu,
           "window_tol": SERVER_WINDOW_TOL, "graphs": sorted(b.graphs),
           "captures": b.captures, "replays": b.replays,
           "dispatches": card.dispatches, "fit_seconds": fit_s,
           "seconds": time.perf_counter() - t0}
    emit("ps_parity", **out)
    check(censored >= 50, f"only {censored} censored observations")
    check(any(len(set(s)) > 1 for s in seqs), "one cutoff for every step")
    check(b.captures == 2 and b.replays == PS_TICKS + 1,
          f"{b.captures} captures and {b.replays} replays for "
          f"{PS_TICKS} ticks: want 2 and {PS_TICKS + 1}")

    # J = 1 at n = 158 against the card's own controller
    t0 = time.perf_counter()
    trace = paper_cluster_158(seed=0).run(60)
    rm = RuntimeModel(158, lag=20, device="cuda").init(0)
    rm.fit(trace, steps=30, batch=8, seed=0)
    ref = CutoffController(rm, k_samples=32, seed=0)
    ref.seed_window(trace)
    srv = PSServer()
    h = srv.admit("job0", rm, window=trace, k_samples=32, seed=0)
    sim = paper_cluster_158(seed=7)
    cutoffs, censored = [], 0
    for step in range(100):
        c = (ref.predict_cutoff(), h.predict_cutoff())
        check(c[0] == c[1], f"ps_parity_158 step {step}: cutoffs {c} "
              f"(controller, server)")
        cutoffs.append(c[0])
        t = sim.step()
        mask = t <= order_stats.iter_time(t, c[0]) + 1e-12
        censored += int(not mask.all())
        ref.observe(t, mask)
        h.observe(t, mask)
        check(srv.flush() == 1, f"ps_parity_158 step {step}: flush")
    a, r = h.window_array(), ref.window_array()
    out158 = {"n": 158, "steps": 100, "k_samples": 32,
              "distinct_cutoffs": len(set(cutoffs)),
              "censored_steps": censored,
              "window_max_abs_err": float(np.abs(a - r).max()),
              "seconds": time.perf_counter() - t0}
    emit("ps_parity_158", **out158)
    check(censored >= 50 and len(set(cutoffs)) > 1, f"ps_parity_158: "
          f"{censored} censored steps, {len(set(cutoffs))} cutoffs")
    check(_rel_close(a, r, SERVER_WINDOW_TOL), f"ps_parity_158: windows "
          f"differ by {out158['window_max_abs_err']}")
    return out


def _ps_timing(torch):
    """For each PS_TIMING case (K 64, lag 20, as dmm_timing): the bucket's
    observe+decide graph (device µs a replay, CUDA kernels a replay) and
    the host µs of a tick's flush and predict_cutoff fetches, beside the
    same jobs decided by J looped device controllers."""
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import CutoffController
    from repro_torch.core.cutoff import order_stats
    from repro_torch.core.runtime_model.api import RuntimeModel
    from repro_torch.ps import PSServer

    K, lag, ticks, warm = 64, 20, 30, 5
    out = {}
    for case, widths in PS_TIMING:
        J = len(widths)
        models, traces = [], []
        for j, n in enumerate(widths):
            tr = ClusterSim(n_workers=n, n_nodes=2, seed=3 + j).run(40)
            rm = RuntimeModel(n, lag=lag, device="cuda").init(1 + j)
            rm.norm_scale = float(2.0 * tr[:lag + 1].mean())
            models.append(rm)
            traces.append(tr)
        srv = PSServer()
        hs = [srv.admit(f"job{j}", rm, window=tr, k_samples=K, seed=j)
              for j, (rm, tr) in enumerate(zip(models, traces))]
        ctls = []
        for j, (rm, tr) in enumerate(zip(models, traces)):
            ctl = CutoffController(rm, k_samples=K, seed=j)
            ctl.seed_window(tr)
            ctls.append(ctl)
        sims = [ClusterSim(n_workers=n, n_nodes=2, seed=40 + j)
                for j, n in enumerate(widths)]
        flush_us, pred_us, loop_us = [], [], []
        for tick in range(ticks):
            srv.prefetch()
            t_pred = 0.0
            for j, h in enumerate(hs):
                t0 = time.perf_counter()
                c = h.predict_cutoff()
                t_pred += time.perf_counter() - t0
                t = sims[j].step()
                h.observe(t, t <= order_stats.iter_time(t, c) + 1e-12)
            t0 = time.perf_counter()
            srv.flush()
            t_flush = time.perf_counter() - t0
            t_loop = 0.0
            for j, ctl in enumerate(ctls):
                t = sims[j].step()
                t0 = time.perf_counter()
                c = ctl.predict_cutoff()
                ctl.observe(t, t <= order_stats.iter_time(t, c) + 1e-12)
                t_loop += time.perf_counter() - t0
            if tick >= warm:      # the first ticks capture the graphs
                flush_us.append(t_flush * 1e6)
                pred_us.append(t_pred * 1e6)
                loop_us.append(t_loop * 1e6)
        srv.flush()
        b = next(iter(srv._buckets.values()))
        b.wait()
        graph = b.graphs["observe"]
        per = kernels_per_call(torch, graph.replay)
        loop_graphs = [c.graphs[max(c.graphs, key=lambda k: k[0]
                                    == "censored")] for c in ctls]
        loop_dev = [_graph_device_us(torch, g) for g in loop_graphs]
        loop_per = kernels_per_call(torch, loop_graphs[0].replay)
        rec = {"J": J, "widths": list(widths), "n_pad": b.n_pad,
               "k_samples": K, "lag": lag,
               "device_us_per_replay": _graph_device_us(torch, graph),
               "cuda_kernels_per_replay": sum(v["per_call"]
                                              for v in per.values()),
               "looped_device_us": sum(loop_dev),
               "looped_cuda_kernels": J * sum(v["per_call"]
                                              for v in loop_per.values()),
               "flush_wall_us": float(np.median(flush_us)),
               "predict_fetch_wall_us": float(np.median(pred_us)),
               "flush_plus_predict_wall_us": float(np.median(
                   np.add(flush_us, pred_us))),
               "looped_observe_plus_predict_wall_us": float(np.median(
                   loop_us)),
               "captures": b.captures, "replays": b.replays,
               "dispatches": srv.dispatches}
        emit("ps_timing", case=case, **rec)
        check(b.captures == 2, f"ps_timing {case}: {b.captures} captures")
        out[case] = rec
        del srv, hs, ctls, graph, loop_graphs, b
    torch.cuda.empty_cache()
    return out


def phase_ps(torch):
    """ps_parity and ps_timing, then the memory they leave behind.  Each
    controller and bucket runs on a stream of its own, and cuBLAS keeps
    a workspace for every stream that ran a matmul (~0.8 GB for this
    phase's ~25 streams in a run on the H100), which later phases' peaks
    would otherwise carry: the workspaces are released here."""
    before = torch.cuda.memory_allocated()
    out = {"parity": _ps_parity(torch), "timing": _ps_timing(torch)}
    gc.collect()
    left = torch.cuda.memory_allocated()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    emit("ps_memory", allocated_before=before, allocated_after=left,
         cublas_workspaces_cleared=clear is not None,
         allocated_after_clearing=torch.cuda.memory_allocated())
    return out


# ---------------------------------------------------------------------------
# The paper's CNN workload (Fig. 4's setting) and the supervised trainer.
# ---------------------------------------------------------------------------

# The card's CNN against the CPU's, of each value's own scale, f32 (TF32
# off).  The two convolve in another summation order, a few ulps apart
# (~1e-6 of a leaf; the same with cuDNN deterministic, benchmarked or
# off: scripts/torch_cnn_grad_leaves.py), and a 2x2 max-pool window
# whose two largest entries lie that close may pick the other entry on
# the card and send its gradient there (one of pool 2's 802,816 windows
# at batch 512, its entries 7.3e-7 apart: 9.1e-5 of c2.w's scale on the
# H100).  So the CPU reference takes the card's pooling choices, each
# flipped window must be such a near-tie (its entries within
# CNN_NEAR_TIE of each other), and the gradient is held to 1e-5, ten
# times the routed readings (1.0-1.2e-6); TF32 convolutions read 6e-3
# to 1e-2 and bf16 autocast 3.4e-2 to 3.8e-2.
CNN_TOL = {"loss": 1e-5, "grad": 1e-5}
CNN_NEAR_TIE = 1e-5   # relative gap of a flipped window's two entries
CNN_WORKERS, CNN_BATCH, CNN_STEPS = 32, 512, 150   # paper_figures.py:126
CNN_FIT_ROWS = CNN_FIT_STEPS = 300
CNN_EVAL_EVERY, CNN_VALID = 10, 2000


def _cnn_pools(torch, C, params, x):
    """The pre-pool activations and argmax indices of the CNN's two
    max-pools, as ``cnn_apply`` computes them."""
    import torch.nn.functional as F

    acts, idx = [], []
    with torch.no_grad():
        h = C._conv(x[:, None], params["c1"])
        for name in ("c2", "c3"):
            acts.append(h)
            h, i = F.max_pool2d(h, 2, return_indices=True)
            idx.append(i)
            h = C._conv(h, params[name])
    return acts, idx


def _cnn_routed_loss(C, params, x, y, weights, idx):
    """``cnn_loss`` with each max-pool taking the argmax ``idx`` given."""
    h = C._conv(x[:, None], params["c1"])
    for i, name in zip(idx, ("c2", "c3")):
        h = h.flatten(2).gather(2, i.flatten(2)).view(i.shape)
        h = C._conv(h, params[name])
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return C.cross_entropy(h @ params["fc"]["w"] + params["fc"]["b"], y,
                           weights)


def _cnn_parity(torch):
    """Loss and gradient of the CNN on the card against the CPU: batch
    512, f32, the mean and the cutoff weights of 32 workers (every third
    cut).  The CPU reference routes each max-pool's gradient as the card
    did (CNN_TOL's comment); the windows that flipped are counted."""
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.models import cnn as C

    x, y = SyntheticImages(seed=0, noise=0.9).batch(0, CNN_BATCH)
    bits = (np.arange(CNN_WORKERS) % 3 != 2).astype(np.float32)
    w = np.repeat(bits, CNN_BATCH // CNN_WORKERS)
    p_cpu = C.cnn_init(SEED, device="cpu")
    leaves = {}
    args = {}
    for dev in ("cpu", "cuda"):
        leaves[dev] = {k: {n: t.detach().to(dev).requires_grad_(True)
                           for n, t in p.items()} for k, p in p_cpu.items()}
        args[dev] = [torch.from_numpy(a).to(dev) for a in (x, y, w)]
    acts, idx_cpu = _cnn_pools(torch, C, leaves["cpu"], args["cpu"][0])
    _, idx_card = _cnn_pools(torch, C, leaves["cuda"], args["cuda"][0])
    idx_card = [i.cpu() for i in idx_card]
    flips = []
    for lvl, (h, ic, ig) in enumerate(zip(acts, idx_cpu, idx_card), 1):
        a = h.flatten(2).gather(2, ic.flatten(2))
        b = h.flatten(2).gather(2, ig.flatten(2))
        gap = ((a - b).abs() / a.abs().clamp(min=1e-30))[ic.flatten(2)
                                                          != ig.flatten(2)]
        flips.append({"pool": lvl, "windows": ic.numel(),
                      "flipped": int(gap.numel()),
                      "max_rel_gap": float(gap.max()) if gap.numel() else 0.0})
    check(all(f["max_rel_gap"] <= CNN_NEAR_TIE for f in flips),
          f"cnn: a max-pool window the card decided otherwise is not a "
          f"near-tie: {flips}")

    def loss_grad(dev, kind, idx=None):
        p, (xx, yy, ww) = leaves[dev], args[dev]
        ww = None if kind == "mean" else ww
        loss = (C.cnn_loss(p, xx, yy, ww) if idx is None
                else _cnn_routed_loss(C, p, xx, yy, ww, idx))
        grads = torch.autograd.grad(
            loss, [t for q in p.values() for t in q.values()])
        return loss.detach().cpu(), [g.cpu() for g in grads]

    errs = {}
    for kind in ("mean", "weighted"):
        lg, gg = loss_grad("cuda", kind)
        lc, gc = loss_grad("cpu", kind)
        lr, gr = loss_grad("cpu", kind, idx_card)
        _, gs = loss_grad("cpu", kind, idx_cpu)
        errs[kind] = {"loss_scaled_err": _scaled_err(torch, [lg], [lr]),
                      "grad_scaled_err": _scaled_err(torch, gg, gr),
                      "grad_scaled_err_unrouted": _scaled_err(torch, gg, gc),
                      "routed_equals_port_on_cpu": all(
                          torch.equal(a, b) for a, b in zip(gs, gc)),
                      "loss_cpu": float(lc), "loss_cuda": float(lg)}
        check(errs[kind]["routed_equals_port_on_cpu"],
              f"cnn {kind}: the routed CPU loss is not cnn_loss's")
        check(errs[kind]["loss_scaled_err"] <= CNN_TOL["loss"]
              and errs[kind]["grad_scaled_err"] <= CNN_TOL["grad"],
              f"cnn {kind}: card vs CPU {errs[kind]}")
    emit("cnn_parity", batch=CNN_BATCH, dtype="float32", tol=CNN_TOL,
         near_tie=CNN_NEAR_TIE, pool_flips=flips, **errs)


def _cnn_fig4(torch):
    """The paper's workload at the reference's Fig. 4 setting: full sync,
    the DMM cutoff (k_samples 48, its graph on the card) and the Elfving
    cutoff over ClusterSim(32, 4 nodes, seed 21), batch 512, momentum
    (0.05, 0.9), 150 steps, the validation loss every 10 steps on 2,000
    images.  Reports each controller's curve; who wins is not checked."""
    from repro_torch import optim
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import (CutoffController,
                                             ElfvingController,
                                             FullSyncController)
    from repro_torch.core.runtime_model.api import RuntimeModel
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.launch.cnn import run_cnn_cutoff
    from repro_torch.models.cnn import cnn_init

    n = CNN_WORKERS
    t0 = time.perf_counter()
    trace = ClusterSim(n_workers=n, n_nodes=4, seed=0).run(CNN_FIT_ROWS)
    rm = RuntimeModel(n, lag=20, device="cuda").init(0)
    rm.fit(trace, steps=CNN_FIT_STEPS, batch=8, seed=0)
    fit_s = time.perf_counter() - t0
    data = SyntheticImages(seed=0, noise=0.9)
    out = {}
    for name in ("sync", "cutoff", "order"):
        if name == "sync":
            ctl = FullSyncController(n)
        elif name == "order":
            ctl = ElfvingController(n)
        else:
            ctl = CutoffController(rm, k_samples=48)
            ctl.seed_window(trace[-21:])
        t0 = time.perf_counter()
        run = run_cnn_cutoff(ctl, ClusterSim(n_workers=n, n_nodes=4,
                                             seed=21),
                             data, cnn_init(SEED, device="cuda"),
                             optim.momentum(0.05, 0.9), n_workers=n,
                             steps=CNN_STEPS, batch=CNN_BATCH,
                             eval_every=CNN_EVAL_EVERY, n_valid=CNN_VALID)
        rec = {"controller": name, "curve": run["curve"],
               "final_valid_loss": run["curve"][-1][1],
               "sim_clock_s": run["clock"],
               "step_wall_ms_median": float(np.median(run["step_wall_ms"])),
               "cutoffs_distinct": sorted(set(run["cutoffs"])),
               "mean_cutoff": float(np.mean(run["cutoffs"])),
               "seconds": time.perf_counter() - t0,
               "decision_device_us": None}
        if name == "cutoff":
            check(ctl.replays == CNN_STEPS + 1, f"cnn cutoff: "
                  f"{ctl.replays} graph replays for {CNN_STEPS} steps")
            graph = ctl.graphs[max(ctl.graphs,
                                   key=lambda k: k[0] == "censored")]
            rec["decision_device_us"] = _graph_device_us(torch, graph)
            rec["graph_replays"] = ctl.replays
        check(len(run["curve"]) == CNN_STEPS // CNN_EVAL_EVERY
              and all(np.isfinite(v) for _, v in run["curve"])
              and np.all(np.isfinite(run["losses"])),
              f"cnn {name}: curve {run['curve']}")
        check(all(1 <= c <= n for c in run["cutoffs"]),
              f"cnn {name}: cutoffs out of range")
        emit("cnn_fig4", **rec)
        out[name] = rec
    emit("cnn_fig4_summary", workers=n, batch=CNN_BATCH, steps=CNN_STEPS,
         fit_rows=CNN_FIT_ROWS, fit_steps=CNN_FIT_STEPS, fit_seconds=fit_s,
         final_valid_loss={k: v["final_valid_loss"] for k, v in out.items()},
         sim_clock_s={k: v["sim_clock_s"] for k, v in out.items()})
    return out


def phase_cnn(torch):
    """(a) the CNN's loss and gradient, card against CPU; (b) the Fig. 4
    workload under three controllers on the card."""
    _cnn_parity(torch)
    return _cnn_fig4(torch)


SUP_STEPS, SUP_WORKERS = 36, 6      # tests/test_controlplane.py:366


def phase_supervised(torch):
    """launch.supervised on the card: the seeded storm of default_plan(6)
    over 36 steps (bench_tiny_config at head_dim 64, f32), the report as
    the reference's test asserts it, every launch a flash_attention one
    (2 layers x 36 steps x 2 trainers), the losses against the same run
    on the CPU (PARITY_TOL's loss bar); the host µs of Supervisor.tick;
    then one SIGKILL against ProcWorkerPool subprocess workers."""
    import tempfile

    from repro_torch.kernels import build
    from repro_torch.launch import supervised as S

    n_layers = S.supervised_config().n_layers
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    card = S.run_supervised(steps=SUP_STEPS, n_workers=SUP_WORKERS,
                            verbose=False)
    card_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    t0 = time.perf_counter()
    cpu = S.run_supervised(steps=SUP_STEPS, n_workers=SUP_WORKERS,
                           device="cpu", verbose=False)
    cpu_s = time.perf_counter() - t0
    rep = card["report"]
    want = {"flash_attention": 2 * n_layers * SUP_STEPS}
    check(launches == want, f"supervised launched {launches}, want {want}")
    check(card["match"] and rep["n_detected"] == 2
          and rep["max_detection_ticks"] <= 5
          and rep["failed_restarts"] == 1 and rep["evicted"] == []
          and sorted(set(card["widths"])) == [5, 6],
          f"supervised report {rep}, match {card['match']}, widths "
          f"{sorted(set(card['widths']))}")
    check([(h["n"], h["c"], h["clock"]) for h in card["history"]]
          == [(h["n"], h["c"], h["clock"]) for h in cpu["history"]],
          "supervised: widths, cutoffs or clock differ card vs CPU")
    loss_err = max(abs(a["loss"] - b["loss"])
                   for a, b in zip(card["history"], cpu["history"]))
    check(loss_err <= PARITY_TOL["loss"],
          f"supervised: losses differ by {loss_err} card vs CPU")

    _, sup, _ = S.build_supervised(SUP_WORKERS, S.default_plan(SUP_WORKERS))
    tick_us = []
    for t in range(60):
        t1 = time.perf_counter()
        sup.tick(t)
        tick_us.append((time.perf_counter() - t1) * 1e6)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_drill_") as d:
        t0 = time.perf_counter()
        drill = S.proc_crash_drill(d)
        drill_s = time.perf_counter() - t0
    check(drill["dead_tick"] == drill["crash_tick"] + 5
          and drill["restart_tick"] == drill["dead_tick"] + 2
          and drill["members"] == [0, 1, 2]
          and all(drill["running_at_end"]),
          f"ProcWorkerPool crash drill: {drill['report']}")
    emit("supervised", steps=SUP_STEPS, workers=SUP_WORKERS,
         layers=n_layers, head_dim=S.supervised_config().head_dim,
         match=card["match"], widths=sorted(set(card["widths"])),
         report={k: v for k, v in rep.items() if k != "incidents"},
         incidents=rep["incidents"], launches=launches,
         loss_max_abs_err_vs_cpu=loss_err, loss_tol=PARITY_TOL["loss"],
         final_loss=card["history"][-1]["loss"], seconds_card=card_s,
         seconds_cpu=cpu_s, supervisor_tick_host_us_median=float(
             np.median(tick_us)),
         supervisor_tick_host_us_max=float(np.max(tick_us)))
    emit("supervised_proc_drill", crash_tick=drill["crash_tick"],
         dead_tick=drill["dead_tick"], restart_tick=drill["restart_tick"],
         rejoin_tick=drill["rejoin_tick"],
         detection_ticks=drill["report"]["max_detection_ticks"],
         members=drill["members"], seconds=drill_s)
    return launches


def phase_train_multi_job(torch, cfg):
    """Three full-width qwen2-0.5b jobs (bf16, seq 128, global batch 24,
    psum, fused AdamW) of 6 workers each through launch.multi_job:
    build_multi_job over PartitionedSim(paper_cluster_158(1, 18),
    partition_ids(18, 3)), each job's RuntimeModel(6, lag 10) fitted on the
    card, one PSServer (k_samples 32, refit_async, refit_steps 60,
    refit_fresh 3), round-robin, run_ticks one tick at a time.  A
    ChurnEvent kills job1's workers 6 and 7 at tick 8; the restore is
    appended to the schedule once job1 has decided through its refitted
    width-4 DMM for 2 ticks (and no earlier than tick 18), so a slow refit
    stretches the run instead of failing it; the run ends once job1 has
    decided through its width-6 DMM for 2 ticks (at least 26 ticks).

    Every step asserts the launches at its width (flash 24 x W,
    masked_grad_agg 1, fused_adam 1), a finite loss and 1 <= c <= n;
    every tick at most 2 launches of the decision, captures only where the
    stack changed.  job1's modes run dmm, fallback, dmm at width 4,
    fallback, dmm at width 6; jobs 0 and 2 stay on the DMM.  At width 4
    the shared step keeps a (4, N) and a (6, N) buffer, and
    masked_grad_agg is timed on job1's own (4, N) one."""
    from repro_torch.cluster.simulator import ChurnEvent
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import reference_masked_agg
    from repro_torch.launch.multi_job import build_multi_job, run_ticks
    from repro_torch.ps import make_scheduler

    L = cfg.n_layers
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    server, jobs, sim = build_multi_job(
        MJ_JOBS, MJ_W, seed=SEED, churn_events=[
            ChurnEvent(step=MJ_KILL, kill=MJ_VICTIMS)],
        global_batch=ELASTIC_BATCH, refit_steps=REFIT_STEPS,
        refit_fresh=REFIT_FRESH, refit_async=True, metrics_every=1,
        device="cuda", cfg=cfg, seq_len=128, mask_agg="psum")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    step_fn = jobs["job0"].trainer.step_fn
    check(all(r.trainer.step_fn is step_fn for r in jobs.values()),
          "the jobs must share one train step")
    emit("train_multi_job_setup", jobs=MJ_JOBS, workers=MJ_W,
         batch=ELASTIC_BATCH, seq=128, seconds=setup_s,
         memory_allocated=torch.cuda.memory_allocated(),
         windows=[int(server.registry[j].count) for j in jobs])

    steps, modes, refits, tick_of = [], {j: [] for j in jobs}, [], [0]
    totals = {}

    def in_flight():
        return any(j.refit_task is not None and j.refit_task[0].is_alive()
                   for j in server.registry.jobs())

    def instrument(job_id, tr):
        run, predict = tr.run, tr.controller.predict_cutoff

        def traced_predict():
            c = predict()
            modes[job_id].append(server.registry[job_id].mode)
            return c

        def timed_run(n_steps, **kw):
            alive0 = in_flight()
            build.LAUNCHES.clear()
            t0 = time.perf_counter()
            hist = run(n_steps, **kw)     # drains the loss: a device sync
            wall = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            rec = hist[-1]
            n, c = rec["n"], rec["c"]
            want = {"flash_attention": L * n, "masked_grad_agg": 1,
                    "fused_adam": 1}
            check(launches == want, f"train_multi_job {job_id} step "
                  f"{rec['step']} (n {n}): launches {launches}, want {want}")
            check(bool(np.isfinite(rec["loss"])), f"train_multi_job "
                  f"{job_id} step {rec['step']}: loss {rec['loss']}")
            check(1 <= c <= n, f"train_multi_job {job_id}: c {c} of {n}")
            steps.append({"job": job_id, "tick": tick_of[0], "n": n, "c": c,
                          "mode": modes[job_id][-1], "wall_ms": wall * 1e3,
                          "refit_in_flight": [alive0, in_flight()],
                          "loss": rec["loss"]})
            return hist

        tr.controller.predict_cutoff = traced_predict
        tr.run = timed_run

    for job_id, r in jobs.items():
        instrument(job_id, r.trainer)
    fit_model, install = server._fit_model, server._install_refit

    def timed_fit(job, rows, n, seed):
        r = {"job": job.job_id, "n": n, "seed": seed, "rows": len(rows),
             "spawned": time.perf_counter(), "spawn_tick": tick_of[0]}
        refits.append(r)
        model = fit_model(job, rows, n, seed)
        r["fit_s"] = time.perf_counter() - r["spawned"]
        return model

    def timed_install(job, model):
        install(job, model)
        r = [x for x in refits if x["job"] == job.job_id][-1]
        r["spawn_to_install_s"] = time.perf_counter() - r["spawned"]
        r["install_tick"] = tick_of[0]

    server._fit_model, server._install_refit = timed_fit, timed_install
    bucket = next(iter(server._buckets.values()))
    sched = make_scheduler("rr")
    ticks, restore_at, agg, mem = [], None, None, {}
    tick = 0
    while True:
        check(tick < MJ_TICKS_MAX, f"train_multi_job: job1 not back on its "
              f"width-6 DMM after {MJ_TICKS_MAX} ticks (refits {refits})")
        tick_of[0] = tick
        caps, st = bucket.captures, bucket.st
        t0 = time.perf_counter()
        out = run_ticks(server, jobs, sched, 1)
        wall = time.perf_counter() - t0
        j1 = [s for s in steps if s["job"] == "job1"][-1]
        period = ("w6" if tick < MJ_KILL else "w4"
                  if restore_at is None or tick < restore_at else "w6_again")
        m = mem.setdefault(period, {"max_memory_allocated": 0,
                                    "memory_reserved": 0})
        m["max_memory_allocated"] = max(m["max_memory_allocated"],
                                        torch.cuda.max_memory_allocated())
        m["memory_reserved"] = max(m["memory_reserved"],
                                   torch.cuda.memory_reserved())
        ticks.append({"tick": tick, "wall_ms": wall * 1e3,
                      "dispatches": out["dispatches"],
                      "captures": bucket.captures - caps,
                      "restacked": bucket.st is not st,
                      "job1": [j1["n"], j1["mode"]],
                      "c": [s["c"] for s in steps[-MJ_JOBS:]]})
        emit("train_multi_job", **ticks[-1])
        j1_steps = [s for s in steps if s["job"] == "job1"]
        dmm4 = sum(1 for s in j1_steps if (s["n"], s["mode"]) == (4, "dmm"))
        if (restore_at is None and dmm4 >= MJ_DMM_TICKS
                and tick + 1 >= MJ_RESTORE_MIN):
            # width 4, on its DMM, no fit thread: job1's own (4, N) buffer
            check(not in_flight(), "a refit in flight at the end of width 4")
            widths = sorted(k[0] for k in step_fn.buffers)
            check(widths == [4, MJ_W], f"buffers of widths {widths} at "
                  f"width 4: want one per width in use")
            g = next(v for k, v in step_fn.buffers.items()
                     if k[0] == 4).buf
            mask = _agg_masks(torch, g.shape[0], torch.Generator(
                device="cuda").manual_seed(SEED))["bits"]
            got = ops.masked_aggregate(g, mask)
            want = reference_masked_agg(g, mask.reshape(-1, 1))[0]
            err = (got - want).abs().max().item()
            ex = _allclose_excess(torch, got, want, AGG_TOL["float32"],
                                  AGG_TOL["float32"]).item()
            del got, want
            agg = {"W": g.shape[0], "N": g.shape[1], "max_abs_err": err,
                   "buffers_widths": widths,
                   **_agg_times(torch, torch.cuda.Stream(), g, mask, 5)}
            emit("train_multi_job_masked_grad_agg", **agg)
            check(ex <= AGG_TOL["float32"], f"masked_grad_agg on the "
                  f"(4, N) buffer: off by {ex}")
            del g, mask
            # the timing's own peak (the plain version's temporaries) is
            # not the training's
            torch.cuda.reset_peak_memory_stats()
            restore_at = tick + 1
            sim.events.append(ChurnEvent(step=restore_at,
                                         restore=MJ_VICTIMS))
            check(bool(sim.membership_at(restore_at)[list(MJ_VICTIMS)]
                       .all()), "the restore did not reach the schedule")
        tick += 1
        dmm6 = sum(1 for s in j1_steps if restore_at is not None
                   and s["tick"] >= restore_at
                   and (s["n"], s["mode"]) == (MJ_W, "dmm"))
        if dmm6 >= MJ_DMM_TICKS and tick >= MJ_TICKS_MIN:
            break
    buffers_after = sorted(k[0] for k in step_fn.buffers)

    # the summary, printed before it is checked
    runs = {j: _runs([(s["n"], s["mode"]) for s in steps if s["job"] == j])
            for j in jobs}
    walls = {}
    for n in (MJ_W, 4):
        kept = [s for s in steps if s["n"] == n and s["tick"] > 0]
        busy = [s["wall_ms"] for s in kept if all(s["refit_in_flight"])]
        idle = [s["wall_ms"] for s in kept
                if not any(s["refit_in_flight"])]
        walls[str(n)] = {
            "refit_in_flight": float(np.median(busy)) if busy else None,
            "no_refit": float(np.median(idle)) if idle else None,
            "steps": [len(busy), len(idle)]}
    for r in refits:
        r.pop("spawned")
    tick_walls = [t["wall_ms"] for t in ticks[1:]]
    out = {"ticks": len(ticks), "kill_tick": MJ_KILL,
           "restore_tick": restore_at, "mode_runs": runs,
           "dispatches": sum(t["dispatches"] for t in ticks),
           "dispatches_by_tick": [t["dispatches"] for t in ticks],
           "captures_by_tick": [t["captures"] for t in ticks],
           "captures": bucket.captures, "replays": bucket.replays,
           "tick_wall_ms_median": float(np.median(tick_walls)),
           "step_wall_ms_median_by_width": walls, "refits": refits,
           "memory_by_period": mem,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "buffers_widths_at_end": buffers_after,
           "masked_grad_agg_w4": agg, "launches": totals,
           "setup_seconds": setup_s,
           "seconds": time.perf_counter() - t_phase}
    emit("train_multi_job_summary", **out)
    check(runs["job1"] == [(MJ_W, "dmm"), (4, "fallback"), (4, "dmm"),
                           (MJ_W, "fallback"), (MJ_W, "dmm")],
          f"job1 mode runs {runs['job1']} (refits {refits})")
    for j in ("job0", "job2"):
        check(runs[j] == [(MJ_W, "dmm")], f"{j} mode runs {runs[j]}")
    # one launch a tick; a second in the first tick (its decide-only
    # prefetch), in each resize's tick (resize flushes what is queued) and
    # in each rejoin's tick (the rejoined job's first decision)
    check(all(d <= 2 for d in out["dispatches_by_tick"])
          and out["dispatches"] <= len(ticks) + 5,
          f"decision launches by tick {out['dispatches_by_tick']}")
    # a capture only in the tick the stack changed, or the next one (its
    # first decide-only launch): never in a steady tick
    changed = {0} | {i + d for i, t in enumerate(ticks) if t["restacked"]
                     for d in (0, 1)}
    check(all(t["captures"] == 0 for t in ticks if t["tick"] not in changed),
          f"a steady tick captured: {out['captures_by_tick']}")
    check(len(refits) == 2 and all("spawn_to_install_s" in r
                                    for r in refits), f"refits {refits}")
    check(buffers_after == [MJ_W], f"buffers of widths {buffers_after} "
          f"after the restore: want the width-4 one freed")
    # the instrumented methods close over their trainers: collect the
    # cycles before the next phase
    del server, jobs, sim, step_fn, bucket
    gc.collect()
    torch.cuda.empty_cache()
    return totals, agg


def _mlstm_inputs(torch, B, S, H, hd, dtname, gates, gen):
    """q/k/v in ``dtname`` and f32 log gates, as the mLSTM block makes
    them: g = log_sigmoid(forget logits), i = the input logits."""
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    dt = getattr(torch, dtname)
    q, k = (0.5 * randn(B, S, H, hd)).to(dt), (0.5 * randn(B, S, H, hd)).to(dt)
    v = randn(B, S, H, hd).to(dt)
    if gates == "extreme":   # forget logits -10 or +10, input up to 10
        f = torch.where(randn(B, S, H) > 0, 10.0, -10.0)
        i = 20.0 * torch.rand((B, S, H), generator=gen, device="cuda") - 10.0
    else:
        f, i = randn(B, S, H) + 3.0, 0.5 * randn(B, S, H)
    return q, k, v, F.logsigmoid(f), i


def mlstm_ops(B, S, H, hd, chunk):
    """Operations of the chunkwise algorithm at ``chunk``, as (q k^T, the
    rest): per (b, h) and chunk of L positions, q k^T and (W q k^T) v over
    the L(L+1)/2 causal pairs, and the two (L, hd) x (hd, hd) products (q C
    with the entering state, which is zero for the first chunk, and the
    state update)."""
    qk = rest = 0
    for c0 in range(0, S, chunk):
        L = min(chunk, S - c0)
        qk += L * (L + 1) * hd
        rest += L * (L + 1) * hd + 2 * L * hd * hd * (2 if c0 else 1)
    return B * H * qk, B * H * rest


def mlstm_bound(B, S, H, hd, dtname):
    """The least time the card could take for one call, in ms, with its
    basis: the bytes (q/k/v and the gates read once, y and the final state
    written once) over 3.35 TB/s, against the operations (counted in the
    Pallas kernel's chunks) over the tensor cores' rates, 989 TFLOP/s for
    q k^T with bf16 operands and 495 (TF32) for the products with an f32
    operand; the same count over 67 TFLOP/s of f32 FMAs beside it."""
    elt = 2 if dtname == "bfloat16" else 4
    nbytes = (3 * B * S * H * hd * elt + 2 * B * S * H * 4   # in
              + B * S * H * hd * 4                           # y
              + 4 * B * H * (hd * hd + hd + 2))              # state
    qk, rest = mlstm_ops(B, S, H, hd, PALLAS_MLSTM_CHUNK)
    qk_rate = PEAK_OPS["bfloat16"] if dtname == "bfloat16" else TF32_OPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (qk / qk_rate + rest / TF32_OPS) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "fma_floor_ms": (qk + rest) / PEAK_OPS["float32"] * 1e3,
            "bytes": nbytes, "ops": qk + rest, "ops_qk": qk,
            "chunk": PALLAS_MLSTM_CHUNK}


def phase_mlstm(torch):
    from repro_torch.kernels.flash_attention import aligned16
    from repro_torch.kernels.mlstm_chunk import (PATH_KERNELS, choose_path,
                                                 mlstm_chunk)
    from repro_torch.kernels.mlstm_plain import linear_recurrence
    from repro_torch.kernels.ref import reference_mlstm
    from repro_torch.models.ssm import recurrence_step

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    side = torch.cuda.Stream()
    results = {}
    for name, B, S, H, hd, dtname, gates, want_path in MLSTM_CASES:
        q, k, v, g, i = _mlstm_inputs(torch, B, S + 1, H, hd, dtname, gates,
                                      gen)
        head = [t[:, :S] for t in (q, k, v, g, i)]
        step = [t[:, S] for t in (q, k, v, g, i)]
        path = choose_path(q.dtype, hd, aligned16(*head[:3]))
        check(path == want_path, f"mlstm {name}: takes {path}, not "
              f"{want_path}")
        y, st = mlstm_chunk(*head)
        want, pst = linear_recurrence(*head)
        oracle = reference_mlstm(q, k, v, g, i)
        ys, _ = recurrence_step(st, *step)
        ws, _ = recurrence_step(pst, *step)
        torch.cuda.synchronize()
        check(y.shape == (B, S, H, hd) and y.dtype == torch.float32
              and st.C.shape == (B, H, hd, hd) and st.n.shape == (B, H, hd)
              and st.m.shape == (B, H) and st.loga.shape == (B, H),
              f"mlstm {name}: output {tuple(y.shape)} {y.dtype}, state "
              f"{[tuple(t.shape) for t in st]}")
        check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(ys).all()),
              f"mlstm {name}: non-finite output")
        errs = {}
        for key, got, exp in (("y", y, want), ("step", ys, ws),
                              ("y_oracle", y, oracle[:, :S]),
                              ("step_oracle", ys, oracle[:, S])):
            ex = _allclose_excess(torch, got, exp, MLSTM_TOL, MLSTM_TOL).item()
            check(ex <= MLSTM_TOL, f"mlstm {name}: {key} off by {ex} beyond "
                  f"rtol > {MLSTM_TOL}")
            errs[key] = (got - exp).abs().max().item()
        loga_err = (st.loga - pst.loga).abs().max().item()
        check(loga_err <= MLSTM_TOL * (1 + pst.loga.abs().max().item()),
              f"mlstm {name}: loga off by {loga_err}")

        def kern():
            return mlstm_chunk(*head)

        # the CUDA kernels a call makes, against what its path launches
        per_call = kernels_per_call(torch, kern)
        expect = set(PATH_KERNELS[path])
        check(set(per_call) == expect
              and all(r["per_call"] == 1 for r in per_call.values()),
              f"mlstm {name}: a call launched {per_call}, not one each of "
              f"{sorted(expect)}")
        times = {}
        for label, fn in (("ms", kern),
                          ("plain_ms", lambda: linear_recurrence(*head))):
            times[label] = device_ms(torch, fn, side)
            times["eager_" + label] = eager_ms(torch, fn)
        rec = {"case": name, "shape": [B, S, H, hd], "dtype": dtname,
               "gates": gates, "path": path, "max_abs_err": errs["y"],
               "step_max_abs_err": errs["step"],
               "oracle_max_abs_err": errs["y_oracle"],
               "step_oracle_max_abs_err": errs["step_oracle"],
               "y_max_abs": oracle[:, :S].abs().max().item(),
               "tol": MLSTM_TOL, **times, "library_ms": None,
               "library": "none: no single PyTorch call computes it",
               **mlstm_bound(B, S, H, hd, dtname),
               "cuda_kernels_per_call": sum(r["per_call"]
                                            for r in per_call.values()),
               "kernel_us": {k: r["us"] for k, r in per_call.items()}}
        results[name] = rec
        emit("mlstm_chunk", **rec)
        del q, k, v, g, i, head, step, y, st, want, pst, oracle
    torch.cuda.empty_cache()
    return results


def init_xlstm(torch):
    from repro_torch.configs.base import get_config

    cfg = get_config("xlstm-350m")
    return cfg, init_weights(torch, cfg)


def phase_serve_xlstm(torch, cfg, params_f32):
    from repro_torch import tree
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    B, S, n_new = 4, 128, 32
    n_mlstm = sum(s.kind == "mlstm" for s in M.layer_specs(cfg))
    params = cast(params_f32, "cuda", torch.bfloat16)
    engine = ServeEngine(cfg, params, max_len=S + n_new)
    prompts = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    engine.generate(prompts, 2)   # warm-up: cuBLAS handles, allocator

    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    ids = engine.generate(prompts, n_new)       # ends in one .cpu() copy
    gen_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    check(launches == {"mlstm_chunk": n_mlstm},
          f"xlstm serve launched {launches}, want {{'mlstm_chunk': "
          f"{n_mlstm}}} (the prefill of each mLSTM block, no attention)")
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
                                                       batch), reps=3,
                              warmup=1)
    gen_ms = gen_s * 1e3
    n_params = sum(x.numel() for x in tree.leaves(params))
    emit("serve_xlstm", arch=cfg.name, dtype="bfloat16", batch=B, prompt=S,
         n_new=n_new, params=n_params, mlstm_layers=n_mlstm,
         launches=launches, generate_ms=gen_ms, prefill_ms=prefill_ms,
         decode_ms_per_token=(gen_ms - prefill_ms) / n_new,
         tokens_per_s=B * n_new / gen_s, max_memory_allocated=peak,
         first_ids=ids[0, :8].tolist())

    n_prof = 4
    t0 = time.perf_counter()
    engine.generate(prompts, n_prof)
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = device_profile(torch, lambda: engine.generate(prompts, n_prof))
    emit("serve_xlstm_profile", n_new=n_prof, wall_ms=wall_ms,
         device_busy_share=prof["device_ms"] / wall_ms, **prof)
    del engine, params
    torch.cuda.empty_cache()
    return launches


def phase_xlstm_parity(torch, cfg_full, params_f32):
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    n_layers = cfg_full.slstm_every   # one 7 mLSTM + 1 sLSTM period
    cfg = dataclasses.replace(cfg_full, n_layers=n_layers, dtype="float32")
    params = dict(params_f32, layers=params_f32["layers"][:n_layers])
    S, n_new = 64, 8
    prompt = np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, size=(1, S), dtype=np.int32)
    seconds = {}
    cpu = ServeEngine(cfg, params, max_len=S + n_new, device="cpu")
    gpu = ServeEngine(cfg, cast(params, "cuda", torch.float32),
                      max_len=S + n_new)
    logits, ids = {}, {}
    for name, eng in (("cpu", cpu), ("cuda", gpu)):
        t0 = time.perf_counter()
        toks = torch.as_tensor(prompt, dtype=torch.int64, device=eng.device)
        batch = {"tokens": toks,
                 "positions": torch.arange(S, device=eng.device)[None]}
        with torch.inference_mode():
            logits[name] = M.prefill(cfg, eng.params, batch)[0].float().cpu()
        ids[name] = eng.generate(prompt, n_new)
        seconds[name] = time.perf_counter() - t0
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    same = bool(np.array_equal(ids["cpu"], ids["cuda"]))
    top2 = torch.topk(logits["cpu"][0], 2).values
    emit("serve_xlstm_parity", dtype="float32", layers=n_layers, prompt=S,
         n_new=n_new, logits_max_abs_err=err, tol=PARITY_LOGIT_ATOL,
         logits_max_abs=logits["cpu"].abs().max().item(), ids_equal=same,
         ids_cpu=ids["cpu"][0].tolist(), ids_cuda=ids["cuda"][0].tolist(),
         first_logit_gap=(top2[0] - top2[1]).item(), seconds=seconds)
    check(err <= PARITY_LOGIT_ATOL,
          f"xlstm prefill logits differ by {err} > {PARITY_LOGIT_ATOL}")
    check(same, "xlstm greedy ids differ between the CPU and the card")
    del gpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# xLSTM training on the card (mlstm_chunk through its autograd Function)
# and the MoE family (deepseek-moe-16b): served at full depth, trained at
# depth 2 under the DMM cutoff.
# ---------------------------------------------------------------------------

# (name, B, S, H, hd): train_xlstm's per-worker shape and a multi-chunk S
MLSTM_GRAD_CASES = [("train_b2_s128", 2, 128, 4, 512),
                    ("s300", 2, 300, 4, 512)]
MLSTM_GRAD_HEADLINE = "train_b2_s128"
# the Function's gradients are the plain recurrence's own on the same
# inputs (its backward recomputes it in f32), each rounded once to its
# input's dtype: held to 1e-6 of their scale against autograd of the plain
# path on f32 copies of the inputs, rounded the same way; y to the
# forward's MLSTM_TOL
MLSTM_GRAD_TOL = 1e-6
# train_moe_parity: the first step's gradient (identical params on both
# devices) at train_parity's 1e-4; the second step's, and m which mixes
# the two, at 5e-4.  Adam's first update moves every entry whose gradient
# sits at rounding noise by lr times a sign the devices may disagree on,
# so the second gradient is taken at params up to 2 lr apart.  With the
# weights drawn on the host, layer 0's dense w_up (2048 x 10944) read
# 1.84e-4 of its scale there against 3.9e-6 at the first step; drawn on
# the card as now, 7.7e-5 against 3.6e-6 (PERF.md §6;
# scripts/torch_moe_grad_leaves.py: one step's loss gradient ~4e-6 apart,
# the CPU against itself in another summation order ~3e-6)
MOE_PARITY_TOL = dict(PARITY_TOL, grad_later=5e-4, m=5e-4)
XLSTM_STEPS = 3
MOE_STEPS = 4
MOE_REPLAY = 2


def _dmm_controller(rm):
    """train_dmm's controller on its fitted model: CutoffController(rm,
    k_samples=48) seeded with the trace the model was fitted on."""
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import CutoffController

    ctl = CutoffController(rm, k_samples=48)
    ctl.seed_window(ClusterSim(n_workers=8, n_nodes=2, seed=0).run(200))
    return ctl


def mlstm_bwd_bound(B, S, H, hd, dtname):
    """The least time of the mLSTM's backward (dy -> dq, dk, dv, dg, di),
    in ms, with its basis: q/k/v, the gates and dy read once, the five
    gradients written once, over 3.35 TB/s, against twice the forward's
    operations (each product's gradient is two products of its size) at
    the forward's rates; the f32-FMA floor of the same count beside it.
    The plain backward the Function runs also recomputes the forward (one
    more forward's operations), which the bound leaves out."""
    elt = 2 if dtname == "bfloat16" else 4
    nbytes = (2 * (3 * B * S * H * hd * elt + 2 * B * S * H * 4)
              + B * S * H * hd * 4)
    qk, rest = mlstm_ops(B, S, H, hd, PALLAS_MLSTM_CHUNK)
    qk_rate = PEAK_OPS["bfloat16"] if dtname == "bfloat16" else TF32_OPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * (qk / qk_rate + rest / TF32_OPS) * 1e3
    return {"bwd_bound_ms": max(t_bytes, t_ops),
            "bwd_bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bwd_fma_floor_ms": 2 * (qk + rest) / PEAK_OPS["float32"] * 1e3,
            "bwd_bytes": nbytes, "bwd_ops": 2 * (qk + rest)}


def phase_mlstm_grad(torch):
    """MLSTMChunk (the kernel forward, the plain recurrence's backward) on
    the card against autograd of the plain path on the card, bf16 q/k/v
    and f32 gates: y and the gradients of q, k, v, g, i; the forward's
    device ms (graph replay) and the backward's (the profiler's kernel
    time of one plain recompute-and-differentiate, what the Function's
    backward runs) beside the backward's bound."""
    from repro_torch.kernels import build
    from repro_torch.kernels.mlstm_chunk import MLSTMChunk, mlstm_chunk
    from repro_torch.kernels.mlstm_plain import linear_recurrence

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    side = torch.cuda.Stream()
    results = {}
    for name, B, S, H, hd in MLSTM_GRAD_CASES:
        xs = _mlstm_inputs(torch, B, S, H, hd, "bfloat16", "normal", gen)
        r = torch.randn((B, S, H, hd), generator=gen, device="cuda")
        leaves = [t.detach().requires_grad_(True) for t in xs]
        build.LAUNCHES.clear()
        y, *_ = MLSTMChunk.apply(*leaves)
        got = torch.autograd.grad((y * r).sum(), leaves)
        check(build.LAUNCHES["mlstm_chunk"] == 1,
              f"mlstm_grad {name}: {dict(build.LAUNCHES)} launches")
        # the plain path on f32 copies of the same inputs: its gradients
        # rounded once to each input's dtype are what the Function returns
        plain = [t.detach().float().requires_grad_(True) for t in xs]
        yp, _ = linear_recurrence(*plain)
        want = torch.autograd.grad((yp * r).sum(), plain)
        torch.cuda.synchronize()
        y_ex = _allclose_excess(torch, y, yp, MLSTM_TOL, MLSTM_TOL).item()
        check(y_ex <= MLSTM_TOL, f"mlstm_grad {name}: y off by {y_ex}")
        errs = {}
        for key, a, b, x in zip("qkvgi", got, want, xs):
            check(a.dtype == x.dtype, f"mlstm_grad {name}: d{key} is "
                  f"{a.dtype}, its input {x.dtype}")
            check(bool(torch.isfinite(a).all()),
                  f"mlstm_grad {name}: d{key} not finite")
            errs[key] = _scaled_err(torch, [a.float()],
                                    [b.to(a.dtype).float()])
            check(errs[key] <= MLSTM_GRAD_TOL, f"mlstm_grad {name}: d{key} "
                  f"off by {errs[key]} of its scale")

        def bwd():
            with torch.enable_grad():
                ls = [t.detach().requires_grad_(True) for t in xs]
                out, _ = linear_recurrence(*(t.float() for t in ls))
                return torch.autograd.grad(out, ls, r)

        fwd_ms = device_ms(torch, lambda: mlstm_chunk(*xs), side)
        bwd_eager = eager_ms(torch, bwd, reps=5, warmup=2)
        prof = device_profile(torch, bwd, n_top=5)
        rec = {"case": name, "shape": [B, S, H, hd], "dtype": "bfloat16",
               "y_max_abs_err": (y - yp).abs().max().item(),
               "grad_scaled_err": errs, "tol": {"y": MLSTM_TOL,
                                                "grad": MLSTM_GRAD_TOL},
               "fwd_ms": fwd_ms, "bwd_ms": prof["device_ms"],
               "bwd_eager_ms": bwd_eager,
               "bwd_device_events": prof["device_events"],
               "bwd_top": prof["top"],
               **mlstm_bound(B, S, H, hd, "bfloat16"),
               **mlstm_bwd_bound(B, S, H, hd, "bfloat16")}
        results[name] = rec
        emit("mlstm_grad", **rec)
        del xs, r, leaves, y, got, plain, yp, want
    torch.cuda.empty_cache()
    return results


def phase_train_xlstm(torch, cfg, params_f32, rm):
    """Full-width, full-depth xlstm-350m (bf16) trained by the psum step
    under train_dmm's DMM controller over ClusterSim(8, 2 nodes, seed 7):
    seq 128 x batch 16, W 8, fused AdamW.  Each step asserts 21 x 8
    mlstm_chunk launches (every mLSTM block of every worker, forward
    through MLSTMChunk), one masked_grad_agg, one fused_adam, no flash
    launch, a finite loss."""
    from repro_torch import tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.kernels import build
    from repro_torch.models import model as M

    W, S, B = 8, 128, 16
    n_mlstm = sum(s.kind == "mlstm" for s in M.layer_specs(cfg))
    params = cast(params_f32, "cuda", torch.bfloat16)
    tr, opt = _train_setup(torch, cfg, params, n_workers=W, seq=S, batch=B,
                           controller=_dmm_controller(rm),
                           timer=ClusterSim(n_workers=W, n_nodes=2, seed=7))
    want = {"mlstm_chunk": n_mlstm * W, "masked_grad_agg": 1,
            "fused_adam": 1}
    totals, walls = {}, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(XLSTM_STEPS):
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        rec = tr.run(1)[-1]        # drains the loss: ends in a device sync
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        check(launches == want, f"train_xlstm step {rec['step']}: launches "
              f"{launches}, want {want}")
        check(bool(np.isfinite(rec["loss"])),
              f"train_xlstm step {rec['step']}: loss {rec['loss']}")
        walls.append(wall * 1e3)
        emit("train_xlstm", arch=cfg.name, dtype="bfloat16", step=rec["step"],
             wall_ms=wall * 1e3, tokens_per_s=B * S / wall, c=rec["c"],
             n=rec["n"], loss=rec["loss"], clock=rec["clock"],
             launches=launches,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    n_params = sum(x.numel() for x in tree.leaves(params))
    emit("train_xlstm_summary", params=n_params, layers=cfg.n_layers,
         mlstm_layers=n_mlstm, workers=W, seq=S, batch=B,
         median_wall_ms=float(np.median(walls[1:])), launches=totals,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del tr, opt, params
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def phase_train_xlstm_parity(torch, cfg_full):
    """xlstm-350m at full width, depth 2 with the sLSTM kept (one mLSTM
    and one sLSTM block), f32, W 4, seq 32 x batch 8: the psum step's 2
    steps on the CPU against the card, train_parity's comparisons."""
    from repro_torch.models import model as M

    cfg = dataclasses.replace(cfg_full, n_layers=2, slstm_every=2,
                              dtype="float32")
    p_cpu = M.init_model(cfg, torch.Generator().manual_seed(SEED + 9),
                         device="cpu", dtype=torch.float32)
    rec, _ = _train_parity(torch, cfg, p_cpu, W=4, S=32, B=8, n_steps=2,
                           cutoff=3)
    emit("train_xlstm_parity", arch=cfg.name,
         kinds=[s.kind for s in M.layer_specs(cfg)], **rec)
    _check_train_parity(rec, "train_xlstm_parity")


class _DropCount:
    """Counts the routed slots the MoE dispatch keeps and drops while it is
    installed (``moe.dispatch_plan`` wrapped; the counts stay on the device
    until read)."""

    def __init__(self, moe):
        self.moe, self.inner, self.kept, self.total = moe, None, [], 0

    def __enter__(self):
        self.inner = self.moe.dispatch_plan

        def counted(topk_i, n_experts, capacity):
            plan = self.inner(topk_i, n_experts, capacity)
            self.kept.append((plan.dst < n_experts * capacity).sum())
            self.total += plan.dst.numel()
            return plan

        self.moe.dispatch_plan = counted
        return self

    def __exit__(self, *exc):
        self.moe.dispatch_plan = self.inner

    def share(self, torch):
        kept = int(torch.stack(self.kept).sum()) if self.kept else 0
        return {"routed_slots": self.total,
                "dropped": self.total - kept,
                "dropped_share": (self.total - kept) / max(self.total, 1)}


def init_moe(torch, cfg, dtype, seed):
    """deepseek-moe-16b's weights drawn on the card by a CUDA generator,
    one weight at a time (the full model in f32 would need 65 GB of
    host memory)."""
    from repro_torch.models import model as M

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return M.init_model(cfg, gen, device="cuda", dtype=dtype)


def phase_serve_moe(torch, cfg):
    """Full-depth deepseek-moe-16b (28 layers, bf16, weights drawn on the
    card) through ServeEngine.generate: 4 prompts x 128 tokens, 32 greedy
    new tokens; asserts 28 x 33 flash launches and ids in range; prefill
    ms, ms per token, tokens/s, peak memory, and the share of routed slots
    dropped at capacity in a prefill; then the device's busy share of a
    short request."""
    from repro_torch import tree
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serving.engine import ServeEngine

    B, S, n_new = 4, 128, 32
    t0 = time.perf_counter()
    params = init_moe(torch, cfg, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree.leaves(params))
    check(n_params == cfg.n_params(), f"deepseek-moe-16b: {n_params} "
          f"parameters, want {cfg.n_params()}")
    engine = ServeEngine(cfg, params, max_len=S + n_new)
    prompts = np.random.default_rng(SEED + 10).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    engine.generate(prompts, 2)   # warm-up: cuBLAS handles, allocator

    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    ids = engine.generate(prompts, n_new)       # ends in one .cpu() copy
    gen_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    want = {"flash_attention": cfg.n_layers * (1 + n_new)}
    check(launches == want, f"serve_moe launched {launches}, want {want}")
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
                                                       batch), reps=3,
                              warmup=1)
        with _DropCount(moe) as drops:
            M.prefill(cfg, engine.params, batch)
    gen_ms = gen_s * 1e3
    emit("serve_moe", arch=cfg.name, dtype="bfloat16", batch=B, prompt=S,
         n_new=n_new, params=n_params, layers=cfg.n_layers,
         init_s=init_s, launches=launches, generate_ms=gen_ms,
         prefill_ms=prefill_ms,
         decode_ms_per_token=(gen_ms - prefill_ms) / n_new,
         tokens_per_s=B * n_new / gen_s, max_memory_allocated=peak,
         capacity_prefill=moe.capacity_for(cfg, B * S),
         capacity_decode=moe.capacity_for(cfg, B),
         prefill_drops=drops.share(torch), first_ids=ids[0, :8].tolist())

    n_prof = 4
    t0 = time.perf_counter()
    engine.generate(prompts, n_prof)
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = device_profile(torch, lambda: engine.generate(prompts, n_prof))
    emit("serve_moe_profile", n_new=n_prof, wall_ms=wall_ms,
         device_busy_share=prof["device_ms"] / wall_ms, **prof)
    del engine, params, batch, toks
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_moe_parity(torch, cfg_full):
    """deepseek-moe-16b at full width and depth 2 (the dense first layer
    and one MoE layer), f32: prefill logits within PARITY_LOGIT_ATOL and
    equal greedy ids, the CPU (plain path) against the card (kernels)."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(cfg_full, n_layers=2, dtype="float32")
    params = cast(init_moe(torch, cfg, torch.float32, SEED + 11), "cpu",
                  torch.float32)
    torch.cuda.empty_cache()
    S, n_new = 64, 8
    prompt = np.random.default_rng(SEED + 12).integers(
        0, cfg.vocab_size, size=(1, S), dtype=np.int32)
    seconds, logits, ids = {}, {}, {}
    cpu = ServeEngine(cfg, params, max_len=S + n_new, device="cpu")
    gpu = ServeEngine(cfg, cast(params, "cuda", torch.float32),
                      max_len=S + n_new)
    for name, eng in (("cpu", cpu), ("cuda", gpu)):
        t0 = time.perf_counter()
        toks = torch.as_tensor(prompt, dtype=torch.int64, device=eng.device)
        batch = {"tokens": toks,
                 "positions": torch.arange(S, device=eng.device)[None]}
        with torch.inference_mode():
            logits[name] = M.prefill(cfg, eng.params, batch)[0].float().cpu()
        ids[name] = eng.generate(prompt, n_new)
        seconds[name] = time.perf_counter() - t0
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    same = bool(np.array_equal(ids["cpu"], ids["cuda"]))
    top2 = torch.topk(logits["cpu"][0], 2).values
    emit("serve_moe_parity", arch=cfg.name, dtype="float32",
         layers=cfg.n_layers, prompt=S, n_new=n_new,
         logits_max_abs_err=err, tol=PARITY_LOGIT_ATOL,
         logits_max_abs=logits["cpu"].abs().max().item(), ids_equal=same,
         ids_cpu=ids["cpu"][0].tolist(), ids_cuda=ids["cuda"][0].tolist(),
         first_logit_gap=(top2[0] - top2[1]).item(), seconds=seconds,
         host_rss=_host_rss())
    check(err <= PARITY_LOGIT_ATOL,
          f"moe prefill logits differ by {err} > {PARITY_LOGIT_ATOL}")
    check(same, "moe greedy ids differ between the CPU and the card")
    del gpu, cpu, params
    gc.collect()
    torch.cuda.empty_cache()


def _moe_kernel_times(torch, buf, state):
    """masked_grad_agg on the trainer's own (W, N) buffer and fused_adam
    over its leaves (bf16 p, random bf16 g, its f32 m and v), at the MoE
    trainer's N: kernel, plain and library device ms beside the bounds.
    The plain masked mean runs over column blocks of 2^27 (one call over
    the whole buffer would need a second (W, N) f32 temporary)."""
    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_adam import LeafTable, fused_adam_
    from repro_torch.kernels.masked_grad_agg import masked_grad_agg
    from repro_torch.kernels.ref import reference_adam, reference_masked_agg

    side = torch.cuda.Stream()
    W, N = buf.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mask = _agg_masks(torch, W, gen)["bits"]
    cols = 1 << 27
    blocks = [(a, min(a + cols, N)) for a in range(0, N, cols)]
    got = masked_grad_agg(buf, mask)
    err = max((got[a:b] - reference_masked_agg(
        buf[:, a:b], mask.reshape(-1, 1))[0]).abs().max().item()
        for a, b in blocks)
    del got
    check(err <= AGG_TOL["float32"], f"masked_grad_agg on the ({W}, N) "
          f"MoE buffer: off by {err}")
    m2 = mask.reshape(1, W)
    c = torch.clamp(mask.sum(), min=1.0)
    agg = {"W": W, "N": N, "max_abs_err": err,
           "ms": device_ms(torch, lambda: masked_grad_agg(buf, mask), side,
                           reps=5),
           "plain_ms": device_ms(torch, lambda: [reference_masked_agg(
               buf[:, a:b], mask.reshape(-1, 1)) for a, b in blocks], side,
               reps=2),
           "library_ms": device_ms(torch, lambda: (m2 @ buf) / c, side,
                                   reps=5)}
    nbytes = W * N * 4 + N * 4 + 4 * W
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * W * N / PEAK_OPS["float32"] * 1e3
    agg.update(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, plain_blocks=len(blocks))
    emit("train_moe_masked_grad_agg", **agg)

    ps = tree.leaves(state["params"])
    ms, vs = tree.leaves(state["opt"]["m"]), tree.leaves(state["opt"]["v"])
    gs = [(torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
           ).to(p.dtype) for p in ps]
    scal = ops.adam_scalars(10, 3e-4, 0.9, 0.999)
    table = LeafTable()
    n_params = sum(p.numel() for p in ps)
    adam = {"leaves": len(ps), "params": n_params,
            "ms": device_ms(torch, lambda: fused_adam_(
                ps, gs, ms, vs, scal, wd=0.01, table=table), side, reps=5),
            "plain_ms": device_ms(torch, lambda: [
                reference_adam(p, g, m, v, scal, wd=0.01)
                for p, g, m, v in zip(ps, gs, ms, vs)], side, reps=2)}
    lib_params = [p.detach().clone() for p in ps]
    for lp, g in zip(lib_params, gs):
        lp.grad = g
    lib = torch.optim.AdamW(lib_params, lr=3e-4, weight_decay=0.01,
                            fused=True, capturable=True)
    adam["library_ms"] = device_ms(torch, lib.step, side, reps=5)
    adam["library"] = ("torch.optim.AdamW(fused=True, capturable=True), "
                       "bf16 params, grads and moments")
    pe = ps[0].element_size()
    nbytes = n_params * (2 * pe + pe + 2 * 4 * 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 12 * n_params / PEAK_OPS["float32"] * 1e3
    adam.update(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes)
    emit("train_moe_fused_adam", **adam)
    del gs, lib_params, lib, table
    return agg, adam


def phase_train_moe(torch, cfg_full, rm):
    """deepseek-moe-16b at full width and depth 2 (layer 0 dense, layer 1
    MoE; bf16, weights drawn on the card) trained by the psum step under
    train_dmm's DMM controller over ClusterSim(8, 2 nodes, seed 7): seq
    128 x batch 16, W 8, fused AdamW.  A first run of MOE_REPLAY steps
    (the dropped share counted), then a second run from the same state,
    controller, timer and data that must give the same losses and
    parameters bit for bit over those steps (the dispatch writes no
    buffer by a scatter-add) and goes on to MOE_STEPS steps, each
    asserting its launches (flash 2 x 8, masked_grad_agg 1, fused_adam 1),
    a finite loss and aux.  The two runs share one step function: one
    (8, N) buffer.  Then the kernels at this N on the trainer's own
    buffer and state."""
    from repro_torch import tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.kernels import build
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import moe
    from repro_torch.optim import adamw, cosine_schedule

    cfg = dataclasses.replace(cfg_full, n_layers=2)
    W, S, B = 8, 128, 16
    t0 = time.perf_counter()
    p0 = cast(init_moe(torch, cfg, torch.bfloat16, SEED + 13), "cpu",
              torch.bfloat16)
    n_params = sum(x.numel() for x in tree.leaves(p0))
    check(n_params == cfg.n_params(), f"depth-2 deepseek-moe-16b: "
          f"{n_params} parameters, want {cfg.n_params()}")
    opt = adamw(cosine_schedule(3e-4, 2, 20), fused=True)
    step_fn = make_train_step(cfg, opt, mask_agg="psum")
    setup_s = time.perf_counter() - t0

    def trainer(mets):
        return _train_setup(
            torch, cfg, cast(p0, "cuda", torch.bfloat16), n_workers=W,
            seq=S, batch=B, controller=_dmm_controller(rm),
            timer=ClusterSim(n_workers=W, n_nodes=2, seed=7),
            metrics_out=mets, opt=opt, step_fn=step_fn)[0]

    # run 1: the replayed steps, with the dropped slots counted
    mets1 = []
    tr = trainer(mets1)
    with _DropCount(moe) as drops:
        hist1 = [dict(h) for h in tr.run(MOE_REPLAY)]
    after1 = _cpu_copy(torch, tr.state["params"])
    drop_share = drops.share(torch)
    aux1 = [float(m["aux"]) for m in mets1]
    del tr
    gc.collect()

    want = {"flash_attention": cfg.n_layers * W, "masked_grad_agg": 1,
            "fused_adam": 1}
    mets = []
    tr = trainer(mets)
    totals, walls, steps = {}, [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(MOE_STEPS):
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        rec = tr.run(1)[-1]        # drains the loss: ends in a device sync
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        aux = float(mets[-1]["aux"])
        check(launches == want, f"train_moe step {rec['step']}: launches "
              f"{launches}, want {want}")
        check(bool(np.isfinite(rec["loss"])) and np.isfinite(aux)
              and aux > 0.0, f"train_moe step {rec['step']}: loss "
              f"{rec['loss']}, aux {aux}")
        if i + 1 == MOE_REPLAY:
            replay = {
                "losses_equal": [h["loss"] for h in hist1]
                == [h["loss"] for h in tr.history],
                "cutoffs_equal": [h["c"] for h in hist1]
                == [h["c"] for h in tr.history],
                "aux_equal": aux1 == [float(m["aux"]) for m in mets],
                "params_equal": _bit_equal(
                    torch, after1, _cpu_copy(torch, tr.state["params"]))}
            check(all(replay.values()), f"train_moe: the replay of "
                  f"{MOE_REPLAY} steps differs: {replay}")
            del after1
        walls.append(wall * 1e3)
        steps.append({"step": rec["step"], "c": rec["c"], "n": rec["n"],
                      "loss": rec["loss"], "aux": aux,
                      "clock": rec["clock"], "wall_ms": wall * 1e3})
        emit("train_moe", arch=cfg.name, dtype="bfloat16", **steps[-1],
             tokens_per_s=B * S / wall, launches=launches,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    peak = torch.cuda.max_memory_allocated()
    # the device's busy share of one more step
    wall = []

    def one_step():
        t0 = time.perf_counter()
        tr.run(1)
        wall.append((time.perf_counter() - t0) * 1e3)

    prof = device_profile(torch, one_step)
    emit("train_moe_profile", wall_ms=wall[0],
         device_busy_share=prof["device_ms"] / wall[0], **prof)
    check(len(step_fn.buffers) == 1, f"train_moe: {len(step_fn.buffers)} "
          f"worker buffers, want the one (8, N)")
    buf = next(iter(step_fn.buffers.values())).buf
    agg, adam = _moe_kernel_times(torch, buf, tr.state)
    emit("train_moe_summary", params=n_params, layers=cfg.n_layers,
         workers=W, seq=S, batch=B, setup_s=setup_s,
         median_wall_ms=float(np.median(walls[1:])), launches=totals,
         max_memory_allocated=peak, replay=replay,
         replay_losses=[h["loss"] for h in hist1], replay_aux=aux1,
         capacity=moe.capacity_for(cfg, (B // W) * S),
         dropped=drop_share)
    del tr, buf, step_fn, opt, p0
    gc.collect()
    torch.cuda.empty_cache()
    return totals, agg, adam


def phase_train_moe_parity(torch, cfg_full):
    """deepseek-moe-16b at full width and depth 2, f32, W 2 (one worker
    dropped), seq 32 x batch 4, fused AdamW, 2 steps: the card against the
    CPU, train_parity's comparisons at MOE_PARITY_TOL and the aux of every
    step; the host's resident bytes (the CPU run holds the model's f32
    state and gradients: ~46 GB at its peak)."""
    cfg = dataclasses.replace(cfg_full, n_layers=2, dtype="float32")
    # drawn on the card, then copied: the CPU's draw of 1.09e9 normals
    # would take seconds of the phase
    p_cpu = cast(init_moe(torch, cfg, torch.float32, SEED + 14), "cpu",
                 torch.float32)
    torch.cuda.empty_cache()
    rec, aux = _train_parity(torch, cfg, p_cpu, W=2, S=32, B=4, n_steps=2,
                             cutoff=1)
    aux_err = max(abs(a - b) for a, b in zip(aux["cpu"], aux["cuda"]))
    rec["tol"] = MOE_PARITY_TOL
    emit("train_moe_parity", arch=cfg.name, aux_cpu=aux["cpu"],
         aux_cuda=aux["cuda"], aux_max_abs_err=aux_err,
         host_rss=_host_rss(), **rec)
    _check_train_parity(rec, "train_moe_parity", MOE_PARITY_TOL)
    check(aux_err <= MOE_PARITY_TOL["loss"], f"train_moe_parity: aux "
          f"differs by {aux_err}")


def timed(seconds, name, fn, *args):
    """Run one phase and keep its wall time under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    seconds[name] = time.perf_counter() - t0
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import tree
    from repro_torch.configs.base import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(8)

    sec = {"start": time.perf_counter() - t_start}
    timed(sec, "build", phase_build)
    flash = timed(sec, "flash_attention", phase_flash, torch)
    mlstm = timed(sec, "mlstm_chunk", phase_mlstm, torch)
    cfg = get_config("qwen2-0.5b")
    params_f32 = timed(sec, "init_weights", init_weights, torch, cfg)
    serve_launches = timed(sec, "serve", phase_serve, torch, cfg, params_f32)
    timed(sec, "serve_parity", phase_parity, torch, cfg, params_f32)
    agg, agg_err = timed(sec, "masked_grad_agg", phase_masked_agg, torch)
    shapes = [tuple(x.shape) for x in tree.leaves(params_f32)]
    adam, adam_err = timed(sec, "fused_adam", phase_fused_adam, torch, shapes)
    train_launches, firstk_clocks = timed(sec, "train", phase_train, torch,
                                          cfg, params_f32)
    timed(sec, "train_parity", phase_train_parity, torch, cfg)
    timed(sec, "dmm", phase_dmm, torch)
    timed(sec, "ps", phase_ps, torch)
    timed(sec, "cnn", phase_cnn, torch)
    supervised_launches = timed(sec, "supervised", phase_supervised, torch)
    dmm_launches, rm = timed(sec, "train_dmm", phase_train_dmm, torch, cfg,
                             params_f32, firstk_clocks)
    obs_launches = timed(sec, "obs", phase_obs, torch, cfg, params_f32, rm)
    policy_launches = timed(sec, "train_policies", phase_train_policies,
                            torch, cfg, params_f32, rm)
    elastic_launches, agg_w6 = timed(sec, "train_elastic",
                                     phase_train_elastic, torch, cfg,
                                     params_f32)
    del params_f32
    multi_launches, agg_w4 = timed(sec, "train_multi_job",
                                   phase_train_multi_job, torch, cfg)
    xcfg, xparams = timed(sec, "init_xlstm", init_xlstm, torch)
    xlstm_launches = timed(sec, "serve_xlstm", phase_serve_xlstm, torch,
                           xcfg, xparams)
    timed(sec, "serve_xlstm_parity", phase_xlstm_parity, torch, xcfg,
          xparams)
    mlstm_grad = timed(sec, "mlstm_grad", phase_mlstm_grad, torch)
    xtrain_launches = timed(sec, "train_xlstm", phase_train_xlstm, torch,
                            xcfg, xparams, rm)
    del xparams
    timed(sec, "train_xlstm_parity", phase_train_xlstm_parity, torch, xcfg)
    mcfg = get_config("deepseek-moe-16b")
    moe_serve_launches = timed(sec, "serve_moe", phase_serve_moe, torch, mcfg)
    timed(sec, "serve_moe_parity", phase_serve_moe_parity, torch, mcfg)
    moe_train_launches, agg_moe, adam_moe = timed(
        sec, "train_moe", phase_train_moe, torch, mcfg, rm)
    del rm
    timed(sec, "train_moe_parity", phase_train_moe_parity, torch, mcfg)
    emit("seconds", **sec, total=time.perf_counter() - t_start)

    def launches(name):
        by_path = {"serve": serve_launches.get(name, 0),
                   "train_psum_5_steps": train_launches.get(name, 0),
                   "train_dmm": dmm_launches.get(name, 0),
                   "obs": obs_launches.get(name, 0),
                   "train_policies": policy_launches.get(name, 0),
                   "train_elastic": elastic_launches.get(name, 0),
                   "train_multi_job": multi_launches.get(name, 0),
                   "serve_xlstm": xlstm_launches.get(name, 0),
                   "supervised": supervised_launches.get(name, 0),
                   "train_xlstm": xtrain_launches.get(name, 0),
                   "serve_moe": moe_serve_launches.get(name, 0),
                   "train_moe": moe_train_launches.get(name, 0)}
        return sum(by_path.values()), by_path

    def worst(cases, head):
        """max_abs_err over a grid of cases, the case that gave it (with the
        output's largest magnitude there, where recorded) and the headline
        case's own error."""
        w = max(cases.values(), key=lambda r: r["max_abs_err"])
        out = {"max_abs_err_case": w["case"],
               "case_max_abs_err": cases[head]["max_abs_err"]}
        if "y_max_abs" in w:
            out["max_abs_err_y_max_abs"] = w["y_max_abs"]
        return w["max_abs_err"], out

    flash_err, flash_extra = worst(flash, HEADLINE_CASE)
    mlstm_err, mlstm_extra = worst(mlstm, MLSTM_HEADLINE)
    head = flash[HEADLINE_CASE]
    agg_head, adam_head = agg[AGG_HEADLINE], adam[ADAM_HEADLINE]
    rows = []
    # max_abs_err is the largest over each kernel's checked grid
    for name, replaces, err, rec, case, extra in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:93",
             flash_err, head, HEADLINE_CASE, flash_extra),
            ("masked_grad_agg", "src/repro/kernels/masked_grad_agg.py:32",
             agg_err, agg_head, AGG_HEADLINE,
             {f"{w}_{k}": agg[k] for w, agg in (("w6", agg_w6),
                                                ("w4", agg_w4),
                                                ("moe_w8", agg_moe))
              for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "max_abs_err")} | {"moe_w8_N": agg_moe["N"]}),
            ("fused_adam", "src/repro/kernels/fused_adam.py:40", adam_err,
             adam_head, ADAM_HEADLINE,
             {f"moe_{k}": adam_moe[k] for k in ("params", "ms", "plain_ms",
                                                "library_ms", "bound_ms")}),
            ("mlstm_chunk", "src/repro/kernels/mlstm_chunk.py:87",
             mlstm_err, mlstm[MLSTM_HEADLINE], MLSTM_HEADLINE,
             {**mlstm_extra,
              **{k: mlstm[MLSTM_HEADLINE][k]
                 for k in ("path", "fma_floor_ms",
                           "cuda_kernels_per_call")},
              "bwd_case": MLSTM_GRAD_HEADLINE,
              **{k: mlstm_grad[MLSTM_GRAD_HEADLINE][k]
                 for k in ("fwd_ms", "bwd_ms", "bwd_bound_ms",
                           "bwd_bound_by")}})):
        total, by_path = launches(name)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": total,
            "launches_by_path": by_path, "max_abs_err": err,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "case": case, **extra})
    dec = flash[DECODE_CASE]
    rows[0].update({"decode_case": DECODE_CASE, "decode_ms": dec["ms"],
                    "decode_library_ms": dec["library_ms"],
                    "decode_bound_ms": dec["bound_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
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
