"""Capture audit: the port's hot entry points hold their one-dispatch
contract on the card.

The port's counterpart of ``repro.analysis.jaxpr_audit``.  The lint rules
prove the HOST side of the hot-path contract; this module proves the
DEVICE side, on the card only (``run_audit`` raises without one).  Each
entry is built small and warmed up, then checked one of two ways:

* **captured** into a ``torch.cuda.CUDAGraph`` with
  ``capture_error_mode="thread_local"``, which fails on any sync, blocking
  copy or host read the capturing thread makes; its kernel nodes, and
  all its nodes (copies and memsets too), are counted off the graph's
  debug dump;
* or, for the eager train step, **run** under
  ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
  synchronizing call.

Where the reference checks that its donation took effect, the port checks
that the update was in place: the leaves the entry updates keep their
storage (``data_ptr``) across it, and the entry did write them.

Entries (the reference's five, then the decode step of six families):

* ``fused_observe_decide`` — the controller's graph body
  (``core.controller._observe_decide_core``, censored mode) on its state;
* ``batched_observe_decide_ragged`` — the server bucket's graph body
  (``ps.server._full_observe_decide``) at J 3, widths 4/6/8 padded to 8;
* ``train_step[mask_agg=weights]`` / ``train_step[mask_agg=psum]`` — one
  step of the tiny bench config on device batches, sync-free, params and
  Adam moments in place;
* ``obs_ring_push`` — ``obs.metrics.MetricRing.push`` of device values;
* ``decode_step[<arch>]`` — ``serving.engine``'s decode graph (the step
  of ``DecodeState``) for qwen2-0.5b, xlstm-350m, hymba-1.5b,
  deepseek-moe-16b, whisper-base and qwen2-vl-7b at depth 2, B 4, a
  padded length of 64, bf16, captured by ``ServeEngine.generate`` itself
  and replayed once a token.

``write_report`` pins the result to ``ANALYSIS_torch.json``
(schema-guarded by ``tests/test_torch_lint_clean.py``).
"""
from __future__ import annotations

import dataclasses
import json
import tempfile
from pathlib import Path
from typing import Callable, Dict, List

SCHEMA_VERSION = 1

DECODE_ARCHS = ("qwen2-0.5b", "xlstm-350m", "hymba-1.5b",
                "deepseek-moe-16b", "whisper-base", "qwen2-vl-7b")
DECODE_DEPTH = 2
DECODE_B = 4
DECODE_LEN = 64          # the padded cache: a 48-token prompt + 16 tokens
DECODE_NEW = 16

ENTRY_NAMES = (("fused_observe_decide", "batched_observe_decide_ragged",
                "train_step[mask_agg=weights]", "train_step[mask_agg=psum]",
                "obs_ring_push")
               + tuple(f"decode_step[{a}]" for a in DECODE_ARCHS))


def _entry(name, how, *, n_kernels=0, n_nodes=0, errors=(),
           in_place=None):
    in_place = in_place or {"expected": False, "n_leaves": 0,
                            "n_in_place": 0, "effective": True}
    sync_free = not errors
    return {"name": name, "how": how, "n_kernels": n_kernels,
            "n_nodes": n_nodes, "errors": list(errors),
            "sync_free": sync_free, "in_place": in_place,
            "ok": sync_free and in_place["effective"]}


def _in_place(before: List[int], leaves, wrote: bool) -> Dict:
    """The leaves an entry updates keep the storage they had before it
    (``before``: their data_ptrs), and the entry wrote them."""
    kept = sum(a == t.data_ptr() for a, t in zip(before, leaves))
    return {"expected": True, "n_leaves": len(before), "n_in_place": kept,
            "effective": kept == len(before) and bool(wrote)}


def _nodes_in_dump(graph):
    """(kernel nodes, all nodes) of a graph's debug dump: a node's line
    holds its label, which starts with its kind (KERNEL, a copy, a
    memset, ...)."""
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "graph.dot"
        graph.debug_dump(str(path))
        lines = path.read_text().splitlines()
    return (sum('label="{KERNEL' in ln for ln in lines),
            sum('label="{' in ln for ln in lines))


def _captured(name: str, warm: Callable, body: Callable, leaves: Callable):
    """``warm()`` on a side stream (the libraries' lazy set-up), then
    ``body()`` captured thread-locally into a dumpable graph; the graph's
    kernels off its dump; one replay, after which ``leaves()`` (the
    tensors the body updates) must have kept their storage and changed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = [t.data_ptr() for t in leaves()]
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    try:
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            body()
    except RuntimeError as e:
        return _entry(name, "captured", errors=[str(e).splitlines()[0]])
    n_kernels, n_nodes = _nodes_in_dump(graph)
    snap = [t.clone() for t in leaves()]
    graph.replay()
    torch.cuda.synchronize()
    wrote = any(not torch.equal(a, t) for a, t in zip(snap, leaves()))
    return _entry(name, "captured", n_kernels=n_kernels, n_nodes=n_nodes,
                  in_place=_in_place(before, leaves(), wrote))


# -- the entries ------------------------------------------------------------


def _fused_entry() -> Dict:
    import torch

    from repro_torch.core import controller as C
    from repro_torch.core.cutoff import order_stats
    from repro_torch.core.runtime_model.api import RuntimeModel

    n, lag, k = 8, 4, 16
    model = RuntimeModel(n_workers=n, lag=lag, device="cuda").init(0)
    st = C._state(n, lag + 1, k, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    st["ring"].copy_(1.0 + torch.rand(st["ring"].shape, generator=gen,
                                      device="cuda"))
    st["obs"][:n] = 1.0 + torch.rand(n, generator=gen, device="cuda")
    st["obs"][n:2 * n] = 1.0
    st["obs"][n + n // 2:2 * n] = 0.0          # half the workers censored
    st["mu"].fill_(1.0)
    st["std"].fill_(0.5)
    lo = order_stats.min_frac_floor(n, 0.5)

    def run(state):
        C._observe_decide_core(model.params, state, mode="censored",
                               decide=True, k_samples=k, lo=lo,
                               norm_scale=model.norm_scale)

    return _captured(
        "fused_observe_decide",
        lambda: run({key: v.clone() for key, v in st.items()}),
        lambda: run(st), lambda: list(st.values()))


def _ragged_entry() -> Dict:
    import torch

    from repro_torch.core.cutoff import order_stats
    from repro_torch.core.runtime_model.api import (RuntimeModel,
                                                    batched_layout,
                                                    stack_models_padded)
    from repro_torch.ps import server as PS

    widths, n_pad, lag, k = (4, 6, 8), 8, 4, 16
    J = len(widths)
    models = [RuntimeModel(n_workers=w, lag=lag, device="cuda").init(i)
              for i, w in enumerate(widths)]
    params, scales = stack_models_padded(models, n_pad)
    params = batched_layout(params)
    wt = torch.tensor(widths, device="cuda")
    los = torch.tensor([order_stats.min_frac_floor(w, 0.5) for w in widths],
                       device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    st = {"rings": 1.0 + torch.rand((J, lag + 1, n_pad), generator=gen,
                                    device="cuda"),
          "heads": torch.zeros((J,), dtype=torch.int64, device="cuda"),
          "inp": torch.zeros((4 * J * n_pad + 7 * J,), dtype=torch.float64,
                             device="cuda"),
          "out": torch.zeros((J, 2 + 2 * n_pad), device="cuda"),
          "samples": torch.zeros((J, k, n_pad), device="cuda")}
    pack, _, _, cen, serv = PS._split_inp(st["inp"], J, n_pad)
    pack[0].copy_(1.0 + torch.rand((J, n_pad), generator=gen,
                                   device="cuda"))
    pack[1].fill_(1.0)
    pack[1][:, :2] = 0.0                        # two censored a job
    pack[2].fill_(1.0)
    pack[3].fill_(0.5)
    cen.fill_(1.0)
    serv.fill_(1.0)

    def run(state):
        PS._full_observe_decide(params, state, scales, wt, los, k_samples=k)

    return _captured(
        "batched_observe_decide_ragged",
        lambda: run({key: v.clone() for key, v in st.items()}),
        lambda: run(st), lambda: list(st.values()))


def _train_entries() -> List[Dict]:
    import numpy as np
    import torch

    from repro_torch import optim, tree
    from repro_torch.configs.base import bench_tiny_config
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import model as M

    cfg = dataclasses.replace(bench_tiny_config(), head_dim=64)
    B, S, W = 8, 8, 4
    rng = np.random.default_rng(0)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                          device="cuda")
    pos = torch.arange(S, device="cuda").expand(B, S)
    out = []
    for mode in ("weights", "psum"):
        params = M.init_model(cfg, torch.Generator().manual_seed(0),
                              device="cuda")
        opt = optim.adamw(1e-3, fused=True)   # the in-place update
        state = {"params": params, "opt": opt.init(params)}
        step = make_train_step(cfg, opt, mask_agg=mode)
        batch = {"tokens": tok, "labels": tok, "positions": pos}
        if mode == "weights":
            batch["weights"] = torch.ones(B, device="cuda")
        else:
            batch["mask"] = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
        state, _ = step(state, batch)                 # warm-up
        torch.cuda.synchronize()

        def updated(s):
            return (tree.leaves(s["params"]) + tree.leaves(s["opt"]["m"])
                    + tree.leaves(s["opt"]["v"]))

        before = [t.data_ptr() for t in updated(state)]
        snap = [t.clone() for t in updated(state)]
        errors = []
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, _ = step(state, batch)
        except RuntimeError as e:
            errors.append(str(e).splitlines()[0])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wrote = any(not torch.equal(a, t)
                    for a, t in zip(snap, updated(state)))
        out.append(_entry(f"train_step[mask_agg={mode}]", "run",
                          errors=errors,
                          in_place=_in_place(before, updated(state), wrote)))
    return out


def _obs_entry() -> Dict:
    import torch

    from repro_torch.obs.metrics import MetricRing

    ring = MetricRing("audit", ("loss", "gnorm", "c", "iter_time"), cap=256)
    vals = tuple(torch.full((), float(i + 1), device="cuda")
                 for i in range(4))
    ring.push(vals)                 # allocates the device ring
    for v in vals:
        v.add_(1.0)
    return _captured("obs_ring_push", lambda: ring.push(vals),
                     lambda: ring.push(vals), lambda: [ring._ring])


def _decode_entry(arch: str) -> Dict:
    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(get_config(arch), n_layers=DECODE_DEPTH)
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda", dtype=torch.bfloat16)
    engine = ServeEngine(cfg, params, max_len=DECODE_LEN)
    S = DECODE_LEN - DECODE_NEW
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (DECODE_B, S), dtype=np.int32)
    name = f"decode_step[{arch}]"
    try:
        engine.generate(prompts, DECODE_NEW)        # the engine's capture
    except RuntimeError as e:
        return _entry(name, "captured", errors=[str(e).splitlines()[0]])
    g = engine.graphs[(DECODE_B, False)]
    st = g.state

    def leaves():
        return tree.leaves(st.caches) + [st.tok, st.pos, st.t, st.ids]

    with torch.inference_mode():
        snap = st.clone()
        snap.pos.fill_(S)
        snap.t.zero_()
        before = [t.data_ptr() for t in leaves()]
        st.pos.fill_(S)
        st.t.zero_()
        old = [t.clone() for t in leaves()]
        g.replay()
        torch.cuda.synchronize()
        wrote = any(not torch.equal(a, t) for a, t in zip(old, leaves()))
        # the same step captured into a dumpable graph for its kernels
        counted = _captured(name, snap.step, snap.step,
                            lambda: tree.leaves(snap.caches))
    return _entry(name, "captured", n_kernels=counted["n_kernels"],
                  n_nodes=counted["n_nodes"], errors=counted["errors"],
                  in_place=_in_place(before, leaves(), wrote))


def run_audit() -> Dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the capture audit runs on the card: no CUDA "
                           "device")
    entries = ([_fused_entry(), _ragged_entry()] + _train_entries()
               + [_obs_entry()] + [_decode_entry(a) for a in DECODE_ARCHS])
    return {"version": SCHEMA_VERSION,
            "torch_version": torch.__version__,
            "device": torch.cuda.get_device_name(0),
            "ok": all(e["ok"] for e in entries),
            "entries": entries}


def write_report(path: str = "ANALYSIS_torch.json") -> Dict:
    report = run_audit()
    with open(path, "w") as fh:
        json.dump(report, fh, indent=2)
        fh.write("\n")
    return report
