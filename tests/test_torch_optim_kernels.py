"""Port vs JAX package on the CPU: the numpy copies, the masked-mean and
fused-Adam plain versions and tree ops, and the optimizers.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances are those ``tests/test_kernels.py`` holds the Pallas kernels to
(masked mean 1e-5 f32 / 1e-2 bf16; Adam m 1e-5, v 1e-6, p 1e-5 f32 /
2e-3 bf16), or stated beside the assertion.  Where the JAX function reaches
a Pallas kernel it runs in interpret mode, as the JAX tests run it.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.cluster import simulator as jsim
from repro.cluster import trace as jtrace
from repro.core import aggregation as jagg
from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_adam import fused_adam as pallas_adam
from repro.kernels.masked_grad_agg import masked_grad_agg as pallas_agg
from repro_torch import optim as toptim
from repro_torch import tree
from repro_torch.cluster import simulator as tsim
from repro_torch.cluster import trace as ttrace
from repro_torch.core import aggregation as tagg
from repro_torch.data import pipeline as tpipe
from repro_torch.dist import collectives as tcoll
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import build
from repro_torch.kernels.fused_adam import CHUNK, fused_adam_, leaf_records
from repro_torch.kernels.masked_grad_agg import MAX_WORKERS, masked_grad_agg

torch.set_num_threads(2)


def _t(x, dtype=torch.float32):
    """A torch copy (the port updates some tensors in place)."""
    return torch.tensor(np.asarray(x, np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32)).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# (a) The numpy-only copies give the same numbers under equal seeds.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(n_workers=8, n_nodes=2, seed=5),
                                dict(n_workers=8, n_nodes=2, seed=7),
                                dict(n_workers=13, n_nodes=4, seed=1,
                                     spike_prob=0.2)])
def test_cluster_sim_runs_equal(kw):
    a, b = jsim.ClusterSim(**kw), tsim.ClusterSim(**kw)
    np.testing.assert_array_equal(a.run(120), b.run(120))
    assert a.regime_name == b.regime_name


@pytest.mark.parametrize("preset,args", [
    ("paper_cluster_158", dict(seed=3)),
    ("paper_cluster_158", dict(seed=0, n_workers=8)),
    ("tpu_pod_hosts", dict(seed=2)),
    ("tpu_pod_hosts", dict(n_hosts=8, seed=9))])
def test_presets_equal(preset, args):
    a = getattr(jsim, preset)(**args).run(60)
    b = getattr(tsim, preset)(**args).run(60)
    np.testing.assert_array_equal(a, b)


def test_microbatch_progress_equal():
    times = jsim.ClusterSim(n_workers=9, seed=4).run(5)
    for row in times:
        for n_micro in (1, 2, 4, 8):
            t = float(np.median(row))
            np.testing.assert_array_equal(
                jsim.microbatch_progress(row, t, n_micro),
                tsim.microbatch_progress(row, t, n_micro))
    with pytest.raises(ValueError):
        tsim.microbatch_progress(times[0], 1.0, 0)


def test_trace_replay_equal():
    segs = [np.arange(12.0).reshape(3, 4), np.arange(10.0).reshape(2, 5)]
    for loop in (True, False):
        a, b = jtrace.TraceReplay(segs, loop), ttrace.TraceReplay(segs, loop)
        for _ in range(5):
            assert a.n_workers == b.n_workers
            np.testing.assert_array_equal(a.step(), b.step())
    with pytest.raises(IndexError):
        b.step()


@pytest.mark.parametrize("kw", [dict(vocab_size=256, seq_len=16,
                                     global_batch=8, seed=0),
                                dict(vocab_size=151936, seq_len=32,
                                     global_batch=4, seed=3)])
def test_synthetic_tokens_equal(kw):
    a, b = jpipe.SyntheticTokens(**kw), tpipe.SyntheticTokens(**kw)
    for step in (0, 5):
        for worker, n in ((None, 1), (1, 2), (3, 4)):
            ba, bb = a.batch(step, worker, n), b.batch(step, worker, n)
            assert ba.keys() == bb.keys()
            for k in ba:
                assert ba[k].dtype == bb[k].dtype
                np.testing.assert_array_equal(ba[k], bb[k])
    with pytest.raises(ValueError):
        b.batch(0, 0, 3)


# ---------------------------------------------------------------------------
# (b) The plain versions against the JAX oracles and the Pallas kernels.
# ---------------------------------------------------------------------------


def _agg_inputs(w, n, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((w, n)).astype(np.float32)
    mask = (np.arange(w) % 3 != 0).astype(np.float32)
    return g, mask


@pytest.mark.parametrize("w", [2, 8, 158])
def test_reference_masked_agg_worker_counts(w):
    g, mask = _agg_inputs(w, 256, w)
    got = tref.reference_masked_agg(_t(g), _t(mask).reshape(w, 1))
    want = jref.reference_masked_agg(_j(g), _j(mask).reshape(w, 1))
    kern = pallas_agg(_j(g), _j(mask).reshape(w, 1), interpret=True)
    assert got.shape == (1, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), kern, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(masked_grad_agg(_t(g), _t(mask)).numpy(),
                               want[0], atol=1e-6, rtol=1e-6)


def test_reference_masked_agg_fractional_and_zero():
    rng = np.random.default_rng(4)
    g = rng.standard_normal((8, 384)).astype(np.float32)
    frac = rng.uniform(size=8).astype(np.float32)
    for mask in (frac, np.zeros(8, np.float32)):
        got = masked_grad_agg(_t(g), _t(mask))
        kern = pallas_agg(_j(g), _j(mask).reshape(8, 1), interpret=True)
        np.testing.assert_allclose(got.numpy(), kern[0], atol=1e-5,
                                   rtol=1e-5)
    assert np.all(got.numpy() == 0.0)   # c = max(0, 1): exact zeros


def test_reference_masked_agg_bf16():
    g, _ = _agg_inputs(8, 384, 1)
    mask = np.asarray([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
    got = masked_grad_agg(_t(g, torch.bfloat16), _t(mask))
    kern = pallas_agg(_j(g, jnp.bfloat16), _j(mask).reshape(8, 1),
                      interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(kern)[0], atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("shape", [(8, 128), (16, 256)])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("step", [1, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_adam_matches_jax_and_pallas(shape, wd, step, dtype):
    rng = np.random.default_rng(hash((shape, wd, step)) % 2**31)
    p, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    m = rng.standard_normal(shape).astype(np.float32) * 0.1
    v = np.abs(rng.standard_normal(shape).astype(np.float32)) * 0.01
    scal = tops.adam_scalars(step - 1, 1e-3, 0.9, 0.999)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tref.reference_adam(_t(p, tdt), _t(g, tdt), _t(m), _t(v), scal,
                              wd=wd)
    jsc = jnp.array([1e-3, 1 - 0.9 ** step, 1 - 0.999 ** step], jnp.float32)
    jin = (_j(p, jdt), _j(g, jdt), _j(m), _j(v), jsc)
    for want in (jref.reference_adam(*jin, wd=wd),
                 pallas_adam(*jin, wd=wd, interpret=True)):
        assert got[0].dtype == tdt
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-6,
                                   rtol=1e-5)
        np.testing.assert_allclose(_np(got[0]), _np(want[0]),
                                   atol=2e-3 if dtype == "bfloat16" else 1e-5)


def test_adam_scalars_match_jax():
    """The host f32 bias corrections equal the JAX op's device ones."""
    for step in (0, 1, 9, 99, 999):
        t = jnp.float32(step) + 1.0
        want = np.asarray([1e-3, 1.0 - 0.9 ** t, 1.0 - 0.999 ** t],
                          np.float32)
        got = np.asarray(tops.adam_scalars(step, 1e-3, 0.9, 0.999),
                         np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# (c) Tree ops on a ragged tree against the JAX ops in interpret mode.
# ---------------------------------------------------------------------------


RAGGED = {"w": ((37, 5), np.float32), "b": ((13,), np.float32),
          "s": ((1,), np.float32), "h": ((3, 7), "bfloat16")}


def _ragged(seed, lead=()):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(lead + s).astype(np.float32)
            for k, (s, _) in RAGGED.items()}


def _to_t(tr):
    return {k: _t(v, torch.bfloat16 if RAGGED[k][1] == "bfloat16"
                  else torch.float32) for k, v in tr.items()}


def _to_j(tr):
    return {k: _j(v, jnp.bfloat16 if RAGGED[k][1] == "bfloat16"
                  else jnp.float32) for k, v in tr.items()}


@pytest.mark.parametrize("mask", [[1, 0, 1, 1, 0, 1], [0.5, 1, 0, 0.25, 1,
                                                       0.75]])
def test_masked_aggregate_tree_matches_jax_kernel_path(mask, monkeypatch):
    monkeypatch.setattr(jops, "KERNEL_BACKEND", "interpret")
    grads = _ragged(0, lead=(6,))
    mask = np.asarray(mask, np.float32)
    got = tops.masked_aggregate_tree(_to_t(grads), _t(mask))
    want = jops.masked_aggregate_tree(_to_j(grads), _j(mask))
    via = tcoll.masked_grad_mean(_to_t(grads), _t(mask))
    local = tagg.masked_mean_local(_to_t(grads), _t(mask))
    jlocal = jagg.masked_mean_local(_to_j(grads), _j(mask))
    for k in RAGGED:
        tol = 1e-2 if RAGGED[k][1] == "bfloat16" else 1e-5
        assert got[k].dtype == (torch.bfloat16 if RAGGED[k][1] == "bfloat16"
                                else torch.float32)
        assert tuple(got[k].shape) == RAGGED[k][0]
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=tol,
                                   rtol=tol)
        np.testing.assert_array_equal(_np(via[k]), _np(got[k]))
        np.testing.assert_allclose(_np(local[k]), _np(jlocal[k]), atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(_np(got[k]), _np(local[k]), atol=tol,
                                   rtol=tol)


def test_worker_grads_buffer_rows_and_grad_mean():
    """Rows written through the per-leaf views are what the combine sees;
    grad_mean is the all-ones mask."""
    like = _to_t(_ragged(1))
    buf = tops.WorkerGrads(like, 3)
    stacked = _ragged(2, lead=(3,))
    for w in range(3):
        for view, k in zip(buf.rows[w], sorted(RAGGED)):
            view.copy_(_t(stacked[k][w]))
    got = tcoll.masked_grad_mean(buf, _t([1, 0, 1]))
    whole = tcoll.grad_mean(_to_t(stacked))
    for k in RAGGED:
        want = (stacked[k][0] + stacked[k][2]) / 2
        tol = 1e-2 if RAGGED[k][1] == "bfloat16" else 1e-6
        np.testing.assert_allclose(_np(got[k]), want, atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(whole[k]), stacked[k].mean(0),
                                   atol=tol, rtol=tol)
    with pytest.raises(NotImplementedError):
        tcoll.masked_grad_mean(buf, _t([1, 1, 1]), lay=object())


@pytest.mark.parametrize("n", [1, 100, 333, 1000])
def test_masked_aggregate_any_n(n):
    g = np.random.default_rng(n).standard_normal((4, n)).astype(np.float32)
    mask = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    got = tops.masked_aggregate(_t(g), mask)
    np.testing.assert_allclose(got.numpy(), g[[0, 2, 3]].mean(0), atol=1e-6)


@pytest.mark.parametrize("step", [0, 7])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_update_tree_matches_jax_kernel_path(step, wd, monkeypatch):
    monkeypatch.setattr(jops, "KERNEL_BACKEND", "interpret")
    p, g = _ragged(3), _ragged(4)
    m = {k: 0.1 * v for k, v in _ragged(5).items()}
    v = {k: 0.01 * np.abs(x) for k, x in _ragged(6).items()}
    tp, tm, tv = _to_t(p), {k: _t(x) for k, x in m.items()}, \
        {k: _t(x) for k, x in v.items()}
    out = tops.adam_update_tree(tp, _to_t(g), tm, tv, step, 1e-3, wd=wd)
    assert out[0] is tp and out[1] is tm   # in place
    wp, wm, wv = jops.adam_update_tree(
        _to_j(p), _to_j(g), {k: _j(x) for k, x in m.items()},
        {k: _j(x) for k, x in v.items()}, jnp.int32(step), 1e-3, wd=wd)
    for k in RAGGED:
        bf = RAGGED[k][1] == "bfloat16"
        np.testing.assert_allclose(tm[k].numpy(), _np(wm[k]), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(tv[k].numpy(), _np(wv[k]), atol=1e-6,
                                   rtol=1e-5)
        np.testing.assert_allclose(_np(tp[k]), _np(wp[k]),
                                   atol=2e-3 if bf else 1e-5)


def test_cpu_paths_launch_no_kernel():
    build.LAUNCHES.clear()
    masked_grad_agg(torch.ones(3, 5), torch.ones(3))
    p = [torch.ones(4)]
    fused_adam_(p, [torch.ones(4)], [torch.zeros(4)], [torch.zeros(4)],
                (1e-3, 0.1, 0.001))
    assert not build.LAUNCHES


def test_fused_adam_leaf_records():
    """The kernel's leaf table: empty leaves dropped, first chunks as the
    prefix sum of ceil(n / CHUNK), dtype and alignment flags."""
    sizes = [CHUNK + 1, 0, 7, 3 * CHUNK]
    ps = [torch.zeros(n, dtype=torch.bfloat16 if i == 2 else torch.float32)
          for i, n in enumerate(sizes)]
    gs = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes]
    ms = [torch.zeros(n) for n in sizes]
    vs = [torch.zeros(n + 1)[1:] for n in sizes]   # 4-byte offset views
    rec, n_chunks = leaf_records(ps, gs, ms, vs)
    assert rec.dtype.itemsize == 56 and len(rec) == 3
    np.testing.assert_array_equal(rec["n"], [CHUNK + 1, 7, 3 * CHUNK])
    np.testing.assert_array_equal(rec["chunk0"], [0, 2, 3])
    assert n_chunks == 6
    assert rec["p"][1] == ps[2].data_ptr() and rec["v"][2] == vs[3].data_ptr()
    np.testing.assert_array_equal(rec["flags"] & 3, [2, 3, 2])
    assert not (rec["flags"] & 4).any()   # v is off 16-byte alignment
    vs = [torch.zeros(n) for n in sizes]
    rec, _ = leaf_records(ps, gs, ms, vs)
    assert (rec["flags"] & 4).all()
    with pytest.raises(ValueError, match="contiguous"):
        leaf_records([torch.zeros(4, 4).T], [torch.zeros(4, 4)],
                     [torch.zeros(4, 4)], [torch.zeros(4, 4)])


def test_masked_grad_agg_worker_limit():
    """The wrapper's worker limit is the kernel's: W mask values and c fill
    at most the 48 KB of shared memory a block has by default.  At the
    limit the CPU path still gives the masked mean."""
    src = (Path(tref.__file__).parent / "csrc" / "masked_grad_agg.cu"
           ).read_text()
    assert int(re.search(r"MAX_WORKERS = (\d+);", src).group(1)) \
        == MAX_WORKERS
    assert (MAX_WORKERS + 1) * 4 <= 48 * 1024 < (MAX_WORKERS + 2) * 4
    rng = np.random.default_rng(11)
    g = rng.standard_normal((MAX_WORKERS, 3)).astype(np.float32)
    m = (rng.random(MAX_WORKERS) < 0.5).astype(np.float32)
    out = masked_grad_agg(torch.tensor(g), torch.tensor(m))
    np.testing.assert_allclose(out.numpy(), m @ g / max(m.sum(), 1.0),
                               atol=1e-5, rtol=1e-5)


def test_wrappers_refuse_other_devices():
    """Only the CPU (plain) and CUDA (kernel) paths exist."""
    g = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="no path"):
        masked_grad_agg(g, torch.ones(2, device="meta"))
    p = [torch.zeros(4, device="meta")]
    with pytest.raises(ValueError, match="no path"):
        fused_adam_(p, p, p, p, (1e-3, 0.1, 0.001))
    with pytest.raises(ValueError):
        masked_grad_agg(torch.zeros(2, 8), torch.ones(3))
    with pytest.raises(ValueError):
        fused_adam_([torch.zeros(4)], [torch.zeros(4)],
                    [torch.zeros(4, dtype=torch.bfloat16)], [torch.zeros(4)],
                    (1e-3, 0.1, 0.001))


# ---------------------------------------------------------------------------
# (d) Optimizers and schedules against the JAX package.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-3,)), ("linear_warmup", (3e-3, 4)),
    ("cosine_schedule", (3e-4, 2, 20)), ("cosine_schedule", (1e-3, 5, 50,
                                                             0.2))])
def test_schedules_match_jax(name, args):
    js, ts = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for step in range(0, 60, 3):
        want = float(js(jnp.int32(step)))
        got = ts(step)
        assert isinstance(got, np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((37, 5)).astype(np.float32),
            "b": rng.standard_normal((13,)).astype(np.float32),
            "layers": [{"s": rng.standard_normal((1,)).astype(np.float32)},
                       {"s": rng.standard_normal((2,)).astype(np.float32)}]}


def _tt(x):
    if isinstance(x, dict):
        return {k: _tt(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tt(v) for v in x]
    return _t(x)


def _run_opt(opt, params, grads_seq, apply, state=None):
    state = opt.init(params) if state is None else state
    for g in grads_seq:
        ups, state = opt.update(g, state, params)
        params = apply(params, ups)
    return params, state


def _tleaves(t):
    return [x.numpy() for x in tree.leaves(t)]


def _jleaves(t):
    return [np.asarray(x) for x in jax.tree.leaves(t)]


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_fused_unfused_and_jax_agree(wd):
    """Three steps under a schedule: the port's fused (in place, p' direct)
    and unfused paths and the JAX unfused path.  p may differ by one
    rounding of the update between p' and p + (p' - p): atol 1e-6."""
    sched = (3e-3, 1, 10)
    p0 = _opt_tree(0)
    grads = [jax.tree.map(lambda x: 0.1 * x, _opt_tree(10 + i))
             for i in range(3)]
    jp, js = _run_opt(joptim.adamw(joptim.cosine_schedule(*sched),
                                   weight_decay=wd),
                      jax.tree.map(jnp.asarray, p0),
                      [jax.tree.map(jnp.asarray, g) for g in grads],
                      joptim.apply_updates)
    outs = {}
    for fused in (False, True):
        opt = toptim.adamw(toptim.cosine_schedule(*sched), weight_decay=wd,
                           fused=fused)
        params = _tt(p0)
        tp, ts = _run_opt(opt, params, [_tt(g) for g in grads],
                          toptim.apply_updates)
        assert ts["step"] == 3 and int(js["step"]) == 3
        if fused:
            assert tp is params   # updated in place
        outs[fused] = (tp, ts)
    for fused, (tp, ts) in outs.items():
        for a, b in zip(_tleaves(tp), _jleaves(jp)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
        for key, atol in (("m", 1e-6), ("v", 1e-7)):
            for a, b in zip(_tleaves(ts[key]), _jleaves(js[key])):
                np.testing.assert_allclose(a, b, atol=atol)
    for a, b in zip(_tleaves(outs[True][0]), _tleaves(outs[False][0])):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("which", ["sgd", "momentum", "nesterov", "clip",
                                   "chain"])
def test_other_optimizers_match_jax(which):
    def build(mod):
        sched = mod.linear_warmup(1e-2, 2)
        if which == "sgd":
            return mod.sgd(sched)
        if which in ("momentum", "nesterov"):
            return mod.momentum(sched, 0.9, nesterov=which == "nesterov")
        if which == "clip":
            return mod.clip_by_global_norm(mod.adam(1e-3), 0.5)
        scale = (lambda g: jax.tree.map(lambda x: 2.0 * x, g)) \
            if mod is joptim else (lambda g: tree.map(lambda x: 2.0 * x, g))
        return mod.chain(scale, mod.sgd(1e-2))

    p0 = _opt_tree(1)
    grads = [_opt_tree(20 + i) for i in range(3)]
    jp, _ = _run_opt(build(joptim), jax.tree.map(jnp.asarray, p0),
                     [jax.tree.map(jnp.asarray, g) for g in grads],
                     joptim.apply_updates)
    tp, _ = _run_opt(build(toptim), _tt(p0), [_tt(g) for g in grads],
                     toptim.apply_updates)
    for a, b in zip(_tleaves(tp), _jleaves(jp)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    gn_t = toptim.global_norm(_tt(grads[0]))
    gn_j = joptim.global_norm(jax.tree.map(jnp.asarray, grads[0]))
    np.testing.assert_allclose(gn_t.item(), float(gn_j), rtol=1e-6)


def test_fused_adam_needs_params():
    opt = toptim.adam(1e-3, fused=True)
    params = {"w": torch.ones(3)}
    with pytest.raises(ValueError):
        opt.update({"w": torch.ones(3)}, opt.init(params), None)


def test_fused_adam_keeps_one_leaf_table():
    """Only the fused Adam carries a leaf table, through clip and chain;
    the CPU path never uploads one."""
    assert toptim.adam(1e-3).table is None
    opt = toptim.chain(lambda g: g, toptim.clip_by_global_norm(
        toptim.adamw(1e-3, fused=True), 1.0))
    assert opt.table is not None
    params = {"w": torch.ones(3)}
    state = opt.init(params)
    for _ in range(2):
        _, state = opt.update({"w": torch.ones(3)}, state, params)
    assert state["step"] == 2 and opt.table.uploads == 0
