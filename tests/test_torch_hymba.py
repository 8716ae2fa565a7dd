"""Port Hymba (hybrid attention + Mamba heads) vs the JAX package on the CPU.

The reduced hymba-1.5b config (4 layers, d_model 64, 4 heads over 2 KV
heads, the Mamba heads' q/k ``ssm_state`` = 8 wide and v 32 wide, sliding
window 8 with layers 0 and 2 global), so the JAX tree is one segment of a
global and a windowed layer repeated twice and ``weights.from_jax``
unstacks it.  JAX params get random norm scales, biases and Mamba
constants (JAX inits them 1 / 0 / -2 / 0 / 1) and are carried across;
inputs are numpy, seeded.  Sequences of 16 tokens, so the window of 8
binds.  Blocks, the Mamba sublayer, logits and decode steps agree at atol
1e-4 in f32, as tests/test_torch_model.py holds the dense family; the
greedy ids of the serving engines are equal.  Training is
tests/test_torch_hymba_train.py's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models import blocks as JB
from repro.models import model as JM
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import tree, weights
from repro_torch.configs.base import get_config as tget
from repro_torch.kernels import ops
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.serving.engine import ServeEngine

torch.set_num_threads(2)

ATOL = 1e-4
B, S, N_DECODE = 2, 16, 4
SMALL_LEAVES = {"scale", "bias", "conv_b", "dt_bias", "a_log", "d_skip"}


def _configs():
    return jget("hymba-1.5b").reduced(), tget("hymba-1.5b").reduced()


def _perturb(params, seed):
    """Random values for every norm scale, bias and Mamba constant."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key in SMALL_LEAVES:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(f, params)


def _setup():
    jc, tc = _configs()
    pnp = _perturb(JM.init_model(jc, jax.random.PRNGKey(0)), 1)
    jp = jax.tree.map(jnp.asarray, pnp)
    tp = weights.from_jax(tc, pnp, device="cpu")
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (B, S),
                                             dtype=np.int32)
    return jc, tc, jp, tp, toks


def _positions(n, start=0):
    return np.broadcast_to(np.arange(start, start + n)[None], (B, n))


def _assert_trees(got, want):
    got, want = tree.leaves(got), [np.asarray(a) for a in
                                   jax.tree.leaves(want)]
    assert [tuple(a.shape) for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=ATOL)


def test_layer_specs_and_segments_match_jax():
    jc, tc = _configs()
    specs = TM.layer_specs(tc)
    assert [(s.kind, s.window) for s in specs] == [
        (s.kind, s.window) for s in JM.layer_specs(jc)]
    assert [s.window for s in specs] == [0, 8, 0, 8]
    (seg,) = TM.build_segments(specs)
    assert seg.repeats == 2 and [s.window for s in seg.pattern] == [0, 8]


def test_from_jax_carries_the_hymba_tree():
    """Every leaf of every layer, value for value: 20 a layer (attention
    4, norms 2, MLP 3, Mamba 9, branch norms 2), plus embed, final norm
    and the untied head."""
    jc, tc = _configs()
    pnp = jax.tree.map(np.asarray, JM.init_model(jc, jax.random.PRNGKey(3)))
    tp = weights.from_jax(tc, pnp, device="cpu")
    assert len(tp["layers"]) == 4 and "lm_head" in tp
    for li, layer in enumerate(tp["layers"]):
        r, pi = divmod(li, 2)
        src = jax.tree.leaves(pnp["segments"][0][pi])
        got = tree.leaves(layer)
        assert len(got) == len(src) == 20
        for a, b in zip(got, src):
            np.testing.assert_array_equal(a.numpy(), b[r])
    assert sorted(tp["layers"][0]["mamba"]) == sorted(
        pnp["segments"][0][0]["mamba"])
    assert len(tree.leaves(tp)) == 4 * 20 + 3


def test_init_model_shapes_and_constants_match_jax():
    jc, tc = _configs()
    jp = jax.eval_shape(lambda k: JM.init_model(jc, k), jax.random.PRNGKey(0))
    (sp,) = jp["segments"]
    want = [[(tuple(x.shape[1:]), x.dtype.name)
             for x in jax.tree.leaves(sp[li % 2])] for li in range(4)]
    a = TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    got = [[(tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for x in tree.leaves(layer)] for layer in a["layers"]]
    assert got == want
    m = a["layers"][1]["mamba"]
    nh = tc.n_heads
    assert torch.equal(m["dt_bias"], torch.full((nh,), -2.0))
    assert torch.equal(m["a_log"], torch.zeros(nh))
    assert torch.equal(m["d_skip"], torch.ones(nh))
    assert torch.equal(m["conv_b"], torch.zeros_like(m["conv_b"]))
    assert abs(float(m["conv_w"].std()) / 0.2 - 1.0) < 0.1
    assert abs(float(m["w_bc"].std()) * (2 * tc.d_model) ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mamba_apply_matches_jax(mode):
    """The Mamba sublayer alone: y and the cache (the recurrence state and
    the conv's 3-position tail), decode from the cache a prefill left."""
    jc, tc, jp, tp, _ = _setup()
    jparams = jax.tree.map(lambda a: a[1], jp["segments"][0][1]["mamba"])
    tparams = tp["layers"][3]["mamba"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    jcache = tcache = None
    if mode == "decode":
        _, jcache = JB.mamba_apply(
            jc, jparams, jnp.asarray(x),
            JB.Ctx(mode="prefill", positions=jnp.asarray(_positions(S))),
            None)
        _, tcache = TB.mamba_apply(
            tc, tparams, torch.from_numpy(x),
            TB.Ctx(mode="prefill", positions=torch.from_numpy(
                _positions(S).copy())), None)
        x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    pos = _positions(1, S) if mode == "decode" else _positions(S)
    jy, jnew = JB.mamba_apply(
        jc, jparams, jnp.asarray(x),
        JB.Ctx(mode=mode, positions=jnp.asarray(pos), pos=jnp.int32(S)),
        jcache)
    ty, tnew = TB.mamba_apply(
        tc, tparams, torch.from_numpy(x),
        TB.Ctx(mode=mode, positions=torch.from_numpy(pos.copy()), pos=S),
        tcache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    if mode == "train":
        assert tnew is None and jnew is None
        return
    assert sorted(tnew) == ["conv", "state"]
    assert tnew["conv"].shape == (B, jc.ssm_conv_width - 1,
                                  jc.ssm_expand * jc.d_model)
    _assert_trees(tnew, jnew)


def test_mamba_heads_reach_the_recurrence_as_a_broadcast(monkeypatch):
    """The prefill hands ops.mlstm q/k as views with head stride 0 (the
    kernel reads one row for every head), v as (B, S, H, dv), f32 gates,
    and the unnormalized form at scale 1."""
    _, tc, _, tp, _ = _setup()
    seen = []
    inner = ops.mlstm

    def spy(q, k, v, g, i, **kw):
        seen.append((q, k, v, g, i, kw))
        return inner(q, k, v, g, i, **kw)

    monkeypatch.setattr(ops, "mlstm", spy)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, S, tc.d_model)).astype(np.float32))
    TB.mamba_apply(tc, tp["layers"][0]["mamba"], x,
                   TB.Ctx(mode="prefill", positions=torch.from_numpy(
                       _positions(S).copy())), None)
    ((q, k, v, g, i, kw),) = seen
    H, n = tc.n_heads, tc.ssm_state
    assert q.shape == k.shape == (B, S, H, n)
    assert q.stride(2) == k.stride(2) == 0
    assert v.shape == (B, S, H, tc.ssm_expand * tc.d_model // H)
    assert g.dtype == i.dtype == torch.float32
    assert kw == {"normalize": False, "scale": 1.0}


@pytest.mark.parametrize("li", [0, 1])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_hybrid_block_matches_jax(mode, li):
    """The hybrid block, global (layer 0) and windowed (layer 1, window 8
    over 16 positions), in each mode; its cache {"attn", "mamba"}."""
    jc, tc, jp, tp, _ = _setup()
    jparams = jax.tree.map(lambda a: a[0], jp["segments"][0][li])
    tparams = tp["layers"][li]
    window = (0, 8)[li]
    jspec = JB.LayerSpec(kind="hybrid", window=window)
    tspec = TB.LayerSpec(kind="hybrid", window=window)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    jcache = tcache = None
    if mode == "decode":   # the cache a prefill of x leaves, grown by one
        _, jcache, _ = JB.apply_block(
            jc, jspec, jparams, jnp.asarray(x),
            JB.Ctx(mode="prefill", positions=jnp.asarray(_positions(S))),
            None)
        _, tcache = TB.apply_block(
            tc, tspec, tparams, torch.from_numpy(x),
            TB.Ctx(mode="prefill", positions=torch.from_numpy(
                _positions(S).copy())), None)
        jcache = JM.pad_caches([jcache], S + 1)[0]
        tcache = TM.pad_caches([tcache], S + 1)[0]
        x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    pos = _positions(1, S) if mode == "decode" else _positions(S)
    jy, jnew, jaux = JB.apply_block(
        jc, jspec, jparams, jnp.asarray(x),
        JB.Ctx(mode=mode, positions=jnp.asarray(pos), pos=jnp.int32(S)),
        jcache)
    ty, tnew, taux = TB.block_forward(
        tc, tspec, tparams, torch.from_numpy(x),
        TB.Ctx(mode=mode, positions=torch.from_numpy(pos.copy()), pos=S),
        tcache)
    assert taux is None and float(jaux) == 0.0
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    if mode == "train":
        assert tnew is None and jnew is None
        return
    assert sorted(tnew) == ["attn", "mamba"]
    _assert_trees(tnew, jnew)


def test_forward_logits_match_jax():
    """Train-mode logits at seq 16 (the window of 8 binds in layers 1 and
    3), aux 0, and gradients that reach both branches."""
    jc, tc, jp, tp, toks = _setup()
    pos = _positions(S)
    jl, _, jaux = jax.jit(lambda p, b: JM.forward(jc, p, b, mode="train"))(
        jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
    for leaf in tree.leaves(tp):
        leaf.requires_grad_(True)
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64),
             "positions": torch.arange(S).expand(B, S)}
    tl, caches, aux = TM.forward(tc, tp, batch, mode="train")
    assert caches is None and float(aux) == 0.0 == float(jaux)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=ATOL)
    labels = torch.as_tensor(np.roll(toks, -1, axis=1), dtype=torch.int64)
    TM.cross_entropy(tl, labels).backward()
    for leaf in (tp["layers"][1]["attn"]["wq"],
                 tp["layers"][1]["mamba"]["w_bc"],
                 tp["layers"][1]["mamba"]["a_log"]):
        assert torch.isfinite(leaf.grad).all()
        assert float(leaf.grad.abs().max()) > 0.0


def test_prefill_and_decode_match_jax():
    """Prefill logits and caches, then 4 greedy decode steps (positions
    16..19: the windowed layers' keys slide) with their caches."""
    jc, tc, jp, tp, toks = _setup()
    pos = _positions(S)
    jl, jcache = jax.jit(lambda p, b: JM.prefill(jc, p, b))(
        jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
    tl, tcache = TM.prefill(tc, tp, {
        "tokens": torch.as_tensor(toks, dtype=torch.int64),
        "positions": torch.arange(S).expand(B, S)})
    assert tl.shape == (B, tc.vocab_size) and len(tcache) == 4
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    L = S + N_DECODE
    jcache, tcache = JM.pad_caches(jcache, L), TM.pad_caches(tcache, L)
    jdec = jax.jit(lambda p, t, q, c: JM.decode_step(jc, p, t, q, c))
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    for t in range(N_DECODE):
        jl, jcache = jdec(jp, jnp.asarray(tok), jnp.int32(S + t), jcache)
        tl, tcache = TM.decode_step(tc, tp, torch.as_tensor(
            tok, dtype=torch.int64), S + t, tcache)
        assert tl.shape == (B, 1, tc.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        tok = np.argmax(np.asarray(jl)[:, 0], axis=-1).astype(np.int32)
        tok = tok[:, None]
    for li, c in enumerate(tcache):
        r, pi = divmod(li, 2)
        want = jax.tree.map(lambda a: a[r], jcache[0][pi])
        _assert_trees(c, want)


def test_serve_engine_ids_equal_jax():
    """Greedy ids of the port's ServeEngine equal the reference engine's,
    a 12-token prompt decoding 8 more (past the window of 8)."""
    jc, tc = _configs()
    params = JM.init_model(jc, jax.random.PRNGKey(4))
    tp = weights.from_jax(tc, jax.tree.map(np.asarray, params),
                          device="cpu")
    prompts = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 12),
                                                dtype=np.int32)
    want = JaxEngine(jc, params).generate(prompts, n_new=8)
    got = ServeEngine(tc, tp, device="cpu").generate(prompts, n_new=8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
