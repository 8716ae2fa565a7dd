"""Port xLSTM model vs ``repro.models`` on the CPU, at reduced width.

The reduced xlstm-350m config (3 mLSTM + 1 sLSTM blocks, d_model 64,
mLSTM head dim 32) and the same pattern twice over (8 layers, so the JAX
segment repeats and ``weights.from_jax`` unstacks it).  JAX params get
random biases and norm scales and are carried across with
``weights.from_jax``.  Blocks, prefill logits and 4 decode steps agree at
atol 1e-4 in f32, as tests/test_torch_model.py holds the dense family.
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
from repro_torch import tree, weights
from repro_torch.configs.base import get_config as tget
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM

torch.set_num_threads(2)

ATOL = 1e-4
B, S, N_DECODE = 2, 10, 4
SMALL_LEAVES = {"b_gates", "conv_b", "bias", "scale"}


def _configs(n_layers):
    jc, tc = jget("xlstm-350m").reduced(), tget("xlstm-350m").reduced()
    return (dataclasses.replace(jc, n_layers=n_layers),
            dataclasses.replace(tc, n_layers=n_layers))


def _perturb(params, seed):
    """Random values for every bias and norm scale (JAX inits them 0 / 1,
    the gate biases 0 / 3)."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key in SMALL_LEAVES:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(f, params)


def _setup(n_layers):
    jc, tc = _configs(n_layers)
    pnp = _perturb(JM.init_model(jc, jax.random.PRNGKey(0)), 1)
    jp = jax.tree.map(jnp.asarray, pnp)
    tp = weights.from_jax(tc, pnp, device="cpu")
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (B, S),
                                             dtype=np.int32)
    return jc, tc, jp, tp, toks


def _layer_caches(cfg, caches):
    """JAX caches (stacked per segment) -> per-layer numpy leaves, in
    ``tree.leaves`` order (sorted keys; ScanState fields in order)."""
    out = []
    for seg, sc in zip(TM.build_segments(TM.layer_specs(cfg)), caches):
        for r in range(seg.repeats):
            for c in sc:
                leaves = [np.asarray(x) for x in jax.tree.leaves(c)]
                out.append([x[r] for x in leaves] if seg.repeats > 1
                           else leaves)
    return out


def _assert_caches(tcache, jc, jcache):
    for c, want in zip(tcache, _layer_caches(jc, jcache)):
        got = tree.leaves(c)
        assert [tuple(x.shape) for x in got] == [x.shape for x in want]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("n_layers", [4, 8])
def test_prefill_and_decode_match_jax(n_layers):
    jc, tc, jp, tp, toks = _setup(n_layers)
    pos_np = np.broadcast_to(np.arange(S)[None], (B, S))
    jl, jcache = jax.jit(lambda p, b: JM.prefill(jc, p, b))(
        jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos_np)})
    tl, tcache = TM.prefill(tc, tp, {
        "tokens": torch.as_tensor(toks, dtype=torch.int64),
        "positions": torch.arange(S).expand(B, S)})
    assert tl.shape == (B, tc.vocab_size) and len(tcache) == n_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_caches(tcache, jc, jcache)

    L = S + N_DECODE
    jcache = JM.pad_caches(jcache, L)
    tcache = TM.pad_caches(tcache, L)
    _assert_caches(tcache, jc, jcache)   # SSM state is left as it was
    jdec = jax.jit(lambda p, t, pos, c: JM.decode_step(jc, p, t, pos, c))
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    for t in range(N_DECODE):
        jl, jcache = jdec(jp, jnp.asarray(tok), jnp.int32(S + t), jcache)
        tl, tcache = TM.decode_step(tc, tp,
                                    torch.as_tensor(tok, dtype=torch.int64),
                                    S + t, tcache)
        assert tl.shape == (B, 1, tc.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        tok = np.argmax(np.asarray(jl)[:, 0], axis=-1)
        tok = tok.astype(np.int32)[:, None]
    _assert_caches(tcache, jc, jcache)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_block_matches_jax(kind, mode):
    jc, tc, jp, tp, _ = _setup(4)
    li = 0 if kind == "mlstm" else 3
    jparams = jax.tree.map(jnp.asarray, jp["segments"][0][li])
    tparams = tp["layers"][li]
    jspec, tspec = JB.LayerSpec(kind=kind), TB.LayerSpec(kind=kind)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    jcache = tcache = None
    if mode == "decode":   # the cache a prefill of x leaves
        _, jcache, _ = JB.apply_block(
            jc, jspec, jparams, jnp.asarray(x),
            JB.Ctx(mode="prefill", positions=jnp.asarray(pos)), None)
        _, tcache = TB.apply_block(
            tc, tspec, tparams, torch.from_numpy(x),
            TB.Ctx(mode="prefill", positions=torch.from_numpy(pos.copy())),
            None)
        x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
        pos = np.full((B, 1), S)
    jy, jnew, _ = JB.apply_block(
        jc, jspec, jparams, jnp.asarray(x),
        JB.Ctx(mode=mode, positions=jnp.asarray(pos), pos=jnp.int32(S)),
        jcache)
    ty, tnew = TB.apply_block(
        tc, tspec, tparams, torch.from_numpy(x),
        TB.Ctx(mode=mode, positions=torch.from_numpy(pos.copy()), pos=S),
        tcache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    if mode == "train":
        assert tnew is None and jnew is None
        return
    got = tree.leaves(tnew)
    want = [np.asarray(a) for a in jax.tree.leaves(jnew)]
    assert [tuple(a.shape) for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=ATOL)


def test_train_forward_matches_jax_and_has_gradients():
    jc, tc, jp, tp, toks = _setup(4)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    jl, _, _ = jax.jit(lambda p, b: JM.forward(jc, p, b, mode="train"))(
        jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
    for leaf in tree.leaves(tp):
        leaf.requires_grad_(True)
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64),
             "positions": torch.arange(S).expand(B, S)}
    tl, caches, aux = TM.forward(tc, tp, batch, mode="train")
    assert caches is None and float(aux) == 0.0
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=ATOL)
    labels = torch.as_tensor(np.roll(toks, -1, axis=1), dtype=torch.int64)
    TM.cross_entropy(tl, labels).backward()
    wq = tp["layers"][0]["wq"].grad
    r = tp["layers"][3]["slstm"]["r"].grad
    assert wq is not None and r is not None
    assert torch.isfinite(wq).all() and float(wq.abs().max()) > 0.0
    assert torch.isfinite(r).all() and float(r.abs().max()) > 0.0


def test_init_model_shapes_match_jax_and_are_seeded():
    jc, tc = _configs(8)
    jp = jax.eval_shape(lambda k: JM.init_model(jc, k), jax.random.PRNGKey(0))
    want = []
    for seg, sp in zip(TM.build_segments(TM.layer_specs(jc)), jp["segments"]):
        for _ in range(seg.repeats):
            for layer in sp:
                want.append([(tuple(x.shape[1:]) if seg.repeats > 1
                              else tuple(x.shape), x.dtype.name)
                             for x in jax.tree.leaves(layer)])
    a = TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    got = [[(tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for x in tree.leaves(layer)] for layer in a["layers"]]
    assert got == want
    assert a["lm_head"]["w"].shape == (tc.d_model, tc.vocab_size)
    b = TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    c = TM.init_model(tc, torch.Generator().manual_seed(1), device="cpu")
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)
    assert not torch.equal(a["layers"][3]["slstm"]["r"],
                           c["layers"][3]["slstm"]["r"])
    nh = tc.n_heads
    assert torch.equal(a["layers"][0]["b_gates"],
                       torch.tensor([0.0] * nh + [3.0] * nh))
    # the JAX scales: conv 0.2, sLSTM w 1/sqrt(d) and r 1/sqrt(hd)
    d, hd = tc.d_model, tc.d_model // nh
    w, r = a["layers"][3]["slstm"]["w"], a["layers"][3]["slstm"]["r"]
    assert abs(float(w.std()) * d ** 0.5 - 1.0) < 0.05
    assert abs(float(r.std()) * hd ** 0.5 - 1.0) < 0.05
    assert abs(float(a["layers"][0]["conv_w"].std()) / 0.2 - 1.0) < 0.1


def test_from_jax_carries_the_xlstm_tree():
    jc, tc = _configs(8)
    pnp = jax.tree.map(np.asarray, JM.init_model(jc, jax.random.PRNGKey(3)))
    (seg,) = TM.build_segments(TM.layer_specs(tc))
    assert [s.kind for s in seg.pattern] == ["mlstm"] * 3 + ["slstm"]
    assert seg.repeats == 2 and len(pnp["segments"][0]) == 4
    tp = weights.from_jax(tc, pnp, device="cpu")
    assert len(tp["layers"]) == 8 and "lm_head" in tp
    for li, layer in enumerate(tp["layers"]):
        r, pi = divmod(li, 4)
        src = pnp["segments"][0][pi]
        if pi == 3:
            np.testing.assert_array_equal(layer["slstm"]["r"].numpy(),
                                          src["slstm"]["r"][r])
        else:
            np.testing.assert_array_equal(layer["wq"].numpy(), src["wq"][r])
