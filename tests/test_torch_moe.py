"""Port MoE family vs ``repro.models.moe`` and the JAX model on the CPU.

Both MoE configs at ``get_config(...).reduced()`` (d_model 64, 8 experts,
top-2, expert d_ff 32): deepseek-moe-16b (rmsnorm, MHA, one shared expert,
a dense first layer, ``router_scale``) and phi3.5-moe-42b-a6.6b
(layernorm, GQA, no shared expert, no first dense layer).  JAX params are
carried across with ``weights.from_jax``; inputs are numpy, seeded.
Training is tests/test_torch_moe_train.py's.

Tolerances: routing (weights, f_e, p_e, aux) at 1e-6, f32 on both sides;
outputs, logits and losses at 1e-4 / 1e-5, the dense family's bars
(tests/test_torch_model.py, tests/test_torch_train.py): the port sums a
token's k expert outputs in slot order where JAX sums them in expert
order (its scatter-add), which differs in the last bits.  Drops are
exercised at capacity factor 0.25, as tests/test_ssm_moe_units.py:153
does, and the drop-free runs use factor 8.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models import blocks as JB
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import tree, weights
from repro_torch.configs.base import get_config as tget
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.serving.engine import ServeEngine

torch.set_num_threads(2)

NAMES = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"]
ATOL = 1e-4
ROUTE_TOL = 1e-6
B, S = 2, 12


def _cfgs(name, factor=None, **changes):
    jc, tc = jget(name).reduced(), tget(name).reduced()
    if factor is not None:
        changes["moe_capacity_factor"] = factor
    return (dataclasses.replace(jc, **changes),
            dataclasses.replace(tc, **changes))


def _np(t):
    return jax.tree.map(np.asarray, t)


def _perturb(params, seed):
    """Random norm scales and biases (JAX inits them 1 / 0)."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key in ("scale", "bias"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(f, params)


@functools.lru_cache(maxsize=None)
def _init_np(name, seed, n_layers):
    """JAX init as numpy, once per (config, seed, depth): the capacity
    factor does not enter the params."""
    jc = dataclasses.replace(jget(name).reduced(), n_layers=n_layers)
    return _np(JM.init_model(jc, jax.random.PRNGKey(seed)))


def _jinit(jc, seed):
    return jax.tree.map(jnp.asarray, _init_np(jc.name, seed, jc.n_layers))


def _model(jc, tc, seed=0):
    pnp = _perturb(_jinit(jc, seed), seed + 1)
    return jax.tree.map(jnp.asarray, pnp), weights.from_jax(tc, pnp,
                                                            device="cpu")


def _moe_params(jc, seed):
    jp = JMOE.moe_init(jc, jax.random.PRNGKey(seed), jnp.float32)
    return jp, weights._tree(_np(jp), torch.device("cpu"))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Routing, aux, capacity.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_route_and_aux_match_jax(name):
    jc, tc = _cfgs(name)
    jp, tp = _moe_params(jc, 0)
    x = _x((B, S, jc.d_model), 1)
    jw, ji, jf, jpe = JMOE._route(jc, jp["router"], jnp.asarray(x))
    tw, ti, tf, tpe = TMOE._route(tc, tp["router"], torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for got, want in ((tw, jw), (tf, jf), (tpe, jpe)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ROUTE_TOL, rtol=ROUTE_TOL)
    if jc.router_scale:
        np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(float(TMOE._aux(tc, tf, tpe)),
                               float(JMOE._aux(jc, jf, jpe)),
                               atol=ROUTE_TOL, rtol=ROUTE_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_capacity_for_matches_jax_over_a_grid(name):
    jc, tc = _cfgs(name)
    for n in (1, 4, 7, 24, 64, 100, 512, 4096):
        for factor in (None, 0.25, 1.0, 1.25, 8.0):
            got = TMOE.capacity_for(tc, n, factor)
            assert got == JMOE.capacity_for(jc, n, factor), (n, factor)
            assert got % 8 == 0 and got >= 8


# ---------------------------------------------------------------------------
# The MoE FFN.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("factor", [8.0, 0.25])
@pytest.mark.parametrize("name", NAMES)
def test_moe_apply_matches_jax(name, factor):
    jc, tc = _cfgs(name, factor)
    jp, tp = _moe_params(jc, 2)
    x = _x((2, 32, jc.d_model), 3)
    jy, jaux = JMOE.moe_apply(jc, jp, jnp.asarray(x))
    ty, taux = TMOE.moe_apply(tc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ROUTE_TOL,
                               rtol=ROUTE_TOL)
    _, ti, _, _ = TMOE._route(tc, tp["router"], torch.from_numpy(x))
    C = TMOE.capacity_for(tc, x.shape[0] * x.shape[1])
    plan = TMOE.dispatch_plan(ti.reshape(-1, tc.top_k), tc.n_experts, C)
    n_dropped = int((plan.dst == tc.n_experts * C).sum())
    if factor < 1.0:
        assert n_dropped > 0, "capacity 0.25 dropped no slot"
    else:
        assert n_dropped == 0


def test_dispatch_plan_is_the_sorted_assignment():
    """Every kept entry sits at slot e * C + (its rank among expert e's
    entries in token order); each slot is filled by at most one entry, and
    src and dst are inverse on the kept entries."""
    rng = np.random.default_rng(4)
    E, k, N, C = 6, 2, 40, 8
    ids = np.stack([rng.choice(E, k, replace=False) for _ in range(N)])
    plan = TMOE.dispatch_plan(torch.from_numpy(ids), E, C)
    flat = ids.reshape(-1)
    seen = {e: 0 for e in range(E)}
    for j, e in enumerate(flat):
        r = seen[e]
        seen[e] += 1
        want = e * C + r if r < C else E * C
        assert int(plan.dst[j]) == want
        if r < C:
            assert int(plan.src[want]) == j
    filled = plan.src < N * k
    assert int(filled.sum()) == sum(min(n, C) for n in seen.values())


@pytest.mark.parametrize("name", NAMES)
def test_moe_apply_decode_s1_matches_jax(name):
    jc, tc = _cfgs(name)
    jp, tp = _moe_params(jc, 5)
    x = _x((3, 1, jc.d_model), 6)
    jy, jaux = JMOE.moe_apply(jc, jp, jnp.asarray(x))
    ty, taux = TMOE.moe_apply(tc, tp, torch.from_numpy(x))
    assert TMOE.capacity_for(tc, 3) == 8
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ROUTE_TOL,
                               rtol=ROUTE_TOL)


def test_moe_backward_is_deterministic_and_matches_jax():
    """Two backward passes give the same bits (no scatter-add over repeated
    indices), and the gradients of x, the router and the banks match
    jax.grad at drops."""
    jc, tc = _cfgs("deepseek-moe-16b", 0.25)
    jp, tp = _moe_params(jc, 7)
    x = _x((2, 32, jc.d_model), 8)
    r = _x((2, 32, jc.d_model), 9)

    def jloss(p, xx):
        y, aux = JMOE.moe_apply(jc, p, xx)
        return jnp.sum(y * r) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    outs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in tree.leaves(tp)]
        xt = torch.from_numpy(x).requires_grad_(True)
        y, aux = TMOE.moe_apply(tc, tree.unflatten(tp, leaves), xt)
        loss = torch.sum(y * torch.from_numpy(r)) + aux
        outs.append(torch.autograd.grad(loss, leaves + [xt]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    want = [np.asarray(t) for t in tree.leaves(
        weights._tree(_np(jg), torch.device("cpu")))] + [np.asarray(jgx)]
    for got, w in zip(outs[0], want):
        np.testing.assert_allclose(got.numpy(), w, atol=ATOL, rtol=ATOL)


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("kind", ["attn_dense", "attn_moe"])
def test_block_matches_jax(kind, mode):
    jc, tc = _cfgs("deepseek-moe-16b")
    jp, tp = _model(jc, tc)
    li = 0 if kind == "attn_dense" else 1
    assert TM.layer_specs(tc)[li].kind == kind
    jparams = jp["segments"][0][li]
    tparams = tp["layers"][li]
    jspec, tspec = JB.LayerSpec(kind=kind), TB.LayerSpec(kind=kind)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    jcache = tcache = None
    if mode == "decode":   # the cache a prefill of x leaves, grown by one
        _, jcache, _ = JB.apply_block(
            jc, jspec, jparams, jnp.asarray(x),
            JB.Ctx(mode="prefill", positions=jnp.asarray(pos)), None)
        _, tcache, _ = TB.block_forward(
            tc, tspec, tparams, torch.from_numpy(x),
            TB.Ctx(mode="prefill", positions=torch.from_numpy(pos.copy())),
            None)
        jcache = JM.pad_caches(jcache, S + 1)
        tcache = TM.pad_caches(tcache, S + 1)
        x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
        pos = np.full((B, 1), S)
    jy, jnew, jaux = JB.apply_block(
        jc, jspec, jparams, jnp.asarray(x),
        JB.Ctx(mode=mode, positions=jnp.asarray(pos), pos=jnp.int32(S)),
        jcache)
    ty, tnew, taux = TB.block_forward(
        tc, tspec, tparams, torch.from_numpy(x),
        TB.Ctx(mode=mode, positions=torch.from_numpy(pos.copy()), pos=S),
        tcache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    if kind == "attn_dense":
        assert taux is None and float(jaux) == 0.0
    else:
        assert taux.dtype == torch.float32
        np.testing.assert_allclose(float(taux), float(jaux), atol=ROUTE_TOL)
    if mode == "train":
        assert tnew is None
        return
    for a, b in zip(tree.leaves(tnew), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=ATOL)


# ---------------------------------------------------------------------------
# The model: forward, prefill + decode, serving.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_and_aux_match_jax(name):
    jc, tc = _cfgs(name, 0.25)
    jp, tp = _model(jc, tc)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (B, S),
                                             dtype=np.int32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    jl, _, jaux = jax.jit(lambda p, b: JM.forward(jc, p, b, mode="train"))(
        jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
    tl, caches, taux = TM.forward(tc, tp, {
        "tokens": torch.as_tensor(toks, dtype=torch.int64),
        "positions": torch.arange(S).expand(B, S)}, mode="train")
    assert caches is None and taux.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5,
                               rtol=1e-6)
    n_moe = sum(s.kind == "attn_moe" for s in TM.layer_specs(tc))
    assert n_moe >= 3 and float(taux) > 0.5 * n_moe


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_greedy_decode_match_jax(name):
    jc, tc = _cfgs(name)
    jp, tp = _model(jc, tc)
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (B, S),
                                             dtype=np.int32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    jl, jcache = jax.jit(lambda p, b: JM.prefill(jc, p, b))(
        jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
    tl, tcache = TM.prefill(tc, tp, {
        "tokens": torch.as_tensor(toks, dtype=torch.int64),
        "positions": torch.arange(S).expand(B, S)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    n_dec = 4
    jcache, tcache = (JM.pad_caches(jcache, S + n_dec),
                      TM.pad_caches(tcache, S + n_dec))
    jdec = jax.jit(lambda p, t, q, c: JM.decode_step(jc, p, t, q, c))
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    for t in range(n_dec):
        jl, jcache = jdec(jp, jnp.asarray(tok), jnp.int32(S + t), jcache)
        tl, tcache = TM.decode_step(tc, tp, torch.as_tensor(
            tok, dtype=torch.int64), S + t, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        assert np.array_equal(np.argmax(tl.numpy()[:, 0], -1),
                              np.argmax(np.asarray(jl)[:, 0], -1))
        tok = np.argmax(np.asarray(jl)[:, 0], axis=-1).astype(np.int32)
        tok = tok[:, None]


@pytest.mark.parametrize("name", NAMES)
def test_serve_engine_ids_equal_jax(name):
    jc, tc = _cfgs(name)
    params = _jinit(jc, 0)
    tp = weights.from_jax(tc, _np(params), device="cpu")
    prompts = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 7),
                                                dtype=np.int32)
    want = JaxEngine(jc, params).generate(prompts, n_new=6)
    got = ServeEngine(tc, tp, device="cpu").generate(prompts, n_new=6)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Init and weight transfer.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_init_model_shapes_match_jax(name):
    jc, tc = _cfgs(name)
    jp = jax.eval_shape(lambda k: JM.init_model(jc, k), jax.random.PRNGKey(0))
    want = []
    for seg, sp in zip(TM.build_segments(TM.layer_specs(jc)), jp["segments"]):
        for _ in range(seg.repeats):
            for layer in sp:
                want.append([tuple(x.shape[1:]) if seg.repeats > 1
                             else tuple(x.shape)
                             for x in jax.tree.leaves(layer)])
    a = TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    got = [[tuple(x.shape) for x in tree.leaves(layer)]
           for layer in a["layers"]]
    assert got == want
    n = sum(x.numel() for x in tree.leaves(a))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    # the reference's scales: banks 1/sqrt(d) in, 1/sqrt(F) out
    moe = a["layers"][-1]["moe"]
    d, f = tc.d_model, tc.moe_d_ff
    assert abs(float(moe["experts"]["w_gate"].std()) * d ** 0.5 - 1) < 0.05
    assert abs(float(moe["experts"]["w_down"].std()) * f ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("name,n_layers", [("deepseek-moe-16b", 13),
                                           ("phi3.5-moe-42b-a6.6b", 4)])
def test_from_jax_unstacks_the_expert_banks(name, n_layers):
    """deepseek at 13 layers: a dense segment, then 12 MoE layers stacked
    in one segment; phi: 4 MoE layers in one.  Every (R, E, D, F) bank
    becomes R per-layer (E, D, F) banks, in scan order."""
    jc, tc = _cfgs(name, n_layers=n_layers)
    pnp = _np(_jinit(jc, 3))
    segs = TM.build_segments(TM.layer_specs(tc))
    moe_seg = segs[-1]
    assert moe_seg.pattern[0].kind == "attn_moe" and moe_seg.repeats > 1
    tp = weights.from_jax(tc, pnp, device="cpu")
    assert len(tp["layers"]) == n_layers
    first = n_layers - moe_seg.repeats
    src = pnp["segments"][-1][0]["moe"]
    for r in range(moe_seg.repeats):
        layer = tp["layers"][first + r]["moe"]
        for name_ in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(layer["experts"][name_].numpy(),
                                          src["experts"][name_][r])
        np.testing.assert_array_equal(layer["router"].numpy(),
                                      src["router"][r])
        if tc.n_shared_experts:
            np.testing.assert_array_equal(
                layer["shared"]["w_down"].numpy(), src["shared"]["w_down"][r])
    if first:
        assert "mlp" in tp["layers"][0] and "moe" not in tp["layers"][0]
        assert tp["layers"][0]["mlp"]["w_up"].shape == (tc.d_model,
                                                        tc.dense_d_ff)
