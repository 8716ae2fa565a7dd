"""Port model vs ``repro.models.model`` on the CPU: prefill + 4 decode steps.

JAX params are made by ``init_model``, given random numpy biases and norm
scales (so the QKV-bias, layernorm and head paths carry real values), and
carried across with ``weights.from_jax``.  Logits agree at atol 1e-4 (f32,
sums taken in another order) and the caches have the JAX shapes and values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import bench_tiny_config as j_tiny
from repro.configs.base import get_config as jget
from repro.models import model as JM
from repro_torch import optim as toptim
from repro_torch import weights
from repro_torch.configs.base import bench_tiny_config as t_tiny
from repro_torch.configs.base import get_config as tget
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as TT
from repro_torch.models import model as TM

torch.set_num_threads(2)

ATOL = 1e-4
B, S, N_DECODE = 2, 10, 4


def _configs(name):
    """(jax cfg, torch cfg) pairs; the reduced qwen2-0.5b and the bench
    tiny config are the slice's, the others cover window / geglu / qk-norm /
    embed scale (gemma3) and an untied head with layernorm, gelu and biases
    (starcoder2)."""
    if name == "bench_tiny":
        return j_tiny(), t_tiny()
    return jget(name).reduced(), tget(name).reduced()


SMALL_LEAVES = {"bq", "bk", "bv", "bo", "b_up", "b_down", "scale", "bias",
                "q_norm", "k_norm"}


def _perturb(params, seed):
    """Random values for every bias and norm scale (JAX inits them 0 / 1)."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key in SMALL_LEAVES:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(f, params)


def _setup(name):
    jc, tc = _configs(name)
    pnp = _perturb(JM.init_model(jc, jax.random.PRNGKey(0)), 1)
    jp = jax.tree.map(jnp.asarray, pnp)
    tp = weights.from_jax(tc, pnp, device="cpu")
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (B, S),
                                             dtype=np.int32)
    return jc, tc, jp, tp, toks


def _unstack(cfg, caches):
    """JAX caches (stacked per segment) -> per-layer (k, v) numpy pairs."""
    out = []
    for seg, sc in zip(TM.build_segments(TM.layer_specs(cfg)), caches):
        for r in range(seg.repeats):
            for c in sc:
                k, v = np.asarray(c["attn"]["k"]), np.asarray(c["attn"]["v"])
                out.append((k[r], v[r]) if seg.repeats > 1 else (k, v))
    return out


@pytest.mark.parametrize("name", ["qwen2-0.5b", "bench_tiny", "gemma3-12b",
                                  "starcoder2-3b"])
def test_prefill_and_decode_match_jax(name):
    jc, tc, jp, tp, toks = _setup(name)
    pos_np = np.broadcast_to(np.arange(S)[None], (B, S))
    jl, jcache = jax.jit(lambda p, b: JM.prefill(jc, p, b))(
        jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos_np)})
    tl, tcache = TM.prefill(tc, tp, {
        "tokens": torch.as_tensor(toks, dtype=torch.int64),
        "positions": torch.arange(S).expand(B, S)})
    assert tl.shape == (B, tc.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    shape = (B, S, tc.n_kv_heads, tc.head_dim)
    assert len(tcache) == tc.n_layers
    for c, (jk, jv) in zip(tcache, _unstack(jc, jcache)):
        assert c["attn"]["k"].shape == shape == jk.shape
        np.testing.assert_allclose(c["attn"]["k"].numpy(), jk, atol=ATOL)
        np.testing.assert_allclose(c["attn"]["v"].numpy(), jv, atol=ATOL)

    L = S + N_DECODE
    jcache = JM.pad_caches(jcache, L)
    tcache = TM.pad_caches(tcache, L)
    for c in tcache:
        assert c["attn"]["k"].shape == (B, L, tc.n_kv_heads, tc.head_dim)
    jdec = jax.jit(lambda p, t, pos, c: JM.decode_step(jc, p, t, pos, c))
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    for t in range(N_DECODE):
        jl, jcache = jdec(jp, jnp.asarray(tok), jnp.int32(S + t), jcache)
        tl, tcache = TM.decode_step(tc, tp,
                                    torch.as_tensor(tok, dtype=torch.int64),
                                    S + t, tcache)
        assert tl.shape == (B, 1, tc.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        tok = np.argmax(np.asarray(jl)[:, 0], axis=-1).astype(np.int32)[:, None]
    for c, (jk, jv) in zip(tcache, _unstack(jc, jcache)):
        assert c["attn"]["k"].shape == jk.shape
        np.testing.assert_allclose(c["attn"]["k"].numpy(), jk, atol=ATOL)
        np.testing.assert_allclose(c["attn"]["v"].numpy(), jv, atol=ATOL)


def test_from_jax_unstacks_layers_in_scan_order():
    jc, tc = _configs("qwen2-0.5b")
    pnp = jax.tree.map(np.asarray, JM.init_model(jc, jax.random.PRNGKey(3)))
    tp = weights.from_jax(tc, pnp, device="cpu")
    stacked = pnp["segments"][0][0]["attn"]["wq"]     # (repeats, d, qd)
    assert stacked.shape[0] == tc.n_layers == len(tp["layers"])
    for i, layer in enumerate(tp["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(), stacked[i])
    assert "bq" in tp["layers"][0]["attn"]          # qwen2 QKV biases
    assert "lm_head" not in tp                       # tied head


def test_init_model_is_seeded_and_device_free():
    tc = t_tiny()
    a = TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    b = TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    c = TM.init_model(tc, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(a["layers"][1]["mlp"]["w_up"],
                       b["layers"][1]["mlp"]["w_up"])
    assert not torch.equal(a["embed"]["table"], c["embed"]["table"])
    assert a["layers"][0]["attn"]["wq"].shape == (tc.d_model, tc.qkv_dim)


@pytest.mark.parametrize("name", ["hymba-1.5b", "whisper-base"])
def test_other_block_kinds_name_their_slice(name):
    """The families still unported (hybrid, encoder-decoder) raise."""
    tc = tget(name).reduced()
    with pytest.raises(NotImplementedError, match="not ported"):
        TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")


def test_packed_positions_raise_where_jax_masks_by_position(monkeypatch):
    """Packed positions ``[0, 1, 2, 0, 1, 2]``: JAX masks attention by
    position (key index <= query position), the port's train and prefill
    by index (the flash kernel's rule).  Without the check (the parent's
    forward) the first segment agrees and the second does not; so the port
    refuses the batch, as CPU tensors in ``forward`` and as numpy in the
    train step, and the 0..S-1 callers run as before."""
    jc, tc, jp, tp, toks = _setup("qwen2-0.5b")
    toks = toks[:, :6]
    packed = np.array([[0, 1, 2, 0, 1, 2]] * B, np.int32)
    jl = np.asarray(jax.jit(lambda p, b: JM.forward(jc, p, b, mode="train")[0])(
        jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(packed)}))
    batch = {"tokens": torch.as_tensor(toks).long(),
             "positions": torch.as_tensor(packed)}
    with monkeypatch.context() as m:
        m.setattr(TM, "check_positions", lambda positions: None)
        unchecked = TM.forward(tc, tp, batch, mode="train")[0].numpy()
    np.testing.assert_allclose(unchecked[:, :3], jl[:, :3], atol=ATOL)
    assert np.abs(unchecked[:, 3:] - jl[:, 3:]).max() > 1e-2

    for mode in ("train", "prefill"):
        with pytest.raises(ValueError, match="0..S-1"):
            TM.forward(tc, tp, batch, mode=mode)
    data = SyntheticTokens(tc.vocab_size, 6, B, seed=0)
    step = TT.make_train_step(tc, toptim.sgd(0.1))
    state = {"params": tp, "opt": toptim.sgd(0.1).init(tp)}
    ones = np.ones(B, np.float32)
    with pytest.raises(ValueError, match="0..S-1"):
        step(state, dict(data.batch(0), positions=packed, weights=ones))
    _, metrics = step(state, dict(data.batch(0), weights=ones))
    assert np.isfinite(float(metrics["loss"]))
    # an offset start (positions 5..10) is refused too
    with pytest.raises(ValueError, match="0..S-1"):
        TM.check_positions(np.arange(5, 11)[None])
