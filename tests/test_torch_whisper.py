"""whisper-base in the port vs the JAX package on the CPU (reduced, f32).

The reduced config keeps the encoder-decoder: 2 encoder and 2 decoder
blocks of 4 heads (no GQA), layernorm, gelu with biases, learned
positions (no RoPE), 32 frames.  JAX params from ``init_model`` get random
biases and norm scales (so every bias of the self- and cross-attention
carries a value) and come across with ``weights.from_jax``; the frames
are seeded numpy.  Held against JAX: the encoder output, the prefill
logits and caches (self k/v and the cross ck/cv), 4 decode steps, the
greedy ids of ``ServeEngine.generate`` with and without frames, the
train loss and its gradients, and one train step on each ``mask_agg``
path.

Tolerances (f32, sums in another order): the encoder output and caches
at 1e-5, logits at 1e-4 (test_torch_model.py's), the loss at 1e-5, each
gradient and Adam's m at 1e-4 of its leaf's largest magnitude, p within
2 lr after a step.  The key biases' gradients are 0 (a softmax does not
see a shift of its row), so both sides' are held at 1e-7 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs.base import get_config as jget
from repro.core.aggregation import example_weights as j_example_weights
from repro.launch.train import jit_train_step
from repro.models import model as JM
from repro.serving.engine import ServeEngine as JEngine
from repro_torch import optim as toptim
from repro_torch import tree, weights
from repro_torch.configs.base import get_config as tget
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as TT
from repro_torch.models import model as TM
from repro_torch.serving.engine import ServeEngine as TEngine

torch.set_num_threads(2)

NAME = "whisper-base"
ENC_ATOL = 1e-5
ATOL = 1e-4
GRAD_TOL = 1e-4
ZERO_GRAD_ATOL = 1e-7
LR = 3e-3
B, S, N_DECODE = 2, 10, 4
SMALL_LEAVES = {"bq", "bk", "bv", "bo", "b_up", "b_down", "scale", "bias"}


def _perturb(params, seed):
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key in SMALL_LEAVES:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(f, params)


def _frames(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal(
        (n, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    jc, tc = jget(NAME).reduced(), tget(NAME).reduced()
    pnp = _perturb(JM.init_model(jc, jax.random.PRNGKey(0)), 1)
    return jc, tc, jax.tree.map(jnp.asarray, pnp), weights.from_jax(
        tc, pnp, device="cpu")


def _scaled(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _leaf_names(node, pre=""):
    """Path names in ``tree.leaves`` order."""
    if isinstance(node, dict):
        return [n for k in sorted(node)
                for n in _leaf_names(node[k], f"{pre}/{k}")]
    if isinstance(node, (list, tuple)):
        return [n for i, t in enumerate(node)
                for n in _leaf_names(t, f"{pre}/{i}")]
    return [pre]


def _assert_grads_close(like, got, want):
    """Each leaf at GRAD_TOL of its scale; the key biases (a softmax does
    not see a shift of its row, so their gradient is 0 and both sides hold
    rounding noise) at ZERO_GRAD_ATOL absolute."""
    names = _leaf_names(like)
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        if name.endswith("/bk"):
            assert max(float(a.abs().max()), float(b.abs().max())) \
                <= ZERO_GRAD_ATOL, name
        else:
            assert _scaled(a.numpy(), b.numpy()) <= GRAD_TOL, name


def _unstack(cfg, jcaches):
    """JAX caches (stacked per segment) -> one numpy tree a layer."""
    out = []
    for seg, sc in zip(TM.build_segments(TM.layer_specs(cfg)), jcaches):
        for r in range(seg.repeats):
            for c in sc:
                out.append(jax.tree.map(
                    lambda a: np.asarray(a)[r] if seg.repeats > 1
                    else np.asarray(a), c))
    return out


def test_from_jax_carries_the_encoder(model):
    jc, tc, jp, tp = model
    assert len(tp["encoder"]["layers"]) == tc.n_encoder_layers == 2
    assert len(tp["layers"]) == tc.n_layers == 2
    stacked = np.asarray(jp["encoder"]["segments"][0][0]["attn"]["wq"])
    for i, layer in enumerate(tp["encoder"]["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                      stacked[i])
    assert tp["encoder"]["pos_table"].shape == (tc.encoder_seq_len,
                                                tc.d_model)
    assert tp["dec_pos_table"].shape == (TM.DEC_POS_LEN, tc.d_model)
    assert set(tp["layers"][0]) == {"norm1", "attn", "norm2", "mlp",
                                    "norm_cross", "cross"}
    assert "bo" in tp["layers"][0]["cross"]


def test_encoder_output_matches_jax(model):
    jc, tc, jp, tp = model
    fr = _frames(jc, B, 3)
    want = np.asarray(jax.jit(lambda p, f: JM._run_encoder(jc, p, f))(
        jp, jnp.asarray(fr)))
    got = TM._run_encoder(tc, tp, torch.from_numpy(fr))
    assert got.shape == (B, tc.encoder_seq_len, tc.d_model)
    np.testing.assert_allclose(got.numpy(), want, atol=ENC_ATOL)


def test_prefill_cross_caches_and_decode_match_jax(model):
    jc, tc, jp, tp = model
    fr = _frames(jc, B, 4)
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (B, S),
                                             dtype=np.int32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    jl, jcache = jax.jit(lambda p, b: JM.prefill(jc, p, b))(
        jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos),
             "frames": jnp.asarray(fr)})
    tl, tcache = TM.prefill(tc, tp, {
        "tokens": torch.as_tensor(toks, dtype=torch.int64),
        "positions": torch.arange(S).expand(B, S),
        "frames": torch.from_numpy(fr)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    cross = (B, tc.encoder_seq_len, tc.n_kv_heads, tc.head_dim)
    for c, jc_ in zip(tcache, _unstack(jc, jcache)):
        assert set(c) == {"attn", "cross"}
        assert c["cross"]["ck"].shape == cross == jc_["cross"]["ck"].shape
        for part, names in (("attn", ("k", "v")), ("cross", ("ck", "cv"))):
            for n in names:
                np.testing.assert_allclose(c[part][n].numpy(),
                                           jc_[part][n], atol=ENC_ATOL)

    L = S + N_DECODE
    jcache, tcache = JM.pad_caches(jcache, L), TM.pad_caches(tcache, L)
    assert tcache[0]["attn"]["k"].shape[1] == L
    assert tcache[0]["cross"]["ck"].shape == cross   # never padded
    jdec = jax.jit(lambda p, t, q, c: JM.decode_step(jc, p, t, q, c))
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    for t in range(N_DECODE):
        jl, jcache = jdec(jp, jnp.asarray(tok), jnp.int32(S + t), jcache)
        tl, tcache = TM.decode_step(tc, tp, torch.as_tensor(
            tok, dtype=torch.int64), S + t, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        tok = np.argmax(np.asarray(jl)[:, 0], axis=-1).astype(
            np.int32)[:, None]


@pytest.mark.parametrize("with_frames", [True, False])
def test_generate_matches_jax(model, with_frames):
    """Greedy ids of both engines; without frames both encode zeros."""
    jc, tc, jp, tp = model
    prompt = np.random.default_rng(6).integers(0, jc.vocab_size, (B, 8),
                                               dtype=np.int32)
    fr = _frames(jc, B, 7) if with_frames else None
    want = np.asarray(JEngine(jc, jp).generate(prompt, 6, frames=fr))
    got = TEngine(tc, tp, device="cpu").generate(prompt, 6, frames=fr)
    assert got.shape == (B, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _batch(cfg, n, seed):
    batch = SyntheticTokens(cfg.vocab_size, 16, n, seed=seed).batch(0)
    return dict(batch, frames=_frames(cfg, n, seed + 100))


def test_train_loss_and_grads_match_jax(model):
    jc, tc, jp, tp = model
    batch = _batch(jc, 4, 2)

    def jloss(p):
        return JM.train_loss(jc, p, {k: jnp.asarray(v)
                                     for k, v in batch.items()})[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    flat = [x.detach().clone().requires_grad_(True)
            for x in tree.leaves(tp)]
    tl, _ = TM.train_loss(tc, tree.unflatten(tp, flat),
                          {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(tl, flat)
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=1e-6)
    want = tree.leaves(weights.from_jax(tc, jax.tree.map(np.asarray, jg),
                                        device="cpu"))
    _assert_grads_close(tp, grads, want)
    # the encoder and both position tables take a gradient
    tg = tree.unflatten(tp, grads)
    assert float(tg["encoder"]["pos_table"].abs().max()) > 0
    assert float(tg["dec_pos_table"][:16].abs().max()) > 0
    assert float(tg["encoder"]["layers"][0]["attn"]["wq"].abs().max()) > 0


@pytest.mark.parametrize("mask_agg", ["weights", "psum"])
def test_train_step_matches_jax(model, mask_agg):
    """One AdamW step with a worker dropped; the frames ride through the
    psum path's per-worker split."""
    jc, tc, jp, _ = model
    jopt, topt = joptim.adamw(LR), toptim.adamw(LR, fused=True)
    jstate = {"params": jp, "opt": jopt.init(jp)}
    tstate = weights.state_from_jax(tc, jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    f = np.asarray([1.0, 1.0, 0.0, 1.0], np.float32)
    batch = _batch(jc, 8, 0)
    if mask_agg == "psum":
        jb, tb = dict(batch, mask=jnp.asarray(f)), dict(batch, mask=f)
    else:
        w = j_example_weights(f, 8)
        jb, tb = dict(batch, weights=w), dict(batch, weights=w)
    jnew, jm = jit_train_step(jc, jopt, donate=False,
                              mask_agg=mask_agg)(jstate, jb)
    tnew, tm = TT.make_train_step(tc, topt, mask_agg=mask_agg)(tstate, tb)
    for key in ("loss", "ce"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(tm["gnorm"].item(), float(jm["gnorm"]),
                               rtol=1e-4)
    _assert_grads_close(tnew["params"], tree.leaves(tnew["opt"]["m"]),
                        tree.leaves(weights.from_jax(
                            tc, jax.tree.map(np.asarray, jnew["opt"]["m"]),
                            device="cpu")))
    want = tree.leaves(weights.from_jax(
        tc, jax.tree.map(np.asarray, jnew["params"]), device="cpu"))
    err = max(float((a - b).abs().max())
              for a, b in zip(tree.leaves(tnew["params"]), want))
    assert err <= 2 * LR

