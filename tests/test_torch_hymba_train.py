"""Hymba training in the port vs the JAX package on the CPU.

``MLSTMChunk`` in the Mamba heads' form (``normalize=False, scale=1.0``,
q/k 8 wide and broadcast over 3 heads, v 32 wide; the kernel forward on
the card, the plain version here; the backward recomputes the plain
recurrence) against ``jax.grad`` of the reference
``repro.models.ssm.linear_recurrence``: one chunk (S 16) and two (S 256),
with Hymba's gates and with gates whose stabilizer ties (g = 0, every i
equal), since unnormalized the gradients of g and i pass through the
running max and its tie rule (both frameworks split a tie evenly).  Then
the reduced hymba-1.5b (4 layers, window 8 over seq 16): the
``train_loss`` gradients against ``jax.grad``, one ``make_train_step``
on each ``mask_agg`` path with a worker dropped, and chip_smoke's
train_hymba_parity layout (depth 2: a global and a windowed layer).

Tolerances as tests/test_torch_xlstm_train.py: y and every gradient at
1e-4 of its leaf's largest magnitude (f32; the port sums the chunk's log
decay in f64, kernels/mlstm_plain.py), the loss at 1e-5; after one Adam
step m at 1e-4 of its scale and p within 2 lr.
"""
import dataclasses

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
from repro.models import ssm as JS
from repro_torch import optim as toptim
from repro_torch import tree, weights
from repro_torch.configs.base import get_config as tget
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels.mlstm_chunk import MLSTMChunk
from repro_torch.launch import train as TT
from repro_torch.models import model as TM

torch.set_num_threads(2)

REC_TOL = 1e-4
LR = 3e-3


def _mamba_inputs(S, seed, gates, B=2, H=3, dq=8, dv=32):
    """c/b (B,S,dq) shared by the heads, v (B,S,H,dv), f32 log gates, and
    a cotangent for y."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    c, b, v = n(B, S, dq), n(B, S, dq), n(B, S, H, dv)
    if gates == "tied":   # every D[t, s] and every chunk's max equal
        g = np.zeros((B, S, H), np.float32)
        i = np.full((B, S, H), -1.5, np.float32)
    else:
        dt = np.logaddexp(0.0, n(B, S, H) - 2.0)
        g = (-dt * np.exp(0.3 * n(H))).astype(np.float32)
        i = np.log(dt + 1e-9).astype(np.float32)
    return [c, b, v, g, i], n(B, S, H, dv)


def _scaled(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("gates", ["hymba", "tied"])
@pytest.mark.parametrize("S", [16, 256])
def test_mlstm_chunk_function_unnormalized_grads_match_jax(S, gates):
    """y and the gradients of c, b (summed over the heads through the
    broadcast), v, g and i against jax.grad of the reference."""
    xs, r = _mamba_inputs(S, S + len(gates), gates)
    H = xs[2].shape[2]

    def jloss(c, b, v, g, i):
        q = jnp.broadcast_to(c[:, :, None], c.shape[:2] + (H, c.shape[2]))
        k = jnp.broadcast_to(b[:, :, None], b.shape[:2] + (H, b.shape[2]))
        y, _ = JS.linear_recurrence(q, k, v, g, i, normalize=False,
                                    scale=1.0)
        return jnp.sum(y * r), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                     has_aux=True)(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in xs]
    q, k = (t[:, :, None].expand(-1, -1, H, -1) for t in ts[:2])
    y, *state = MLSTMChunk.apply(q, k, *ts[2:], False, 1.0)
    assert y.shape == xs[2].shape and state[2].shape == (2, H, 8, 32)
    tg = torch.autograd.grad((y * torch.from_numpy(r)).sum(), ts)
    assert _scaled(y.detach().numpy(), np.asarray(jy)) <= REC_TOL
    for name, a, b in zip(("c", "b", "v", "g", "i"), tg, jg):
        assert np.abs(np.asarray(b)).max() > 0.0, name
        err = _scaled(a.numpy(), np.asarray(b))
        assert err <= REC_TOL, (name, err)


def test_mlstm_chunk_function_keeps_the_normalized_default():
    """Five tensors alone keep the normalized form; the options trailing
    them take no gradient."""
    xs, r = _mamba_inputs(16, 1, "hymba", H=2, dq=8, dv=8)
    q = np.broadcast_to(xs[0][:, :, None], xs[2].shape).copy()
    k = np.broadcast_to(xs[1][:, :, None], xs[2].shape).copy()
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (q, k, xs[2], xs[3], xs[4])]
    y5, *_ = MLSTMChunk.apply(*ts)
    y7, *_ = MLSTMChunk.apply(*ts, True, None)
    want, _ = JS.linear_recurrence(*map(jnp.asarray, (q, k, *xs[2:])),
                                   normalize=True)
    assert torch.equal(y5, y7)
    assert _scaled(y5.detach().numpy(), np.asarray(want)) <= REC_TOL
    g5 = torch.autograd.grad((y5 * torch.from_numpy(r)).sum(), ts)
    g7 = torch.autograd.grad((y7 * torch.from_numpy(r)).sum(), ts)
    for a, b in zip(g5, g7):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The reduced hymba-1.5b: loss gradients and train steps.
# ---------------------------------------------------------------------------


def _cfgs(**changes):
    jc, tc = jget("hymba-1.5b").reduced(), tget("hymba-1.5b").reduced()
    return (dataclasses.replace(jc, **changes),
            dataclasses.replace(tc, **changes))


def _np(t):
    return jax.tree.map(np.asarray, t)


def test_train_loss_and_grads_match_jax():
    jc, tc = _cfgs()
    params = JM.init_model(jc, jax.random.PRNGKey(1))
    batch = SyntheticTokens(jc.vocab_size, 16, 4, seed=2).batch(0)

    def jloss(p):
        return JM.train_loss(jc, p, {k: jnp.asarray(v)
                                     for k, v in batch.items()})[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    tp = weights.from_jax(tc, _np(params), device="cpu")
    flat = [x.requires_grad_(True) for x in tree.leaves(tp)]
    tl, metrics = TM.train_loss(tc, tree.unflatten(tp, flat),
                                {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
    grads = torch.autograd.grad(tl, flat)
    assert metrics["aux"].item() == 0.0
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=1e-6)
    want = tree.leaves(weights.from_jax(tc, _np(jg), device="cpu"))
    assert len(grads) == len(want) == 4 * 20 + 3
    for a, b in zip(grads, want):
        assert _scaled(a.numpy(), b.numpy()) <= REC_TOL


@pytest.mark.parametrize("mask_agg", ["weights", "psum"])
def test_train_step_matches_jax(mask_agg):
    jc, tc = _cfgs()
    jopt, topt = joptim.adamw(LR), toptim.adamw(LR, fused=True)
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    jstate = {"params": params, "opt": jopt.init(params)}
    tstate = weights.state_from_jax(tc, _np(jstate), device="cpu")
    f = np.asarray([1.0, 1.0, 0.0, 1.0], np.float32)
    batch = SyntheticTokens(jc.vocab_size, 16, 8, seed=0).batch(0)
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
    got, want = (tree.leaves(tnew["opt"]["m"]), tree.leaves(
        weights.from_jax(tc, _np(jnew["opt"]["m"]), device="cpu")))
    for a, b in zip(got, want):
        assert _scaled(a.numpy(), b.numpy()) <= REC_TOL
    want = tree.leaves(weights.from_jax(tc, _np(jnew["params"]),
                                        device="cpu"))
    err = max(float((a - b).abs().max())
              for a, b in zip(tree.leaves(tnew["params"]), want))
    assert err <= 2 * LR


def test_depth_two_trains_every_leaf():
    """chip_smoke's train_hymba_parity layout at reduced width (layer 0
    global, layer 1 windowed): a psum step moves every leaf, the Mamba
    constants and both branch norms among them."""
    _, tc = _cfgs(n_layers=2)
    assert [s.window for s in TM.layer_specs(tc)] == [0, 8]
    opt = toptim.adamw(LR, fused=True)
    params = TM.init_model(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    before = [x.clone() for x in tree.leaves(params)]
    batch = SyntheticTokens(tc.vocab_size, 16, 4, seed=1).batch(0)
    state, m = TT.make_train_step(tc, opt, mask_agg="psum")(
        {"params": params, "opt": opt.init(params)},
        dict(batch, mask=np.ones(2, np.float32)))
    assert np.isfinite(m["loss"].item())
    moved = [bool((a != b).any()) for a, b in
             zip(tree.leaves(state["params"]), before)]
    assert all(moved), moved
