"""xLSTM training in the port vs the JAX package on the CPU.

``MLSTMChunk`` (the mLSTM kernel's autograd Function: the kernel forward on
the card, the plain version here; the backward recomputes the plain
recurrence) against ``jax.grad`` of the reference
``repro.models.ssm.linear_recurrence`` at S 128 (one chunk) and S 256 (two
chunks), and from an entering state with a loss that also reads the final
state (the entering state's gradients too), then the reduced xlstm-350m
(3 mLSTM + 1 sLSTM blocks): the ``train_loss`` gradients, one
``make_train_step`` on each ``mask_agg`` path with a worker dropped, the
weights step's gradients contiguous as the optimizer's kernel reads
them, and a 4-step ``Trainer`` run against the JAX ``Trainer``.  Inputs
are numpy, seeded.

Tolerances: the recurrence's y and gradients, and the model's gradients,
at 1e-4 of each leaf's largest magnitude (f32; the port sums the chunk's
log decay in f64, kernels/mlstm_plain.py; the xLSTM's embedding gradient
reaches ~45, so an absolute bar would grade the leaves by their scale);
the gradient norm at rtol 1e-4; after one Adam step, losses at 1e-5, m
(= 0.1 g) at 1e-4 of its scale like the gradients, and p within 2 lr, as
tests/test_torch_train.py.  The
Trainer runs SGD: at the xLSTM's gradient scale, Adam's first steps move
every entry whose gradient sits at rounding noise by lr times a sign the
two packages may disagree on, so the Trainer's own bookkeeping is held
under an update that is linear in the gradient, SGD at lr 1e-3 (the
gradient norm is ~96: at lr 0.05 the loss climbs and the two runs part
by 1e-2 in 4 steps), with losses within 1e-5 and params within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.cluster.simulator import ClusterSim as JClusterSim
from repro.configs.base import get_config as jget
from repro.core import controller as jctl
from repro.core.aggregation import example_weights as j_example_weights
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.launch.train import Trainer as JTrainer
from repro.launch.train import jit_train_step
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch import optim as toptim
from repro_torch import tree, weights
from repro_torch.cluster.simulator import ClusterSim
from repro_torch.configs.base import get_config as tget
from repro_torch.core import controller as tctl
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.kernels.mlstm_chunk import MLSTMChunk
from repro_torch.kernels.mlstm_plain import ScanState, local_recurrence
from repro_torch.launch import train as TT
from repro_torch.models import model as TM

torch.set_num_threads(2)

REC_TOL = 1e-4
LR = 3e-3
SGD_LR = 1e-3


def _rec_inputs(S, seed, B=2, H=2, hd=16):
    """q/k/v and f32 log gates as the mLSTM block makes them, and a
    cotangent for y."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k, v = 0.5 * n(B, S, H, hd), 0.5 * n(B, S, H, hd), n(B, S, H, hd)
    g = -np.logaddexp(0.0, -(n(B, S, H) + 3.0)).astype(np.float32)
    i = 0.5 * n(B, S, H)
    return [q, k, v, g, i], n(B, S, H, hd)


def _scaled(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("S", [128, 256])
def test_mlstm_chunk_function_grads_match_jax(S):
    xs, r = _rec_inputs(S, S)

    def jloss(*a):
        y, _ = JS.linear_recurrence(*a, normalize=True)
        return jnp.sum(y * r), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                     has_aux=True)(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in xs]
    y, *state = MLSTMChunk.apply(*ts)
    assert all(s.grad_fn is not None for s in state)
    tg = torch.autograd.grad((y * torch.from_numpy(r)).sum(), ts)
    assert _scaled(y.detach().numpy(), np.asarray(jy)) <= REC_TOL
    for name, a, b in zip("qkvgi", tg, jg):
        err = _scaled(a.numpy(), np.asarray(b))
        assert err <= REC_TOL, (name, err)


def _state_inputs(B, H, dq, dv, seed):
    """An entering ScanState as numpy (loga, m, C, n) -- a real state, the
    recurrence's own final over a seeded prefix -- and cotangents for each
    of its four tensors."""
    rng = np.random.default_rng(seed)
    xs, _ = _rec_inputs(32, seed + 1, B=B, H=H, hd=dq)
    _, st = JS.linear_recurrence(*map(jnp.asarray, xs), normalize=True)
    state = [np.array(t) for t in st]
    cots = [rng.standard_normal(t.shape).astype(np.float32) for t in state]
    return state, cots


def _with_state_loss(y, st, r, rs):
    return (y * r).sum() + sum((a * b).sum() for a, b in zip(st, rs))


def test_mlstm_chunk_function_keeps_dtypes_and_takes_a_state_grad():
    """bf16 q/k/v get bf16 gradients, the f32 gates and the f32 entering
    state f32 ones; a loss that reads y and the final state gets the
    Function's gradients equal to autograd of the plain recurrence from the
    same entering state on the same (bf16-rounded) inputs, bit for bit,
    and so does the states-only form (``outputs`` False)."""
    xs, r = _rec_inputs(64, 3)
    st_np, rs_np = _state_inputs(2, 2, 16, 16, 5)
    ts = [torch.from_numpy(a) for a in xs]
    ts[:3] = [t.to(torch.bfloat16) for t in ts[:3]]
    ts = [t.requires_grad_(True) for t in ts]
    st = [torch.from_numpy(a).requires_grad_(True) for a in st_np]
    r, rs = torch.from_numpy(r), [torch.from_numpy(a) for a in rs_np]
    y, *final = MLSTMChunk.apply(*ts, True, None, True, *st)
    grads = torch.autograd.grad(_with_state_loss(y, final, r, rs), ts + st)
    assert [g.dtype for g in grads] == [t.dtype for t in ts + st]
    plain = [t.detach().float().requires_grad_(True) for t in ts]
    pst = [t.detach().clone().requires_grad_(True) for t in st]
    yp, fp = local_recurrence(*plain, init_state=ScanState(*pst))
    want = torch.autograd.grad(_with_state_loss(yp, fp, r, rs), plain + pst)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b.to(a.dtype), rtol=0, atol=0)
    # the final state alone, from the zero state
    only = MLSTMChunk.apply(*ts, True, None, False)
    assert len(only) == 4
    got = torch.autograd.grad(sum((a * b).sum() for a, b in zip(only, rs)),
                              ts, allow_unused=True)
    _, f0 = local_recurrence(*plain)
    want = torch.autograd.grad(sum((a * b).sum() for a, b in zip(f0, rs)),
                               plain, allow_unused=True)
    assert got[0] is None and want[0] is None   # q reads no state
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b.to(a.dtype), rtol=0, atol=0)


@pytest.mark.parametrize("S", [64, 256])
def test_mlstm_chunk_function_state_grads_match_jax(S):
    """From an entering state, with a loss that reads y and the final
    state: y, the final state and the gradients of q, k, v, g, i and of
    the entering state's four tensors against ``jax.grad`` of the
    reference ``linear_recurrence(init_state=...)``, at REC_TOL of each
    one's scale (S 256: two chunks)."""
    xs, r = _rec_inputs(S, S + 1)
    st_np, rs_np = _state_inputs(2, 2, 16, 16, S)

    def jloss(q, k, v, g, i, *st):
        y, fin = JS.linear_recurrence(q, k, v, g, i, normalize=True,
                                      init_state=JS.ScanState(*st))
        return (jnp.sum(y * r) + sum(jnp.sum(a * b)
                                     for a, b in zip(fin, rs_np))), (y, fin)

    (_, (jy, jfin)), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(9)), has_aux=True)(
            *map(jnp.asarray, xs + st_np))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in xs + st_np]
    y, *final = MLSTMChunk.apply(*ts[:5], True, None, True, *ts[5:])
    tg = torch.autograd.grad(_with_state_loss(
        y, final, torch.from_numpy(r), [torch.from_numpy(a) for a in rs_np]),
        ts)
    assert _scaled(y.detach().numpy(), np.asarray(jy)) <= REC_TOL
    for name, a, b in zip(("loga", "m", "C", "n"), final, jfin):
        err = _scaled(a.detach().numpy(), np.asarray(b))
        assert err <= REC_TOL, (name, err)
    names = list("qkvgi") + ["loga0", "m0", "C0", "n0"]
    for name, a, b in zip(names, tg, jg):
        err = _scaled(a.numpy(), np.asarray(b))
        assert err <= REC_TOL, (name, err)


def test_cpu_tensors_take_the_plain_recurrence_directly():
    """ops.mlstm on CPU tensors that need a gradient differentiates
    linear_recurrence itself; the Function is the card's route."""
    xs, _ = _rec_inputs(32, 4)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in xs]
    y, st = ops.mlstm(*ts)
    assert "MLSTMChunk" not in type(y.grad_fn).__name__
    assert y.requires_grad and st.C.requires_grad


# ---------------------------------------------------------------------------
# The reduced xlstm-350m: loss gradients, train steps, a Trainer run.
# ---------------------------------------------------------------------------


def _cfgs():
    return jget("xlstm-350m").reduced(), tget("xlstm-350m").reduced()


def _np(t):
    return jax.tree.map(np.asarray, t)


def _max_err(tc, t_tree, j_tree):
    want = tree.leaves(weights.from_jax(tc, _np(j_tree), device="cpu"))
    return max(float((a - b).abs().max())
               for a, b in zip(tree.leaves(t_tree), want))


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
    assert len(grads) == len(want)
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
    assert _max_err(tc, tnew["params"], jnew["params"]) <= 2 * LR


@pytest.fixture(scope="module")
def trainer_runs():
    jc, tc = _cfgs()
    jopt = joptim.sgd(SGD_LR)
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    jinit = {"params": params, "opt": jopt.init(params)}
    runs = {}
    for mode in ("weights", "psum"):
        jt = JTrainer(cfg=jc, step_fn=jit_train_step(jc, jopt, mask_agg=mode),
                      data=JTokens(jc.vocab_size, 16, 8, seed=0),
                      controller=jctl.StaticCutoffController(4, cutoff=3),
                      timer=JClusterSim(n_workers=4, n_nodes=2, seed=5),
                      n_workers=4, mask_agg=mode)
        jt.restore_or_init(lambda: jax.tree.map(jnp.copy, jinit))
        topt = toptim.sgd(SGD_LR)
        tt = TT.Trainer(step_fn=TT.make_train_step(tc, topt, mask_agg=mode),
                        data=SyntheticTokens(tc.vocab_size, 16, 8, seed=0),
                        controller=tctl.StaticCutoffController(4, cutoff=3),
                        timer=ClusterSim(n_workers=4, n_nodes=2, seed=5),
                        n_workers=4, mask_agg=mode, metrics_every=2)
        tt.restore_or_init(lambda: weights.state_from_jax(
            tc, _np(jinit), device="cpu"))
        runs[mode] = (jt.run(4), jt.state, tt.run(4), tt.state)
    return tc, runs


@pytest.mark.parametrize("mode", ["weights", "psum"])
def test_trainer_matches_jax_trainer(trainer_runs, mode):
    tc, runs = trainer_runs
    jh, js, th, ts = runs[mode]
    assert [(h["c"], h["clock"]) for h in th] \
        == [(h["c"], h["clock"]) for h in jh]
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=1e-5)
    assert _max_err(tc, ts["params"], js["params"]) < 1e-4


def test_trainer_paths_agree_for_xlstm(trainer_runs):
    """No aux: the weights and psum paths are the same update
    (tests/test_torch_train.py holds the dense family to this)."""
    tc, runs = trainer_runs
    hw, sw = runs["weights"][2], runs["weights"][3]
    hp, sp = runs["psum"][2], runs["psum"][3]
    for a, b in zip(hw, hp):
        assert abs(a["loss"] - b["loss"]) < 1e-4, (a, b)
    err = max((x - y).abs().max().item() for x, y in
              zip(tree.leaves(sw["params"]), tree.leaves(sp["params"])))
    assert err < 1e-3, err


def test_depth_two_with_the_slstm_trains():
    """chip_smoke's train_xlstm_parity layout at reduced width
    (``n_layers=2, slstm_every=2``: one mLSTM and one sLSTM block): a psum
    step gives every leaf a finite gradient, the sLSTM's recurrent
    weights among them."""
    _, tc = _cfgs()
    tc = dataclasses.replace(tc, n_layers=2, slstm_every=2)
    assert [s.kind for s in TM.layer_specs(tc)] == ["mlstm", "slstm"]
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


def test_weights_step_hands_the_optimizer_contiguous_gradients():
    """The one-process weights path hands the optimizer contiguous
    gradients: the fused Adam kernel on the card reads contiguous leaves,
    and autograd returns the sLSTM's recurrent weights' gradient permuted
    (out of its einsum); the psum and data-parallel paths copy into flat
    buffers."""
    _, tc = _cfgs()
    seen = []
    inner = toptim.adamw(LR, fused=True)

    def update(grads, state, params=None):
        seen.extend(tree.leaves(grads))
        return inner.update(grads, state, params)

    opt = toptim.Optimizer(inner.init, update)
    params = TM.init_model(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = SyntheticTokens(tc.vocab_size, 16, 4, seed=1).batch(0)
    f = np.ones(4, np.float32)
    _, m = TT.make_train_step(tc, opt, mask_agg="weights")(
        {"params": params, "opt": opt.init(params)},
        dict(batch, weights=j_example_weights(f, 4)))
    assert np.isfinite(m["loss"].item())
    assert len(seen) == len(tree.leaves(params))
    assert all(g.is_contiguous() for g in seen), [
        tuple(g.stride()) for g in seen if not g.is_contiguous()]
