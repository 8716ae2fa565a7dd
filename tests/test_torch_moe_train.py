"""Port MoE family's training vs the JAX package's on the CPU.

deepseek-moe-16b and phi3.5-moe-42b-a6.6b at ``get_config(...).reduced()``
with drops at capacity on (factor 0.25): ``train_loss`` and its
gradients, one ``make_train_step`` on each ``mask_agg`` path with a worker
dropped, the two paths against each other (they differ by the aux term
only, ``src/repro/launch/train.py:134-141``), grad accumulation, and a
4-step ``Trainer`` run against the JAX ``Trainer``.  The helpers and
tolerances are tests/test_torch_moe.py's; the train-step bars are
tests/test_torch_train.py's (losses 1e-5, m 1e-6, p within 2 lr after
Adam's first step, 1e-3 after a Trainer run).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.cluster.simulator import ClusterSim as JClusterSim
from repro.core import controller as jctl
from repro.core.aggregation import example_weights as j_example_weights
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.launch.train import Trainer as JTrainer
from repro.launch.train import jit_train_step
from repro.models import model as JM
from repro_torch import optim as toptim
from repro_torch import tree, weights
from repro_torch.cluster.simulator import ClusterSim
from repro_torch.core import controller as tctl
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as TT
from repro_torch.models import model as TM
from test_torch_moe import NAMES, _cfgs, _jinit, _model, _np

torch.set_num_threads(2)

LR = 3e-3


@pytest.mark.parametrize("name", NAMES)
def test_train_loss_and_grads_match_jax(name):
    jc, tc = _cfgs(name, 0.25)
    jp, tp = _model(jc, tc)
    batch = SyntheticTokens(jc.vocab_size, 16, 4, seed=2).batch(0)

    def jloss(p):
        return JM.train_loss(jc, p, {k: jnp.asarray(v)
                                     for k, v in batch.items()})

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    flat = [x.requires_grad_(True) for x in tree.leaves(tp)]
    tl, tm = TM.train_loss(tc, tree.unflatten(tp, flat),
                           {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(tl, flat)
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(tm["aux"].item(), float(jm["aux"]),
                               atol=1e-5, rtol=1e-6)
    assert tm["aux"].item() > 0.0
    want = tree.leaves(weights.from_jax(tc, _np(jg), device="cpu"))
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)


def _init(jc, tc, opt_j):
    params = _jinit(jc, 0)
    jstate = {"params": params, "opt": opt_j.init(params)}
    return jstate, weights.state_from_jax(tc, _np(jstate), device="cpu")


def _max_err(tc, t_tree, j_tree):
    want = tree.leaves(weights.from_jax(tc, _np(j_tree), device="cpu"))
    return max(float((a - b).abs().max())
               for a, b in zip(tree.leaves(t_tree), want))


@pytest.mark.parametrize("mask_agg", ["weights", "psum"])
@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(name, mask_agg):
    """One step with worker 1 of 4 dropped, drops at capacity on: the psum
    path routes each worker's B/W rows at their own capacity and takes
    each worker's own aux, the weights path routes the whole batch, as
    the reference's two paths do."""
    jc, tc = _cfgs(name, 0.25)
    jopt, topt = joptim.adamw(LR), toptim.adamw(LR, fused=True)
    jstate, tstate = _init(jc, tc, jopt)
    f = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    batch = SyntheticTokens(jc.vocab_size, 16, 8, seed=0).batch(0)
    if mask_agg == "psum":
        jb, tb = dict(batch, mask=jnp.asarray(f)), dict(batch, mask=f)
    else:
        w = j_example_weights(f, 8)
        jb, tb = dict(batch, weights=w), dict(batch, weights=w)
    jnew, jm = jit_train_step(jc, jopt, donate=False,
                              mask_agg=mask_agg)(jstate, jb)
    tnew, tm = TT.make_train_step(tc, topt, mask_agg=mask_agg)(tstate, tb)
    for key in ("loss", "ce", "aux", "gnorm"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    assert tm["aux"].item() > 0.0
    assert _max_err(tc, tnew["opt"]["m"], jnew["opt"]["m"]) <= 1e-6
    # Adam's first step: p moves by ~lr sign(g) (tests/test_torch_train.py)
    assert _max_err(tc, tnew["params"], jnew["params"]) <= 2 * LR


def test_mask_agg_paths_differ_by_the_aux_term_only():
    """Drop-free (factor 8), worker 1 of 4 dropped: both paths give the
    same ce; the losses differ by aux_coef times the difference of their
    aux (the whole batch's against the kept workers' mean,
    src/repro/launch/train.py:134-141), and with aux_coef 0 the two
    gradients agree (Adam's m = (1 - b1) g after one step)."""
    jc, tc = _cfgs("deepseek-moe-16b", 8.0)
    f = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    batch = SyntheticTokens(tc.vocab_size, 16, 8, seed=1).batch(0)
    for coef in (0.01, 0.0):
        out = {}
        for mode in ("weights", "psum"):
            opt = toptim.adamw(LR, fused=True)
            _, state = _init(jc, tc, joptim.adamw(LR))
            b = (dict(batch, mask=f) if mode == "psum"
                 else dict(batch, weights=j_example_weights(f, 8)))
            out[mode] = TT.make_train_step(tc, opt, mask_agg=mode,
                                           aux_coef=coef)(state, b)
        (sw, mw), (sp, mp) = out["weights"], out["psum"]
        np.testing.assert_allclose(mw["ce"].item(), mp["ce"].item(),
                                   atol=1e-6, rtol=1e-6)
        gap = mw["loss"].item() - mp["loss"].item()
        np.testing.assert_allclose(
            gap, coef * (mw["aux"].item() - mp["aux"].item()), atol=1e-6)
        if coef:
            assert abs(mw["aux"].item() - mp["aux"].item()) > 1e-4
        else:
            err = max(float((a - b).abs().max()) for a, b in
                      zip(tree.leaves(sw["opt"]["m"]),
                          tree.leaves(sp["opt"]["m"])))
            assert err <= 1e-6, err


def test_grad_accum_takes_each_microbatch_aux():
    """grad_accum 2 against the reference's same step: each microbatch
    routes and balances on its own (tests/test_smoke_archs.py:65)."""
    jc, tc = _cfgs("deepseek-moe-16b", 0.25)
    jopt, topt = joptim.adamw(LR), toptim.adamw(LR, fused=True)
    jstate, tstate = _init(jc, tc, jopt)
    batch = SyntheticTokens(jc.vocab_size, 16, 8, seed=3).batch(0)
    jnew, jm = jit_train_step(jc, jopt, donate=False, grad_accum=2)(
        jstate, batch)
    tnew, tm = TT.make_train_step(tc, topt, grad_accum=2)(tstate, batch)
    for key in ("loss", "aux"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    assert _max_err(tc, tnew["opt"]["m"], jnew["opt"]["m"]) <= 1e-6


@pytest.mark.parametrize("mode", ["weights", "psum"])
@pytest.mark.parametrize("name", NAMES)
def test_trainer_matches_jax_trainer(name, mode):
    """4 steps at 4 workers, cutoff 3, drops on: equal cutoffs and clocks,
    losses within 1e-5, params within 1e-3 (the dense family's bar,
    tests/test_torch_train.py)."""
    jc, tc = _cfgs(name, 0.25)
    jopt = joptim.adamw(LR)
    params = _jinit(jc, 0)
    jinit = {"params": params, "opt": jopt.init(params)}
    jt = JTrainer(cfg=jc, step_fn=jit_train_step(jc, jopt, mask_agg=mode),
                  data=JTokens(jc.vocab_size, 16, 8, seed=0),
                  controller=jctl.StaticCutoffController(4, cutoff=3),
                  timer=JClusterSim(n_workers=4, n_nodes=2, seed=5),
                  n_workers=4, mask_agg=mode)
    jt.restore_or_init(lambda: jax.tree.map(jnp.copy, jinit))
    topt = toptim.adamw(LR, fused=True)
    tt = TT.Trainer(step_fn=TT.make_train_step(tc, topt, mask_agg=mode),
                    data=SyntheticTokens(tc.vocab_size, 16, 8, seed=0),
                    controller=tctl.StaticCutoffController(4, cutoff=3),
                    timer=ClusterSim(n_workers=4, n_nodes=2, seed=5),
                    n_workers=4, mask_agg=mode, metrics_every=2)
    tt.restore_or_init(lambda: weights.state_from_jax(tc, _np(jinit),
                                                      device="cpu"))
    jh, th = jt.run(4), tt.run(4)
    assert [(h["c"], h["clock"]) for h in th] \
        == [(h["c"], h["clock"]) for h in jh]
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=1e-5)
    assert _max_err(tc, tt.state["params"], jt.state["params"]) < 1e-3
