"""Port vs JAX package on the CPU: the training slice.

The train loss and its gradients (through ``FlashAttention``'s plain
backward), one ``make_train_step`` on both ``mask_agg`` paths with
``grad_accum`` 1 and 2 and a fractional contribution vector, and a 5-step
``Trainer`` run on the setup of ``tests/test_system.py:169``.  Both packages
start from the same JAX-initialized state, carried with
``weights.state_from_jax``; batches are numpy.  The port's optimizer is
``adamw(fused=True)`` (p' computed directly); the JAX one adds p' - p back,
so the two may differ by a rounding of p, and Adam's first step moves each
entry by about lr times the sign of its gradient: p is held to 1e-6 where
|g| is above 1e-3 of its leaf's largest, and within 2 lr elsewhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.cluster.simulator import ChurnEvent, ChurnSim
from repro.cluster.simulator import ClusterSim as JClusterSim
from repro.configs.base import get_config as jget
from repro.core import controller as jctl
from repro.core.aggregation import example_weights as j_example_weights
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.launch.train import Trainer as JTrainer
from repro.launch.train import clock_to_loss as j_clock_to_loss
from repro.launch.train import jit_train_step
from repro.models import model as JM
from repro_torch import optim as toptim
from repro_torch import tree, weights
from repro_torch.cluster.simulator import ClusterSim
from repro_torch.configs.base import get_config as tget
from repro_torch.core import controller as tctl
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.ref import reference_attention
from repro_torch.launch import train as TT
from repro_torch.models import model as TM

torch.set_num_threads(2)

LR = 3e-3


def _cfgs(n_layers):
    return (dataclasses.replace(jget("qwen2-0.5b").reduced(),
                                n_layers=n_layers),
            dataclasses.replace(tget("qwen2-0.5b").reduced(),
                                n_layers=n_layers))


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _init(jc, tc, opt_j, opt_t):
    """The same JAX-initialized state for both packages."""
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    jstate = {"params": params, "opt": opt_j.init(params)}
    tstate = weights.state_from_jax(tc, _np_tree(jstate), device="cpu")
    return jstate, tstate


def _leaves_pair(cfg, t_tree, j_tree):
    """Matching leaf lists: the port's tree and the JAX tree carried into
    the port's layout."""
    carried = weights.from_jax(cfg, _np_tree(j_tree), device="cpu")
    return ([x.float().numpy() for x in tree.leaves(t_tree)],
            [x.float().numpy() for x in tree.leaves(carried)])


def _check_params(cfg, tp, jp, jg, lr):
    """p within 1e-6 where |g| > 1e-3 max|g| of its leaf, within 2 lr
    elsewhere (see the module docstring)."""
    got, want = _leaves_pair(cfg, tp, jp)
    _, grads = _leaves_pair(cfg, tp, jg)
    for a, b, g in zip(got, want, grads):
        sure = np.abs(g) > 1e-3 * np.abs(g).max()
        d = np.abs(a - b)
        if sure.any():
            assert d[sure].max() <= 1e-6, d[sure].max()
        assert d.max() <= 2 * lr, d.max()


# ---------------------------------------------------------------------------
# (e) train_loss and its gradients.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_train_loss_and_grads_match_jax(weighted):
    jc, tc = _cfgs(2)
    params = JM.init_model(jc, jax.random.PRNGKey(1))
    batch = SyntheticTokens(jc.vocab_size, 16, 4, seed=2).batch(0)
    if weighted:
        batch["weights"] = np.asarray([1.0, 0.0, 0.5, 1.0], np.float32)

    def jloss(p):
        return JM.train_loss(jc, p, {k: jnp.asarray(v)
                                     for k, v in batch.items()})[0]

    jl, jg = jax.value_and_grad(jloss)(params)
    tp = weights.from_jax(tc, _np_tree(params), device="cpu")
    flat = [x.requires_grad_(True) for x in tree.leaves(tp)]
    tl, metrics = TM.train_loss(tc, tree.unflatten(tp, flat),
                                {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
    grads = torch.autograd.grad(tl, flat)
    assert metrics["aux"].item() == 0.0
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=1e-6)
    got, want = _leaves_pair(tc, tree.unflatten(tp, list(grads)), jg)
    assert len(got) == len(want) == 2 * 12 + 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("window", [0, 5])
def test_flash_attention_function_backward_on_cpu(window):
    """FlashAttention's forward is the plain version on the CPU, and its
    backward is the plain version's gradient, exactly."""
    rng = np.random.default_rng(window)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 12, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16)))
    r = torch.tensor(rng.standard_normal((2, 12, 4, 16)).astype(np.float32))
    outs = []
    for fn in (lambda a, b, c: FlashAttention.apply(a, b, c, True, window),
               lambda a, b, c: reference_attention(a, b, c, causal=True,
                                                   window=window)):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*qkv)
        outs.append((out.detach(),
                     torch.autograd.grad((out * r).sum(), qkv)))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_forward_train_mode_shapes():
    _, tc = _cfgs(2)
    tp = TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((2, 7), dtype=torch.int64),
             "positions": torch.arange(7).expand(2, 7)}
    logits, caches, aux = TM.forward(tc, tp, batch, mode="train")
    assert logits.shape == (2, 7, tc.vocab_size) and caches is None
    assert aux.shape == () and aux.item() == 0.0
    with pytest.raises(ValueError):
        TM.forward(tc, tp, batch, mode="score")


# ---------------------------------------------------------------------------
# (f) One train step against JAX's make_train_step.
# ---------------------------------------------------------------------------


CONTRIB = {"bits": [1.0, 0.0, 1.0, 1.0],
           # with grad_accum 2: round(0.5) = 0 and round(1.5) = 2 (half to
           # even), round(1.0) = 1
           "fractional": [1.0, 0.25, 0.75, 0.5]}


@pytest.mark.parametrize("contrib", sorted(CONTRIB))
@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("mask_agg", ["weights", "psum"])
def test_train_step_matches_jax(mask_agg, grad_accum, contrib):
    jc, tc = _cfgs(2)
    jopt, topt = joptim.adamw(LR), toptim.adamw(LR, fused=True)
    jstate, tstate = _init(jc, tc, jopt, topt)
    f = np.asarray(CONTRIB[contrib], np.float32)
    batch = SyntheticTokens(jc.vocab_size, 16, 8, seed=0).batch(0)
    if mask_agg == "psum":
        jb, tb = dict(batch, mask=jnp.asarray(f)), dict(batch, mask=f)
    else:
        w = j_example_weights(f, 8)
        jb, tb = dict(batch, weights=w), dict(batch, weights=w)
    jstep = jit_train_step(jc, jopt, donate=False, mask_agg=mask_agg,
                           grad_accum=grad_accum)
    tstep = TT.make_train_step(tc, topt, mask_agg=mask_agg,
                               grad_accum=grad_accum)
    jnew, jm = jstep(jstate, jb)
    tnew, tm = tstep(tstate, tb)
    for key in ("loss", "ce", "aux", "gnorm"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    assert tnew["opt"]["step"] == int(jnew["opt"]["step"]) == 1
    assert tnew["params"] is tstate["params"]   # updated in place
    for key, atol in (("m", 1e-6), ("v", 1e-7)):
        got, want = _leaves_pair(tc, tnew["opt"][key], jnew["opt"][key])
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=atol, rtol=1e-4,
                                       err_msg=key)
    # one step from zero moments: m = (1 - b1) g
    _check_params(tc, tnew["params"], jnew["params"], jnew["opt"]["m"], LR)


def test_train_step_refuses_unported_options():
    """Stale reuse (psum) and compression are ported: both steps build and
    run; stale reuse on the weights path and an unknown mask_agg still
    raise ValueError, as the JAX step does."""
    _, tc = _cfgs(2)
    opt = toptim.adamw(LR)
    params = TM.init_model(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = SyntheticTokens(tc.vocab_size, 16, 4, seed=0).batch(0)
    mask = np.asarray([1.0, 0.0], np.float32)
    step = TT.make_train_step(tc, opt, mask_agg="psum", stale_reuse=True)
    stale_g = tree.map(torch.zeros_like, params)
    state, metrics = step({"params": params, "opt": opt.init(params)},
                          dict(batch, mask=mask, stale_g=stale_g,
                               stale_w=torch.tensor(0.0)))
    assert float(metrics["stale"][1]) == 1.0
    step = TT.make_train_step(tc, opt, compress_pod_grads=True)
    state, _ = step(state, batch)
    assert set(state) == {"params", "opt", "ef"}
    with pytest.raises(ValueError, match="psum"):
        TT.make_train_step(tc, opt, mask_agg="weights", stale_reuse=True)
    with pytest.raises(ValueError):
        TT.make_train_step(tc, opt, mask_agg="ring")


# ---------------------------------------------------------------------------
# (g) The Trainer against the JAX Trainer (tests/test_system.py:169 setup).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trainer_runs():
    jc, tc = _cfgs(4)
    jopt = joptim.adamw(LR)
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    jinit = {"params": params, "opt": jopt.init(params)}
    runs = {}
    for mode in ("weights", "psum"):
        jt = JTrainer(cfg=jc, step_fn=jit_train_step(jc, jopt, mask_agg=mode),
                      data=JTokens(jc.vocab_size, 16, 8, seed=0),
                      controller=jctl.StaticCutoffController(8, cutoff=6),
                      timer=JClusterSim(n_workers=8, n_nodes=2, seed=5),
                      n_workers=8, mask_agg=mode)
        jt.restore_or_init(lambda: jax.tree.map(jnp.copy, jinit))
        topt = toptim.adamw(LR, fused=True)
        tt = TT.Trainer(step_fn=TT.make_train_step(tc, topt, mask_agg=mode),
                        data=SyntheticTokens(tc.vocab_size, 16, 8, seed=0),
                        controller=tctl.StaticCutoffController(8, cutoff=6),
                        timer=ClusterSim(n_workers=8, n_nodes=2, seed=5),
                        n_workers=8, mask_agg=mode, metrics_every=2)
        tt.restore_or_init(lambda: weights.state_from_jax(
            tc, _np_tree(jinit), device="cpu"))
        runs[mode] = (jt.run(5), jt.state, tt.run(5), tt.state)
    return tc, runs


@pytest.mark.parametrize("mode", ["weights", "psum"])
def test_trainer_matches_jax_trainer(trainer_runs, mode):
    """Equal cutoff and clock every step; losses within 1e-5; final params
    within 1e-3, the bar the JAX package holds its own two paths to over
    these 5 steps (tests/test_system.py)."""
    tc, runs = trainer_runs
    jh, js, th, ts = runs[mode]
    assert [(h["c"], h["n"], h["clock"]) for h in th] \
        == [(h["c"], h["n"], h["clock"]) for h in jh]
    assert all(h["c"] == 6 for h in th)
    assert all(isinstance(h["loss"], float) for h in th)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=1e-5)
    got, want = _leaves_pair(tc, ts["params"], js["params"])
    err = max(np.abs(a - b).max() for a, b in zip(got, want))
    assert err < 1e-3, err
    assert ts["opt"]["step"] == 5


def test_trainer_weights_and_psum_paths_agree(trainer_runs):
    tc, runs = trainer_runs
    hw, sw = runs["weights"][2], runs["weights"][3]
    hp, sp = runs["psum"][2], runs["psum"][3]
    for a, b in zip(hw, hp):
        assert abs(a["loss"] - b["loss"]) < 1e-4, (a, b)
    err = max((x - y).abs().max().item() for x, y in
              zip(tree.leaves(sw["params"]), tree.leaves(sp["params"])))
    assert err < 1e-3, err


def test_clock_to_loss_matches_jax(trainer_runs):
    _, runs = trainer_runs
    hist = runs["psum"][2]
    losses = sorted(h["loss"] for h in hist)
    for target in (losses[0] - 1.0, losses[2], losses[-1] + 1.0):
        for window in (1, 3):
            assert TT.clock_to_loss(hist, target, window) \
                == j_clock_to_loss(hist, target, window)


def test_trainer_follows_a_resizing_timer():
    """A width-changing timer resizes the controller and the psum step's
    worker buffer: 8 workers, then 4 from step 2, then 8 again."""
    _, tc = _cfgs(2)
    opt = toptim.adamw(LR, fused=True)
    params = TM.init_model(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    timer = ChurnSim(JClusterSim(n_workers=8, n_nodes=2, seed=1),
                     [ChurnEvent(step=2, resize=4),
                      ChurnEvent(step=4, resize=8)])
    tr = TT.Trainer(step_fn=TT.make_train_step(tc, opt, mask_agg="psum"),
                    data=SyntheticTokens(tc.vocab_size, 8, 8, seed=0),
                    controller=tctl.FirstKController(8, backup=1),
                    timer=timer, n_workers=8, mask_agg="psum")
    tr.restore_or_init(lambda: {"params": params, "opt": opt.init(params)})
    hist = tr.run(6)
    assert [(h["n"], h["c"]) for h in hist] == [(8, 7), (8, 7), (4, 3),
                                                (4, 3), (8, 7), (8, 7)]
    assert np.all(np.isfinite([h["loss"] for h in hist]))
    np.testing.assert_array_equal(tr.members, np.arange(8))


def test_trainer_refuses_unported_features():
    """Nothing the reference's Trainer takes is refused any more: an
    ``obs`` run is accepted (``tests/test_torch_obs.py`` drives it),
    checkpoints are ported (a ``ckpt_dir`` with no checkpoint in it inits
    cold), and a controller with ``stale_decay`` runs, refused only by
    the weights path."""
    from repro_torch.obs import ObsRun

    kw = dict(step_fn=None, data=None, controller=tctl.FullSyncController(8))
    obs = ObsRun()
    assert TT.Trainer(obs=obs, name="j", **kw).obs is obs
    tr = TT.Trainer(ckpt_dir="no-such-dir", **kw)
    tr.restore_or_init(lambda: {"cold": True})
    assert tr.state == {"cold": True} and tr.step == 0

    class Stale(tctl.FullSyncController):
        stale_decay = 0.5

    _, tc = _cfgs(2)
    opt = toptim.adamw(LR)
    params = TM.init_model(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    tr = TT.Trainer(step_fn=TT.make_train_step(tc, opt),
                    data=SyntheticTokens(tc.vocab_size, 8, 8, seed=0),
                    controller=Stale(8))
    tr.restore_or_init(lambda: {"params": params, "opt": opt.init(params)})
    with pytest.raises(ValueError, match="psum"):
        tr.run(1)


# ---------------------------------------------------------------------------
# The baseline controllers and the state carry.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("FullSyncController", (8,)), ("StaticCutoffController", (8,)),
    ("StaticCutoffController", (8, 6)), ("FirstKController", (8, 2)),
    ("FirstKController", (32,))])
def test_baseline_controllers_match_jax(name, args):
    j, t = getattr(jctl, name)(*args), getattr(tctl, name)(*args)
    times = JClusterSim(n_workers=8, seed=2).run(3)
    seq = []
    for width in (8, 5, 8, 3):
        for row in times:
            assert t.predict_cutoff() == j.predict_cutoff()
            j.observe(row, np.ones(len(row), bool))
            t.observe(row, np.ones(len(row), bool))
        seq.append(t.predict_cutoff())
        j.resize(width)
        t.resize(width)
        assert t.predict_cutoff() == j.predict_cutoff()
    assert all(1 <= c <= 32 for c in seq)


def test_state_from_jax_carries_moments_and_step():
    jc, tc = _cfgs(2)
    opt = joptim.adamw(LR)
    params = JM.init_model(jc, jax.random.PRNGKey(4))
    state = {"params": params, "opt": opt.init(params)}
    grads = jax.tree.map(lambda p: 0.1 * jnp.ones_like(p), params)
    _, state["opt"] = opt.update(grads, state["opt"], params)
    carried = weights.state_from_jax(tc, _np_tree(state), device="cpu")
    assert carried["opt"]["step"] == 1 and isinstance(
        carried["opt"]["step"], int)
    for key in ("m", "v"):
        got, want = _leaves_pair(tc, carried["opt"][key], state["opt"][key])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    got, want = _leaves_pair(tc, carried["params"], params)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
