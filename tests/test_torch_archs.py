"""Every registered arch in the port vs the JAX package on the CPU.

One test a property, parametrized over the ten archs of
``configs.base.all_archs()`` (the reference's ``tests/test_smoke_archs.py``
runs the same set):

* forward and three AdamW steps at the reference smoke test's size (the
  reduced config, B 2, S 16, MoE at a capacity that drops nothing), on
  the same numpy batch and the JAX init carried by ``weights.from_jax``:
  train logits at 1e-4, each step's loss at 1e-4 of its value, the
  parameters after the first step within 2 lr of JAX's, and a loss that
  falls over the three steps, as the smoke test asks;
* the parameter tree at **full** size: every leaf's path, shape and
  dtype equal to ``jax.eval_shape`` of the reference's ``init_model``
  (unstacked from its segments), the port's tree built on the meta
  device, so neither side allocates;
* ``cache_structs`` at full size against the reference's, unstacked.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs.base import all_archs
from repro.configs.base import get_config as jget
from repro.launch.train import make_train_step as j_make_train_step
from repro.models import model as JM
from repro_torch import optim as toptim
from repro_torch import tree, weights
from repro_torch.configs.base import all_archs as t_all_archs
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import train as TT
from repro_torch.models import model as TM

torch.set_num_threads(2)

ARCHS = sorted(all_archs())
ATOL = 1e-4
LOSS_RTOL = 1e-4
LR = 5e-3
B, S = 2, 16


def test_the_port_registers_every_arch():
    assert sorted(t_all_archs()) == ARCHS and len(ARCHS) == 10


def _reduced(name):
    """conftest.reduced_cfg for both packages: MoE at a capacity factor of
    n_experts, so no token is dropped."""
    jc, tc = jget(name).reduced(), tget(name).reduced()
    if jc.n_experts:
        jc = dataclasses.replace(jc, moe_capacity_factor=float(jc.n_experts))
        tc = dataclasses.replace(tc, moe_capacity_factor=float(tc.n_experts))
    return jc, tc


def _batch(cfg, seed):
    """conftest.tiny_batch's entries, drawn with numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32),
             "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                          (B, S)).copy()}
    if cfg.frontend == "vision_patches":
        batch["patch_embeds"] = np.zeros((B, S, cfg.d_model), np.float32)
        batch["image_mask"] = np.zeros((B, S), bool)
        batch["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, B, S)).copy()
    if cfg.is_encoder_decoder:
        batch["frames"] = np.full((B, cfg.encoder_seq_len, cfg.d_model),
                                  0.01, np.float32)
    return batch


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_three_steps_match_jax(name):
    jc, tc = _reduced(name)
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    batch = _batch(jc, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl = np.asarray(jax.jit(lambda p, b: JM.forward(jc, p, b,
                                                    mode="train")[0])(
        params, jb))
    tp = weights.from_jax(tc, jax.tree.map(np.asarray, params),
                          device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tl = TM.forward(tc, tp, dict(tb, tokens=tb["tokens"].long()),
                    mode="train")[0]
    assert tl.shape == (B, S, tc.vocab_size)
    assert bool(torch.isfinite(tl).all())
    np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL)

    jopt, topt = joptim.adamw(LR), toptim.adamw(LR, fused=True)
    jstate = {"params": params, "opt": jopt.init(params)}
    tstate = weights.state_from_jax(tc, jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    jstep = jax.jit(j_make_train_step(jc, jopt))
    tstep = TT.make_train_step(tc, topt)
    jlosses, tlosses = [], []
    for i in range(3):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, batch)
        jlosses.append(float(jm["loss"]))
        tlosses.append(tm["loss"].item())
        assert np.isfinite(tlosses[-1]) and np.isfinite(tm["gnorm"].item())
        if i == 0:
            want = tree.leaves(weights.from_jax(
                tc, jax.tree.map(np.asarray, jstate["params"]),
                device="cpu"))
            got = tree.leaves(tstate["params"])
            assert len(got) == len(want)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            assert err <= 2 * LR
            assert any(bool((a != b).any()) for a, b in
                       zip(got, tree.leaves(tp)))   # the params moved
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert tlosses[-1] < tlosses[0]


def _walk(node, pre=""):
    """{path: (shape, dtype name)} over dicts, lists and (named) tuples;
    a leaf is a jax ShapeDtypeStruct or a torch tensor."""
    if isinstance(node, dict):
        out = {}
        for k in sorted(node):
            out.update(_walk(node[k], f"{pre}/{k}"))
        return out
    if isinstance(node, (list, tuple)):
        out = {}
        for i, t in enumerate(node):
            out.update(_walk(t, f"{pre}/{i}"))
        return out
    dt = node.dtype
    name = str(dt).replace("torch.", "") if isinstance(
        dt, torch.dtype) else jnp.dtype(dt).name
    return {pre: (tuple(node.shape), name)}


def _unstack(specs, segments):
    """A reference segments list of abstract leaves -> one entry a layer,
    each leaf's leading repeats axis dropped."""
    out = []
    for seg, sp in zip(TM.build_segments(specs), segments):
        for r in range(seg.repeats):
            for c in sp:
                out.append(jax.tree.map(
                    lambda s: jax.ShapeDtypeStruct(
                        s.shape[1:] if seg.repeats > 1 else s.shape,
                        s.dtype), c))
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_full_size_tree_matches_jax_eval_shape(name):
    jc, tc = jget(name), tget(name)
    js = jax.eval_shape(lambda: JM.init_model(jc, jax.random.PRNGKey(0)))
    want = {k: v for k, v in js.items() if k not in ("segments", "encoder")}
    want["layers"] = _unstack(TM.layer_specs(tc), js["segments"])
    if "encoder" in js:
        want["encoder"] = dict(
            {k: v for k, v in js["encoder"].items() if k != "segments"},
            layers=_unstack(TM.encoder_layer_specs(tc),
                            js["encoder"]["segments"]))
    got = TM.init_model(tc, torch.Generator(), device="meta")
    assert all(x.device.type == "meta" for x in tree.leaves(got))
    assert _walk(got) == _walk(want)


@pytest.mark.parametrize("name", ARCHS)
def test_cache_structs_match_jax(name):
    jc, tc = jget(name), tget(name)
    want = _unstack(TM.layer_specs(tc), JM.cache_structs(jc, 2, 64))
    got = TM.cache_structs(tc, 2, 64)
    assert len(got) == tc.n_layers
    assert _walk(got) == _walk(want)
