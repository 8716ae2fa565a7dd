"""Port norms, MLPs and RoPE vs ``repro.models.layers`` on the CPU (f32).

Inputs and weights are drawn with numpy from a seed and handed to both.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models import layers as JL
from repro_torch.configs.base import get_config as tget
from repro_torch.models import layers as TL

torch.set_num_threads(2)

ATOL = 1e-5


def _cfgs(name, **changes):
    return (dataclasses.replace(jget(name).reduced(), **changes),
            dataclasses.replace(tget(name).reduced(), **changes))


def _both(tree):
    """numpy tree -> (jax tree, torch tree)."""
    j = {k: jnp.asarray(v) for k, v in tree.items()}
    t = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    return j, t


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    jc, tc = _cfgs("qwen2-0.5b", norm=norm)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3.0
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    jp, tp = _both(p)
    want = JL.apply_norm(jc, jp, jnp.asarray(x))
    got = TL.apply_norm(tc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_rms_head_norm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32)
    want = JL.rms_head_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    got = TL.rms_head_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("mlp,bias", [("swiglu", False), ("geglu", False),
                                      ("gelu", True)])
def test_apply_mlp(mlp, bias):
    jc, tc = _cfgs("qwen2-0.5b", mlp=mlp, mlp_bias=bias)
    rng = np.random.default_rng(2)
    d, f = 64, 128
    p = {"w_up": rng.standard_normal((d, f)).astype(np.float32) / 8,
         "w_down": rng.standard_normal((f, d)).astype(np.float32) / 11}
    if mlp != "gelu":
        p["w_gate"] = rng.standard_normal((d, f)).astype(np.float32) / 8
    if bias:
        p["b_up"] = rng.standard_normal(f).astype(np.float32)
        p["b_down"] = rng.standard_normal(d).astype(np.float32)
    jp, tp = _both(p)
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    want = JL.apply_mlp(jc, jp, jnp.asarray(x))
    got = TL.apply_mlp(tc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name,partial", [("qwen2-0.5b", 1.0),
                                          ("stablelm-3b", 0.25)])
def test_apply_rope(name, partial):
    jc, tc = _cfgs(name, partial_rotary=partial)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 12)[None], (2, 9)).astype(np.int32)
    jq, jk = JL.apply_rope(jc, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(pos))
    tq, tk = TL.apply_rope(tc, torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    if partial < 1.0:   # the unrotated tail passes through untouched
        rot = int(16 * partial)
        np.testing.assert_array_equal(tq[..., rot:].numpy(), q[..., rot:])

