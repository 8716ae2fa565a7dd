"""Port attention vs the JAX package, on the CPU.

The port's flash-attention wrapper takes its plain version for CPU
tensors; it is held to the Pallas ``flash_attention`` (interpret mode) for
Sq == Sk and to the JAX oracle ``reference_attention`` for Sq < Sk (where
the Pallas kernel places query rows differently).  The port's
``attn_core`` / ``attn_decode`` are held to the JAX ones, including the
in-place cache write at ``pos``.  f32 throughout; atol 2e-5 as in
tests/test_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as JA
from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import reference_attention
from repro_torch.models import attention as TA

torch.set_num_threads(2)

ATOL = 2e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, Sq, H, hd), _rand(rng, B, Sk, KV, hd),
            _rand(rng, B, Sk, KV, hd))


@pytest.mark.parametrize("causal,window,H,KV", [
    (True, 0, 4, 2), (True, 32, 4, 2), (False, 0, 4, 1), (True, 0, 6, 2)])
def test_plain_flash_matches_pallas_interpret(causal, window, H, KV):
    q, k, v = _qkv(0, 1, 128, 128, H, KV, 32)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("Sq,Sk,window", [(16, 48, 0), (1, 37, 0),
                                          (5, 29, 8), (1, 20, 6)])
def test_plain_flash_suffix_rule_matches_oracle(Sq, Sk, window):
    q, k, v = _qkv(1, 2, Sq, Sk, 6, 2, 16)
    want = jref.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    window=window)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cpu_path_launches_no_kernel():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 8, 8, 2, 1, 16))
    before = build.LAUNCHES["flash_attention"]
    ops.attention(q, k, v)
    assert build.LAUNCHES["flash_attention"] == before


def test_wrapper_rejects_bad_shapes_and_devices():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 8, 8, 3, 2, 16))
    with pytest.raises(ValueError, match="group"):
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="match"):
        flash_attention(q, k[..., :8], v[..., :8])
    # neither CPU nor CUDA: no path, and never a quiet move to the CPU
    with pytest.raises(ValueError, match="no path"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 5, 0.0), (False, 0, 0.0), (True, 0, 20.0)])
def test_attn_core_matches_jax(causal, window, softcap):
    q, k, v = _qkv(4, 2, 12, 12, 4, 2, 16)
    qpos = np.broadcast_to(np.arange(12)[None], (2, 12)).astype(np.int32)
    kpos = np.arange(12, dtype=np.int32)
    want = JA.attn_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(qpos), jnp.asarray(kpos), causal=causal,
                        window=window, softcap=softcap)
    got = TA.attn_core(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(qpos.copy()),
                       torch.from_numpy(kpos), causal=causal, window=window,
                       softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (4, 0.0), (0, 20.0)])
def test_attn_decode_matches_jax_in_place(window, softcap):
    rng = np.random.default_rng(5)
    B, L, H, KV, hd, pos = 2, 12, 4, 2, 16, 7
    q = _rand(rng, B, 1, H, hd)
    kn, vn = _rand(rng, B, 1, KV, hd), _rand(rng, B, 1, KV, hd)
    ck = _rand(rng, B, L, KV, hd)
    cv = _rand(rng, B, L, KV, hd)
    ck[:, pos:] = 0.0   # slots not yet written
    cv[:, pos:] = 0.0
    y_j, ck_j, cv_j = JA.attn_decode(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(ck),
        jnp.asarray(cv), pos, window=window, softcap=softcap)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    y_t, ck_t, cv_t = TA.attn_decode(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        tk, tv, pos, window=window, softcap=softcap)
    assert ck_t is tk and cv_t is tv          # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(ck_j))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(cv_j))
    np.testing.assert_array_equal(tk[:, pos].numpy(), kn[:, 0])
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)


def test_plain_reference_matches_jax_oracle_bf16():
    """bf16 inputs: both oracles compute in f32 and round once at the end."""
    q, k, v = _qkv(6, 2, 24, 24, 4, 2, 16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    want = jref.reference_attention(
        *(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
          for t in (tq, tk, tv)), causal=True, window=0)
    got = reference_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), atol=3e-2)
