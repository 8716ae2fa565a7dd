"""``decode_step`` with the cache length on the device, for every
registered arch at ``.reduced()``, against the JAX package on the CPU.

JAX's params are carried by ``weights.from_jax``; both sides prefill the
same numpy batch (frames for whisper, (3, B, S) positions for M-RoPE),
pad the caches, and take three decode steps, the port's at a 0-d ``pos``
tensor (JAX's traced ``jnp.int32(S + t)``): f32 logits within 1e-5,
argmax ids equal, and bit-equal to the same step given a host int (which
becomes the same tensor).  The plain length-masked attention, the split
plan and the engine are held in test_torch_decode_graph.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import all_archs
from repro.configs.base import get_config as jget
from repro.models import model as JM
from repro_torch import weights
from repro_torch.configs.base import get_config as tget
from repro_torch.models import attention as TA
from repro_torch.models import model as TM

torch.set_num_threads(2)

ATOL = 1e-5
ARCHS = sorted(all_archs())
B, S, N_DECODE = 2, 6, 3


def _reduced(name):
    jc, tc = jget(name).reduced(), tget(name).reduced()
    if jc.n_experts:   # a capacity that drops nothing at decode's B tokens
        jc = dataclasses.replace(jc, moe_capacity_factor=float(jc.n_experts))
        tc = dataclasses.replace(tc, moe_capacity_factor=float(tc.n_experts))
    return jc, tc


def _prefill_batch(cfg, rng):
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    batch = {"tokens": tokens,
             "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                          (B, S)).copy()}
    if cfg.mrope_sections:
        batch["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, B, S)).copy()
    if cfg.is_encoder_decoder:
        batch["frames"] = (0.1 * rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    return batch


def _torch_batch(batch):
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    out["positions"] = out["positions"].long()
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_device_pos_matches_jax(name):
    jc, tc = _reduced(name)
    jp = JM.init_model(jc, jax.random.PRNGKey(0))
    tp = weights.from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    batch = _prefill_batch(jc, np.random.default_rng(1))
    jl, jcache = jax.jit(lambda p, b: JM.prefill(jc, p, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        tl, tcache = TM.prefill(tc, tp, _torch_batch(batch))
    jcache = JM.pad_caches(jcache, S + N_DECODE)
    tcache = TM.pad_caches(tcache, S + N_DECODE)
    host = TM.pad_caches(tcache, S + N_DECODE)      # a copy: the host path
    jdec = jax.jit(lambda p, t, pos, c: JM.decode_step(jc, p, t, pos, c))
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    for t in range(N_DECODE):
        jl, jcache = jdec(jp, jnp.asarray(tok), jnp.int32(S + t), jcache)
        ttok = torch.as_tensor(tok, dtype=torch.int64)
        with torch.inference_mode():
            tl, tcache = TM.decode_step(tc, tp, ttok, torch.tensor(S + t),
                                        tcache)
            hl, host = TM.decode_step(tc, tp, ttok, S + t, host)
        assert tl.shape == (B, 1, tc.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        assert torch.equal(tl, hl)      # a host int becomes the same tensor
        want = np.argmax(np.asarray(jl)[:, 0], axis=-1)
        np.testing.assert_array_equal(tl[:, 0].argmax(-1).numpy(), want)
        tok = want.astype(np.int32)[:, None]


def test_decode_pos_is_checked():
    with pytest.raises(ValueError, match="0-d int64"):
        TA.decode_position(torch.tensor([3]), torch.device("cpu"))
    with pytest.raises(ValueError, match="0-d int64"):
        TA.decode_position(torch.tensor(3, dtype=torch.int32),
                           torch.device("cpu"))
    assert TA.decode_position(3, torch.device("cpu")).dtype == torch.int64
