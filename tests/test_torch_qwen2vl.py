"""qwen2-vl-7b in the port vs the JAX package on the CPU (reduced, f32).

The reduced config keeps M-RoPE (sections (2, 3, 3) over head_dim 16),
GQA (4 heads over 2), the QKV biases and the stubbed vision frontend
(``patch_embeds`` and ``image_mask`` merged into the token stream).
Held against JAX: M-RoPE's cos/sin and ``apply_rope`` with h/w streams
that differ from t; ``forward`` in train mode with a run of image
positions; prefill with (3, B, S) positions and patches, then decode
steps with (B, 1) positions; ``launch.train._split`` of (3, B, S)
positions against the reference's ``_split_batch``; a psum train step
whose batch carries patches and M-RoPE positions through the per-worker
split; ``check_positions`` on (3, B, S).

Tolerances (f32): cos/sin and roped q/k at 1e-6, logits at 1e-4
(test_torch_model.py's), the loss at 1e-5, Adam's m at 1e-4 of its
leaf's scale, p within 2 lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs.base import get_config as jget
from repro.launch.train import _split_batch, jit_train_step
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import optim as toptim
from repro_torch import tree, weights
from repro_torch.configs.base import get_config as tget
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as TT
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

torch.set_num_threads(2)

NAME = "qwen2-vl-7b"
ROPE_ATOL = 1e-6
ATOL = 1e-4
GRAD_TOL = 1e-4
LR = 3e-3
B, S = 2, 12
IMAGE = slice(3, 9)   # the image run's token positions


def _cfgs():
    return jget(NAME).reduced(), tget(NAME).reduced()


def _mrope_positions(n, s, seed):
    """(3, n, s): stream t is 0..s-1 (the masks' positions); h and w run
    over a 2 x 3 grid inside the image run and follow t outside it, as
    Qwen2-VL lays out an image's patches, plus a seeded jitter so that no
    two streams coincide."""
    t = np.broadcast_to(np.arange(s), (n, s)).astype(np.int32)
    h, w = t.copy(), t.copy()
    k = np.arange(IMAGE.stop - IMAGE.start)
    h[:, IMAGE] = IMAGE.start + k // 3
    w[:, IMAGE] = IMAGE.start + k % 3
    rng = np.random.default_rng(seed)
    h = h + rng.integers(0, 3, (n, s)).astype(np.int32)
    return np.stack([t, h, w]).astype(np.int32)


def _vision_batch(cfg, n, s, seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((n, s), bool)
    mask[:, IMAGE] = True
    return {"positions": _mrope_positions(n, s, seed),
            "patch_embeds": (0.05 * rng.standard_normal(
                (n, s, cfg.d_model))).astype(np.float32),
            "image_mask": mask}


def _model(seed=0):
    jc, tc = _cfgs()
    pnp = jax.tree.map(np.asarray, JM.init_model(jc,
                                                 jax.random.PRNGKey(seed)))
    return jc, tc, jax.tree.map(jnp.asarray, pnp), weights.from_jax(
        tc, pnp, device="cpu")


def _scaled(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_mrope_cos_sin_matches_jax():
    jc, tc = _cfgs()
    pos = _mrope_positions(B, S, 1)
    assert not np.array_equal(pos[0], pos[1])
    assert not np.array_equal(pos[1], pos[2])
    rot = jc.head_dim
    jcos, jsin = JL._mrope_cos_sin(jc, jnp.asarray(pos), rot, jnp.float32)
    tcos, tsin = TL._mrope_cos_sin(tc, torch.from_numpy(pos), rot,
                                   torch.float32)
    assert tcos.shape == (B, S, rot // 2)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos),
                               atol=ROPE_ATOL)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin),
                               atol=ROPE_ATOL)
    # each section reads its own stream
    t_only = TL._rope_cos_sin(torch.from_numpy(pos[0]), rot, tc.rope_theta,
                              torch.float32)[0]
    assert torch.equal(tcos[..., :2], t_only[..., :2])
    assert not torch.equal(tcos[..., 2:], t_only[..., 2:])


@pytest.mark.parametrize("streams", [3, 2])
def test_apply_rope_matches_jax(streams):
    """(3, B, S) positions, and (B, S) ones broadcast to three equal
    streams (decode passes (B, 1)): there M-RoPE is the standard RoPE."""
    jc, tc = _cfgs()
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, S, 4, 16)).astype(np.float32)
    k = rng.standard_normal((B, S, 2, 16)).astype(np.float32)
    pos = _mrope_positions(B, S, 3)
    if streams == 2:
        pos = pos[1]
    jq, jk = JL.apply_rope(jc, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(pos))
    tq, tk = TL.apply_rope(tc, torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ROPE_ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ROPE_ATOL)
    if streams == 2:
        plain = dataclasses.replace(tc, mrope_sections=())
        pq, _ = TL.apply_rope(plain, torch.from_numpy(q),
                              torch.from_numpy(k),
                              torch.from_numpy(pos.copy()))
        np.testing.assert_allclose(tq.numpy(), pq.numpy(), atol=ROPE_ATOL)


def _torch_batch(batch):
    out = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def test_forward_with_patch_embeds_matches_jax():
    jc, tc, jp, tp = _model()
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, (B, S),
                                             dtype=np.int32)
    batch = dict(_vision_batch(jc, B, S, 5), tokens=toks)
    jl = np.asarray(jax.jit(lambda p, b: JM.forward(jc, p, b,
                                                    mode="train")[0])(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    tl, caches, aux = TM.forward(tc, tp, _torch_batch(batch), mode="train")
    assert tl.shape == (B, S, tc.vocab_size) and caches is None
    np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL)
    # the patches replaced the image run's embeddings: without them the
    # logits differ from the image run on (causally) and not before it
    plain = TM.forward(tc, tp, _torch_batch(dict(
        batch, image_mask=np.zeros((B, S), bool))), mode="train")[0]
    assert torch.equal(plain[:, :IMAGE.start], tl[:, :IMAGE.start])
    assert float((plain[:, IMAGE] - tl[:, IMAGE]).abs().max()) > 1e-3


def test_prefill_and_decode_match_jax():
    """Prefill with patches and (3, B, S) positions, then 4 decode steps
    that pass (B, 1) positions, greedy, against JAX."""
    jc, tc, jp, tp = _model(1)
    toks = np.random.default_rng(6).integers(0, jc.vocab_size, (B, S),
                                             dtype=np.int32)
    batch = dict(_vision_batch(jc, B, S, 7), tokens=toks)
    jl, jcache = jax.jit(lambda p, b: JM.prefill(jc, p, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tcache = TM.prefill(tc, tp, _torch_batch(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    n_dec = 4
    jcache = JM.pad_caches(jcache, S + n_dec)
    tcache = TM.pad_caches(tcache, S + n_dec)
    jdec = jax.jit(lambda p, t, q, c: JM.decode_step(jc, p, t, q, c))
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    for t in range(n_dec):
        jl, jcache = jdec(jp, jnp.asarray(tok), jnp.int32(S + t), jcache)
        tl, tcache = TM.decode_step(tc, tp, torch.as_tensor(
            tok, dtype=torch.int64), S + t, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        tok = np.argmax(np.asarray(jl)[:, 0], axis=-1).astype(
            np.int32)[:, None]


@pytest.mark.parametrize("parts", [2, 4])
def test_split_matches_reference_split_batch(parts):
    """(3, B, S) positions split on their row axis, every other entry on
    axis 0: part i of the port's is part i of the reference's."""
    jc, _ = _cfgs()
    n = 8
    batch = dict(SyntheticTokens(jc.vocab_size, S, n, seed=0).batch(0),
                 **_vision_batch(jc, n, S, 8))
    batch["positions"] = batch["positions"] + np.arange(n)[None, :, None]
    ref = jax.tree.map(np.asarray, _split_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, parts))
    got = TT._split(batch, parts)
    assert len(got) == parts
    for i, part in enumerate(got):
        assert part["positions"].shape == (3, n // parts, S)
        for k, v in part.items():
            np.testing.assert_array_equal(np.asarray(v), ref[k][i],
                                          err_msg=k)


def test_check_positions_reads_stream_zero():
    pos = _mrope_positions(B, S, 9)
    TM.check_positions(pos)                         # h/w differ: accepted
    TM.check_positions(torch.from_numpy(pos))
    offset = pos.copy()
    offset[0] += 5
    with pytest.raises(ValueError, match="0..S-1"):
        TM.check_positions(offset)
    packed = pos.copy()
    packed[0, :, 6:] = np.arange(S - 6)
    with pytest.raises(ValueError, match="0..S-1"):
        TM.check_positions(packed)


def test_psum_train_step_with_patches_matches_jax():
    """W 4 with a worker dropped: patches, the image mask and (3, B, S)
    positions ride through the per-worker split onto the device."""
    jc, tc, jp, _ = _model(2)
    jopt, topt = joptim.adamw(LR), toptim.adamw(LR, fused=True)
    jstate = {"params": jp, "opt": jopt.init(jp)}
    tstate = weights.state_from_jax(tc, jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    f = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    batch = dict(SyntheticTokens(jc.vocab_size, S, 8, seed=1).batch(0),
                 **_vision_batch(jc, 8, S, 10))
    jnew, jm = jit_train_step(jc, jopt, donate=False, mask_agg="psum")(
        jstate, dict({k: jnp.asarray(v) for k, v in batch.items()},
                     mask=jnp.asarray(f)))
    tnew, tm = TT.make_train_step(tc, topt, mask_agg="psum")(
        tstate, dict(batch, mask=f))
    for key in ("loss", "ce"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(tm["gnorm"].item(), float(jm["gnorm"]),
                               rtol=1e-4)
    got = tree.leaves(tnew["opt"]["m"])
    want = tree.leaves(weights.from_jax(
        tc, jax.tree.map(np.asarray, jnew["opt"]["m"]), device="cpu"))
    for a, b in zip(got, want):
        assert _scaled(a.numpy(), b.numpy()) <= GRAD_TOL
    want = tree.leaves(weights.from_jax(
        tc, jax.tree.map(np.asarray, jnew["params"]), device="cpu"))
    err = max(float((a - b).abs().max())
              for a, b in zip(tree.leaves(tnew["params"]), want))
    assert err <= 2 * LR
