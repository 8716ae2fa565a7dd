"""The algorithms of the Hopper flash-attention kernel, held to the JAX
oracle on the CPU.

``csrc/flash_attention.cu`` cannot run here, so what it computes is
written out plainly and held to ``repro.kernels.ref.reference_attention``:

* split-KV decode: ``reference_attention``'s math per key range (a row's
  max m, sum l and unnormalized P V), merged by ``combine_partials`` as the
  merge kernel does, f32, atol 2e-5 (tests/test_kernels.py's f32 bound);
* the split plan (``split_plan``), a hypothesis property: its ranges cover
  the visible keys exactly once, none is empty, and the visible keys are
  exactly those the window start and the causal edge leave; non-causally
  (whisper's cross-attention) every key, Sq 1 over Sk 1536 included;
* the wgmma path's numerics: 64-key tiles from a 64-aligned start, online
  softmax in f32, P rounded to bf16 before P V, bf16 inputs, at the serve
  and train prefill shapes, atol 3e-2 (the card's bf16 bound in
  chip_smoke.py);
* ``choose_path``, a pure function of dtype, rows and alignment, for
  every ``chip_smoke.FLASH_CASES`` row;
* the library name of a kernel, which covers the headers under csrc/.
"""
import importlib.util
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
F32_ATOL = 2e-5
BF16_ATOL = 3e-2
NEG_INF = float("-inf")


def _qkv(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))


def _oracle(q, k, v, causal, window, dtype=jnp.float32):
    out = jref.reference_attention(
        *(jnp.asarray(a, dtype=dtype) for a in (q, k, v)), causal=causal,
        window=window)
    return np.asarray(out, dtype=np.float32)


def _scores(q, k, causal, window):
    """f32 scores (B, KV, G, Sq, Sk) with masked pairs at -inf, and the
    mask: reference_attention's math."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    qpos = torch.arange(Sq) + (Sk - Sq)
    kpos = torch.arange(Sk)
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= kpos[None] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None] > qpos[:, None] - window
    return s.masked_fill(~mask, NEG_INF)


def split_partials(q, k, v, ranges, causal, window):
    """Per key range [a, b): the rows' max m, sum l = sum exp(s - m) and
    unnormalized acc = exp(s - m) V, as each split-KV block writes them.
    A row that sees no key of a range gets m = -inf, l = 0, acc = 0."""
    s = _scores(q, k, causal, window)
    B, KV, G, Sq, _ = s.shape
    vf = v.float()
    parts = []
    for a, b in ranges:
        sc = s[..., a:b]
        m = sc.amax(-1)
        m_use = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(sc - m_use[..., None])
        acc = torch.einsum("bkgqs,bskh->bkgqh", p, vf[:, a:b])
        parts.append((m, p.sum(-1), acc))
    return parts


def combine_partials(m, l, acc):
    """Merge per-split partials, stacked on dim 0: m, l (S, ...), acc
    (S, ..., hd) -> sum_s w_s acc_s / sum_s w_s l_s, w_s = exp(m_s - M)."""
    M = m.amax(0)
    M = torch.where(torch.isinf(M), torch.zeros_like(M), M)
    w = torch.exp(m - M)
    num = (w[..., None] * acc).sum(0)
    den = (w * l).sum(0)
    return torch.where(den[..., None] > 0, num / den[..., None],
                       torch.zeros_like(num))


def split_kv_attention(q, k, v, ranges, causal=True, window=0):
    m, l, acc = (torch.stack(t) for t in
                 zip(*split_partials(q, k, v, ranges, causal, window)))
    o = combine_partials(m, l, acc)            # (B, KV, G, Sq, hd)
    B, Sq, H, hd = q.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def _chunks(lo, hi, step):
    return [(a, min(hi, a + step)) for a in range(lo, hi, step)]


def _ranges(plan):
    """The key range of each split, as the kernel's blocks compute it."""
    return [(plan.k_begin + s * plan.chunk,
             min(plan.k_end, plan.k_begin + (s + 1) * plan.chunk))
            for s in range(plan.splits)]


# (B, Sq, Sk, H, KV, hd, window, chunk): decode, decode over a long
# cache, short query blocks; windows leave whole chunks masked
COMBINE_CASES = [
    (2, 1, 37, 14, 2, 16, 0, 9),
    (2, 1, 300, 14, 2, 16, 0, 64),
    (2, 1, 37, 14, 2, 16, 6, 4),
    (2, 5, 29, 6, 2, 16, 8, 4),
    (1, 3, 50, 4, 1, 32, 5, 3),
    (2, 9, 33, 7, 1, 16, 0, 1),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,window,chunk", COMBINE_CASES)
def test_split_kv_combine_matches_oracle(B, Sq, Sk, H, KV, hd, window,
                                         chunk):
    q, k, v = _qkv(10, B, Sq, Sk, H, KV, hd)
    ranges = _chunks(0, Sk, chunk)
    parts = split_partials(*(torch.from_numpy(a) for a in (q, k, v)),
                           ranges, True, window)
    if window:   # some chunk is masked for every row
        assert any(bool(torch.isinf(m).all()) for m, _, _ in parts)
    got = split_kv_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             ranges, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, True, window),
                               atol=F32_ATOL)


@pytest.mark.parametrize("Sq,Sk,window,n_bkv", [
    (1, 132, 0, 8), (1, 160, 0, 8), (1, 4096, 0, 8), (1, 4096, 100, 8),
    (3, 700, 0, 2), (1, 1000, 0, 1)])
def test_split_plan_ranges_match_oracle(Sq, Sk, window, n_bkv):
    """The kernel's own ranges, merged, give the oracle's answer."""
    q, k, v = _qkv(11, 1, Sq, Sk, 14, 2, 16)
    plan = FA.split_plan(Sq, Sk, True, window, n_bkv)
    got = split_kv_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             _ranges(plan), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, True, window),
                               atol=F32_ATOL)


# non-causal (cross-attention): whisper's cross decode over its 1536
# frames (B 2 x KV 8 heads), a short query block over more keys, GQA
NONCAUSAL_COMBINE_CASES = [
    (2, 1, 1536, 8, 8, 16, 256),
    (2, 1, 37, 14, 2, 16, 9),
    (2, 5, 29, 6, 2, 16, 4),
    (1, 32, 300, 8, 8, 16, 64),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,chunk", NONCAUSAL_COMBINE_CASES)
def test_split_kv_combine_non_causal_matches_oracle(B, Sq, Sk, H, KV, hd,
                                                    chunk):
    q, k, v = _qkv(14, B, Sq, Sk, H, KV, hd)
    got = split_kv_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             _chunks(0, Sk, chunk), causal=False)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, False, 0),
                               atol=F32_ATOL)


@pytest.mark.parametrize("Sq,Sk,n_bkv", [
    (1, 1536, 32), (1, 1536, 1), (32, 1536, 32), (4, 300, 8), (9, 9, 2)])
def test_split_plan_non_causal_ranges_match_oracle(Sq, Sk, n_bkv):
    """Cross decode (Sq 1 over whisper's 1536 frames), the serve prompt's
    cross prefill (Sq 32) and Sq = Sk: the plan covers every key, and its
    ranges merged give the oracle's answer."""
    q, k, v = _qkv(15, 1, Sq, Sk, 8, 8, 16)
    plan = FA.split_plan(Sq, Sk, False, 0, n_bkv)
    assert (plan.k_begin, plan.k_end) == (0, Sk)
    got = split_kv_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             _ranges(plan), causal=False)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, False, 0),
                               atol=F32_ATOL)


def test_split_plan_at_the_serve_shapes():
    # qwen2-0.5b's serve decode (B*KV = 8) from its first step to its last
    for Sk in range(129, 161):
        plan = FA.split_plan(1, Sk, True, 0, 8)
        assert plan.splits in (4, 5) and plan.chunk >= FA.SPLIT_MIN_KEYS
    long = FA.split_plan(1, 4096, True, 0, 8)
    assert (long.splits, long.chunk) == (16, FA.SPLIT_MAX_KEYS)
    assert FA.split_plan(1, 2 * FA.SPLIT_MIN_KEYS - 1, True, 0, 8).splits == 1


@settings(max_examples=300, deadline=None)
@given(Sq=st.integers(1, 40), extra=st.integers(0, 5000),
       causal=st.booleans(), window=st.integers(0, 600),
       n_bkv=st.integers(1, 300), n_sm=st.integers(1, 200))
def test_split_plan_property(Sq, extra, causal, window, n_bkv, n_sm):
    Sk = Sq + extra
    plan = FA.split_plan(Sq, Sk, causal, window, n_bkv, n_sm)
    ranges = _ranges(plan)
    # covered once, in order, nothing empty, within the split limit
    assert 1 <= plan.splits <= FA.SPLIT_MAX and len(ranges) == plan.splits
    assert ranges[0][0] == plan.k_begin and ranges[-1][1] == plan.k_end
    for (a0, b0), (a1, b1) in zip(ranges, ranges[1:]):
        assert b0 == a1
    assert all(b > a for a, b in ranges)
    if plan.splits > 1:
        assert all(b - a >= FA.SPLIT_MIN_KEYS for a, b in ranges[:-1])
    # [k_begin, k_end) is exactly the keys some row sees
    qpos = np.arange(Sq) + (Sk - Sq)
    kpos = np.arange(Sk)
    seen = np.ones((Sq, Sk), bool)
    if causal:
        seen &= kpos[None] <= qpos[:, None]
    if window > 0:
        seen &= kpos[None] > qpos[:, None] - window
    cols = np.flatnonzero(seen.any(0))
    assert plan.k_begin == cols[0] and plan.k_end == cols[-1] + 1


@settings(max_examples=200, deadline=None)
@given(Sq=st.integers(1, 64), extra=st.integers(0, 3000),
       n_bkv=st.integers(1, 300), n_sm=st.integers(1, 200))
def test_split_plan_non_causal_property(Sq, extra, n_bkv, n_sm):
    """Non-causal, no window (cross-attention, Sq <= Sk): every key, in
    ranges of at least SPLIT_MIN_KEYS but the last, none empty."""
    Sk = Sq + extra
    plan = FA.split_plan(Sq, Sk, False, 0, n_bkv, n_sm)
    ranges = _ranges(plan)
    assert (plan.k_begin, plan.k_end) == (0, Sk)
    assert 1 <= plan.splits <= FA.SPLIT_MAX and len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == Sk
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(ranges, ranges[1:]))
    assert all(b > a for a, b in ranges)
    if plan.splits > 1:
        assert all(b - a >= FA.SPLIT_MIN_KEYS for a, b in ranges[:-1])


def tiled_attention(q, k, v, causal=True, window=0, round_p=True, tile=64,
                    rows=64):
    """The wgmma path's arithmetic: per block of `rows` packed rows (r =
    i*G + g), 64-key tiles from a 64-aligned start up to the block's causal
    edge, an online softmax in f32 whose P is rounded to bf16 before P V
    when `round_p` (bf16 x bf16 products summed in f32), the row sum l of
    the unrounded P, O / l in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    s_all = _scores(q, k, causal, window)          # (B, KV, G, Sq, Sk)
    s_all = s_all.permute(0, 1, 3, 2, 4).reshape(B, KV, Sq * G, Sk)
    vf = v.float()
    out = torch.zeros(B, KV, Sq * G, hd)
    off = Sk - Sq
    for r0 in range(0, Sq * G, rows):
        r1 = min(Sq * G, r0 + rows)
        q_first, q_last = r0 // G + off, (r1 - 1) // G + off
        k_end = min(Sk, q_last + 1) if causal else Sk
        k_begin = max(0, q_first - window + 1) if window > 0 else 0
        k_begin -= k_begin % tile
        m = torch.full((B, KV, r1 - r0), NEG_INF)
        l = torch.zeros(B, KV, r1 - r0)
        acc = torch.zeros(B, KV, r1 - r0, hd)
        for k0 in range(k_begin, k_end, tile):
            k1 = min(k_end, k0 + tile)
            s = s_all[:, :, r0:r1, k0:k1]
            m_new = torch.maximum(m, s.amax(-1))
            m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                                m_new)
            corr = torch.exp(m - m_use)
            p = torch.exp(s - m_use[..., None])
            l = l * corr + p.sum(-1)
            pb = p.to(torch.bfloat16).float() if round_p else p
            acc = acc * corr[..., None] + torch.einsum(
                "bkrs,bskh->bkrh", pb, vf[:, k0:k1])
            m = m_new
        out[:, :, r0:r1] = acc / l[..., None]
    out = out.reshape(B, KV, Sq, G, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


# the serve prefill, the train forward per worker, a ragged prompt, a
# window, hd 128
@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (4, 128, 14, 2, 64, 0), (2, 128, 14, 2, 64, 0), (4, 100, 14, 2, 64, 0),
    (2, 256, 14, 2, 64, 96), (2, 128, 8, 2, 128, 0)])
def test_bf16_p_rounding_within_tolerance(B, S, H, KV, hd, window):
    q, k, v = _qkv(12, B, S, S, H, KV, hd)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tiled_attention(tq, tk, tv, causal=True, window=window)
    want = _oracle(*(t.float().numpy() for t in (tq, tk, tv)), True, window,
                   dtype=jnp.bfloat16)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_ATOL, err


@pytest.mark.parametrize("Sq,Sk,window", [(200, 200, 40), (72, 200, 0)])
def test_tiled_model_without_rounding_matches_oracle(Sq, Sk, window):
    """Without the bf16 rounding the tiled model is the oracle in f32, row
    blocks, skipped tiles and edge masks included: what the bf16 test
    measures is the rounding."""
    q, k, v = _qkv(13, 2, Sq, Sk, 14, 2, 16)
    got = tiled_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, window=window, round_p=False)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, True, window),
                               atol=F32_ATOL)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", [
    (1, 1536, 1536, 8, 8, 64), (2, 128, 1536, 8, 8, 64),
    (2, 100, 100, 8, 8, 64)])
def test_bf16_p_rounding_non_causal_within_tolerance(B, Sq, Sk, H, KV, hd):
    """Whisper's non-causal calls on the wgmma path: the encoder (1536
    frames), the train cross-attention (Sq 128 over 1536) and a ragged
    100: every tile of every row block visible."""
    q, k, v = _qkv(16, B, Sq, Sk, H, KV, hd)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tiled_attention(tq, tk, tv, causal=False)
    want = _oracle(*(t.float().numpy() for t in (tq, tk, tv)), False, 0,
                   dtype=jnp.bfloat16)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_ATOL, err


@pytest.mark.parametrize("Sq,Sk", [(72, 200), (200, 200)])
def test_tiled_model_non_causal_matches_oracle(Sq, Sk):
    q, k, v = _qkv(17, 2, Sq, Sk, 14, 2, 16)
    got = tiled_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=False, round_p=False)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, False, 0),
                               atol=F32_ATOL)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", mod)   # its dataclass looks it up
    spec.loader.exec_module(mod)
    return mod


def test_choose_path_for_every_flash_case():
    """Each chip_smoke.py flash case takes the path it asserts on the card
    (fresh tensors are 16-byte aligned; an ``offset`` case is not), its
    non-causal cases included: whisper's encoder and cross-attention,
    qwen2-vl's 7 query heads a KV head at hd 128."""
    cases = _chip_smoke().FLASH_CASES
    assert any(not c.causal for c in cases)
    assert any(c.H // c.KV == 7 and c.hd == 128 for c in cases)
    for c in cases:
        got = FA.choose_path(getattr(torch, c.dtype), c.Sq, c.H // c.KV,
                             c.offset == 0)
        assert got == c.path, c.name
        assert 1 <= c.Sq <= c.Sk and c.hd in FA.HEAD_DIMS, c.name


@pytest.mark.parametrize("dtype,Sq,G,aligned,want", [
    (torch.bfloat16, 1, 7, True, "split_kv"),      # serve decode
    (torch.float32, 1, 7, True, "simt"),           # parity decode
    (torch.bfloat16, 9, 7, True, "split_kv"),      # 63 rows
    (torch.bfloat16, 10, 7, True, "wgmma"),        # 70 rows
    (torch.bfloat16, 128, 7, True, "wgmma"),       # serve prefill
    (torch.bfloat16, 16, 7, True, "wgmma"),        # sq16_sk144
    (torch.float32, 128, 7, True, "simt"),         # parity prefill
    (torch.bfloat16, 128, 7, False, "simt"),       # unaligned view
    (torch.bfloat16, 1, 7, False, "simt"),
])
def test_choose_path(dtype, Sq, G, aligned, want):
    assert FA.choose_path(dtype, Sq, G, aligned) == want


def test_aligned16():
    x = torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16)
    assert FA.aligned16(x, x[:, :5])
    assert not FA.aligned16(x[..., 1:])                  # pointer
    y = torch.zeros(2, 8, 3, 12, dtype=torch.bfloat16)   # 24-byte head
    assert not FA.aligned16(y)


def test_library_name_covers_headers(tmp_path, monkeypatch):
    """A change to a header under csrc/ renames every kernel's library, so
    a stale one is never loaded."""
    for src in list(build.SOURCES.values()) + ["wgmma.cuh"]:
        (tmp_path / src).write_bytes((build.CSRC / src).read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build._lib_path("flash_attention")
    other = build._lib_path("fused_adam")
    (tmp_path / "wgmma.cuh").write_text("// changed\n")
    assert build._lib_path("flash_attention") != before
    assert build._lib_path("fused_adam") != other
