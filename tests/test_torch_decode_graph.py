"""Decode with the cache length on the device, against the JAX package on
the CPU.

The port's decode step takes ``pos`` as a 0-d tensor on the caches'
device (JAX's traced ``jnp.int32(S + t)``) and attends over the whole
padded cache, masked by ``length = pos + 1``, so that one CUDA graph of the
step serves every position on the card.  Here, on the CPU:

* the plain length-masked attention (``reference_attention(length=)``
  and ``attn_decode``) against JAX's ``attn_decode`` / ``_decode_block``
  over a padded cache, windowed or not, with a logit softcap or not;
* the split plan of a device-length call (``plan_keys``): for every
  length the kernel can be given, the ranges it derives on the device
  cover the visible keys once, and the merge of the splits' partials
  (an empty range contributing m = -inf, l = 0, acc = 0, weighed 0 as
  ``flash_combine`` weighs it) equals the plain version;
* (``decode_step`` for every registered arch: test_torch_decode_archs.py)
* ``ServeEngine(device="cpu")`` greedy and temperature ids equal to
  JAX's for the three families of ``examples/serve_decode.py``;
* a decode state reused by a shorter request (its cache slots past the
  new prompt holding the last request's values) steps bit for bit as a
  fresh one: the engine's graph keeps one state a batch size;
* ``examples/torch_serve_decode.py`` on the CPU.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import get_config as jget
from repro.models import attention as JA
from repro.models import model as JM
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import tree, weights
from repro_torch.configs.base import get_config as tget
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ref import reference_attention
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.serving.engine import DecodeState, ServeEngine

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5
SERVE_ARCHS = ("qwen2-0.5b", "xlstm-350m", "hymba-1.5b")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- the plain length-masked attention ---------------------------------------


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (4, 0.0), (0, 20.0),
                                            (5, 20.0)])
@pytest.mark.parametrize("pos", [0, 6, 11])
def test_attn_decode_device_pos_matches_jax_over_the_padded_cache(
        window, softcap, pos):
    """Every slot past ``pos`` holds garbage here: only the length mask
    keeps it out."""
    rng = np.random.default_rng(pos + 10 * window)
    Bq, L, H, KV, hd = 2, 12, 4, 2, 16
    q = _rand(rng, Bq, 1, H, hd)
    kn, vn = _rand(rng, Bq, 1, KV, hd), _rand(rng, Bq, 1, KV, hd)
    ck, cv = _rand(rng, Bq, L, KV, hd), _rand(rng, Bq, L, KV, hd)
    y_j, ck_j, cv_j = JA.attn_decode(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(ck),
        jnp.asarray(cv), jnp.int32(pos), window=window, softcap=softcap)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    y_t, ck_t, cv_t = TA.attn_decode(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        tk, tv, torch.tensor(pos), window=window, softcap=softcap)
    assert ck_t is tk and cv_t is tv          # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(ck_j))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(cv_j))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("n", [1, 7, 16])
def test_reference_attention_length_matches_jax_decode_block(window, n):
    """``reference_attention(length=n)`` over all L slots is JAX's
    ``_decode_block`` at ``pos = n - 1`` over ``kpos = arange(L)``, and the
    plain version over the first n slots."""
    rng = np.random.default_rng(n)
    Bq, L, H, KV, hd = 2, 16, 6, 2, 8
    q, k, v = (_rand(rng, Bq, 1, H, hd), _rand(rng, Bq, L, KV, hd),
               _rand(rng, Bq, L, KV, hd))
    m, l, o = JA._decode_block(jnp.asarray(q[:, 0]), jnp.asarray(k),
                               jnp.asarray(v), jnp.arange(L), n - 1,
                               window=window, softcap=0.0)
    want = np.asarray(o / l[..., None]).reshape(Bq, 1, H, hd)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = reference_attention(tq, tk, tv, window=window,
                              length=torch.tensor(n, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    sliced = reference_attention(tq, tk[:, :n], tv[:, :n], window=window)
    np.testing.assert_allclose(got.numpy(), sliced.numpy(), atol=ATOL)
    # the wrapper on a CPU tensor takes the plain version
    via = FA.flash_attention(tq, tk, tv, window=window,
                             length=torch.tensor(n, dtype=torch.int32))
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_flash_length_must_be_a_0d_int32_tensor_on_qs_device():
    q = torch.zeros(1, 1, 2, 64)
    k = torch.zeros(1, 8, 2, 64)
    for bad in (5, torch.tensor(5), torch.tensor([5], dtype=torch.int32)):
        with pytest.raises(ValueError, match="length must be a 0-d int32"):
            FA.flash_attention(q, k, k, length=bad)


def _device_ranges(plan, Sq, n, window):
    """The key ranges the split kernel derives from a device count n."""
    k_begin = max(0, n - Sq - window + 1) if window > 0 else 0
    out = []
    for s in range(plan.splits):
        ks = k_begin + s * plan.chunk
        out.append((ks, min(n, ks + plan.chunk)))
    return k_begin, out


@settings(max_examples=60, deadline=None)
@given(L=st.integers(1, 5000), window=st.sampled_from([0, 8, 100, 1024]),
       Sq=st.integers(1, 4), n_bkv=st.sampled_from([1, 8, 20, 100]),
       data=st.data())
def test_device_length_ranges_cover_the_visible_keys(L, window, Sq, n_bkv,
                                                     data):
    """The plan is cut on the host for the padded cache; for ANY count
    the kernel reads (Sq <= n <= L), its ranges are disjoint, in order,
    and cover exactly the keys the rows see: [max(0, n - Sq - w + 1), n)."""
    Sq = min(Sq, L)
    plan = FA.split_plan(Sq, FA.plan_keys(Sq, L, window), False, 0, n_bkv)
    assert 1 <= plan.splits <= FA.SPLIT_MAX
    n = data.draw(st.integers(Sq, L))
    k_begin, ranges = _device_ranges(plan, Sq, n, window)
    keys = [k for a, b in ranges for k in range(a, b)]
    assert keys == list(range(k_begin, n))
    assert FA.key_range(Sq, n, True, window) == (k_begin, n)


def _partial(q, k, v, a, b):
    """A split's (m, l, acc) over keys [a, b), as flash_split_tc writes
    it: an empty range is m = -inf, l = 0, acc = 0."""
    Bq, _, H, hd = q.shape
    if b <= a:
        return (torch.full((Bq, H), -math.inf), torch.zeros(Bq, H),
                torch.zeros(Bq, H, hd))
    G = H // k.shape[2]
    kk = k[:, a:b].repeat_interleave(G, dim=2)
    vv = v[:, a:b].repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0], kk) / math.sqrt(hd)
    m = s.max(-1).values
    e = torch.exp(s - m[..., None])
    return m, e.sum(-1), torch.einsum("bhk,bkhd->bhd", e, vv)


@pytest.mark.parametrize("L,n,window", [(160, 132, 0), (4096, 132, 0),
                                        (1296, 1280, 1024), (64, 1, 0)])
def test_split_partials_with_empty_ranges_merge_to_the_plain_version(
        L, n, window):
    """flash_combine weighs a split by exp(m_s - max m): an empty split
    (m = -inf, l = 0) counts 0, so the merge of the device-length plan's
    partials is the plain version at length n."""
    rng = np.random.default_rng(L + n)
    q = torch.from_numpy(_rand(rng, 2, 1, 4, 16))
    k = torch.from_numpy(_rand(rng, 2, L, 2, 16))
    v = torch.from_numpy(_rand(rng, 2, L, 2, 16))
    plan = FA.split_plan(1, FA.plan_keys(1, L, window), False, 0, 8)
    _, ranges = _device_ranges(plan, 1, n, window)
    if L == 4096:       # the serve position in a long cache
        assert sum(b <= a for a, b in ranges) == plan.splits - 1
    parts = [_partial(q, k, v, a, b) for a, b in ranges]
    M = torch.stack([p[0] for p in parts]).max(0).values
    w = [torch.exp(p[0] - M) for p in parts]
    num = sum(wi[..., None] * p[2] for wi, p in zip(w, parts))
    den = sum(wi * p[1] for wi, p in zip(w, parts))
    got = (num / den[..., None])[:, None]
    want = reference_attention(q, k, v, window=window,
                               length=torch.tensor(n, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


# -- the engine and the example -----------------------------------------------


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_engine_ids_equal_jax_for_the_serve_decode_families(name):
    """examples/serve_decode.py's request: prompts (4, 12) from
    default_rng(0), 16 new tokens, greedy and at temperature 0.8 seed 1."""
    jc, tc = jget(name).reduced(), tget(name).reduced()
    jp = JM.init_model(jc, jax.random.PRNGKey(0))
    tp = weights.from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    jax_engine, engine = JaxEngine(jc, jp), ServeEngine(tc, tp, device="cpu")
    prompts = np.random.default_rng(0).integers(0, jc.vocab_size, (4, 12),
                                                dtype=np.int32)
    for temperature in (0.0, 0.8):
        want = jax_engine.generate(prompts, 16, temperature=temperature,
                                   seed=1)
        got = engine.generate(prompts, 16, temperature=temperature, seed=1)
        assert got.dtype == np.int32 and got.shape == (4, 16)
        np.testing.assert_array_equal(got, want)
    assert engine.graphs == {}           # the CPU steps eagerly


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_reused_decode_state_steps_as_a_fresh_one(name):
    """A state of 24 slots serves a request of 10 + 8 tokens, its KV tails
    are then filled with large values, and it takes a request of 6 + 5:
    every step's logits, the ids and the caches' first 11 slots are those
    of a fresh state (the slots past the length are masked, never read)."""
    cfg = tget(name).reduced()
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(3)
    B, L = 2, 24

    def prefill(S):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
        logits, caches = TM.prefill(
            cfg, params, {"tokens": toks,
                          "positions": torch.arange(S).expand(B, S)})
        return logits.argmax(-1), caches

    def fresh(caches):
        return DecodeState(cfg, params, TM.pad_caches(caches, L), B, L,
                           False, torch.device("cpu"))

    key = torch.zeros(2, dtype=torch.int64)
    with torch.inference_mode():
        tok, caches = prefill(10)
        used = fresh(caches)
        used.load(caches, tok, 10, key, 0.0)
        for _ in range(8):
            used.step()
        gen = torch.Generator().manual_seed(4)
        for layer in used.caches:
            for t in ((layer["attn"]["k"], layer["attn"]["v"])
                      if "attn" in layer else ()):
                t[:, 6:] = 1e3 * torch.randn(t[:, 6:].shape, generator=gen)
        tok, caches = prefill(6)
        new = fresh(caches)
        for st_ in (used, new):
            st_.load(caches, tok, 6, key, 0.0)
        for _ in range(5):
            assert torch.equal(used.step(), new.step())
        assert torch.equal(used.ids[:, :5], new.ids[:, :5])
        for a, b in zip(used.caches, new.caches):
            if "attn" in a:   # the slots up to the last position
                a, b = ({n: c["attn"][n][:, :11] for n in "kv"}
                        for c in (a, b))
            for x, y in zip(tree.leaves(a), tree.leaves(b)):
                assert torch.equal(x, y)


def test_torch_serve_decode_example_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_serve_decode", REPO / "examples" / "torch_serve_decode.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 * len(SERVE_ARCHS)
    for name, head, ids in zip(SERVE_ARCHS, lines[::2], lines[1::2]):
        assert head.startswith(name) and "incl. capture" in head
        assert "batch=4 prompt=12 new=16" in head
        assert ids.startswith("   sample continuation ids: [")
