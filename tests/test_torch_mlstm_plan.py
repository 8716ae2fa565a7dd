"""The algorithm of the Hopper mlstm_chunk kernel's tensor-core path, held
to the JAX oracle on the CPU.

``csrc/mlstm_chunk.cu`` cannot run here, so what its wgmma path computes
is written out plainly (``plan_mlstm``) and held to
``repro.kernels.ref.reference_mlstm`` (the sequential recurrence) and to
``repro.kernels.mlstm_chunk`` in interpret mode, at atol = rtol = 5e-4
(tests/test_kernels.py's bound for the Pallas kernel):

* the stabilizer as a prefix max over the gates, known before any
  product: m_out[t] = max(lg_t + m_enter, lg_t + max_{s<=t}(i_s - lg_s)),
  with the cumulative log decay lg summed in f64 within a chunk of at most
  128 positions;
* the chunk states as the state kernel forms them, C <- decay C +
  (k sc)^T v carried from chunk to chunk, with k sc split into bf16 hi + lo;
* the outputs of each chunk with the state entering it: (W*S) v with W*S
  split into bf16 hi + lo, plus the entering C (split too) and n;
* extreme gates (forget logits +-10, input logits up to 10), where an f32
  difference of cumulative log decays would not hold the tolerance;
* S from 1 to 300 and the chunk, a hypothesis property;
* the bf16 hi + lo split against f32 products;
* ``choose_path`` for every ``chip_smoke.MLSTM_CASES`` row, and the
  scratch the wgmma path asks for.

Inputs are made with numpy from a seed, q/k/v rounded to bf16 as on the
card, and handed to both sides.
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
from repro.kernels.mlstm_chunk import mlstm_chunk as jmlstm
from repro_torch.kernels import mlstm_chunk as K
from repro_torch.kernels.mlstm_plain import (NEG, ScanState,
                                             linear_recurrence)
from repro_torch.models.ssm import recurrence_step

torch.set_num_threads(2)

TOL = 5e-4
REPO = Path(__file__).resolve().parent.parent


def _inputs(seed, B, S, H, hd, gates="normal"):
    """q/k/v (B,S,H,hd) with bf16 values, and f32 log gates g/i (B,S,H),
    as chip_smoke.py makes them: g = log_sigmoid(forget logits)."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float()

    q = bf16(0.5 * rng.standard_normal((B, S, H, hd)))
    k = bf16(0.5 * rng.standard_normal((B, S, H, hd)))
    v = bf16(rng.standard_normal((B, S, H, hd)))
    if gates == "extreme":
        f = np.where(rng.standard_normal((B, S, H)) > 0, 10.0, -10.0)
        i = rng.uniform(-10.0, 10.0, (B, S, H))
    else:
        f = rng.standard_normal((B, S, H)) + 3.0
        i = 0.5 * rng.standard_normal((B, S, H))
    g = torch.from_numpy((-np.logaddexp(0.0, -f)).astype(np.float32))
    return q, k, v, g, torch.from_numpy(i.astype(np.float32))


def _oracle(*arrs):
    return np.asarray(jref.reference_mlstm(
        *(jnp.asarray(a.numpy()) for a in arrs)))


def split_bf16(x):
    """x = hi + lo, each a bf16 value: hi rounds x, lo rounds the rest (the
    kernel's ``split_bf16``)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _split_mm(eq, a, b):
    """An einsum with an f32 first operand and a bf16-valued second, as two
    bf16 products (hi and lo) on the tensor cores."""
    hi, lo = split_bf16(a)
    return torch.einsum(eq, hi, b) + torch.einsum(eq, lo, b)


def stabilizer(g, i, m_enter):
    """Per position of a chunk (B, L, H): the f64 cumulative log decay lg,
    m_out by the prefix max, and the entering state's weight
    exp(lg + m_enter - m_out) -- all before any product."""
    lg = torch.cumsum(g.double(), dim=1)
    pm = torch.cummax(i.double() - lg, dim=1).values
    lge = lg + m_enter[:, None].double()
    m_out = torch.maximum(lge, lg + pm).float()
    sc_e = torch.exp((lge - m_out.double()).float())
    return lg, m_out, sc_e


def state_step(state, k, v, g, i):
    """The state kernel on one chunk: C <- decay C + (k sc)^T v."""
    lg = torch.cumsum(g.double(), dim=1)
    tot = lg[:, -1]                                    # (B, H)
    w = (tot[:, None] - lg).float() + i                # carry to chunk end
    m_carry = state.m.double() + tot
    m_new = torch.maximum(m_carry, w.amax(1).double()).float()
    decay = torch.exp((m_carry - m_new.double()).float())
    ksc = torch.exp(w - m_new[:, None])[..., None] * k    # f32
    C = (state.C * decay[..., None, None]
         + _split_mm("bshd,bshv->bhdv", ksc, v))
    n = state.n * decay[..., None] + ksc.sum(1)
    return ScanState(loga=state.loga + tot.float(), m=m_new, C=C, n=n)


def outputs(q, k, v, g, i, enter):
    """The outputs kernel on one chunk, given the state entering it (None
    for the first chunk)."""
    L, hd = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    m_e = (torch.full(g[:, 0].shape, NEG) if enter is None else enter.m)
    lg, m_out, sc_e = stabilizer(g, i, m_e)
    D = (lg[:, :, None] - lg[:, None, :]).float() + i[:, None]  # (B,t,s,H)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))[None, :, :, None]
    W = torch.where(tri, torch.exp(D - m_out[:, :, None]), torch.zeros(()))
    WS = W * (torch.einsum("bthd,bshd->btsh", q, k) * scale)
    num = _split_mm("btsh,bshv->bthv", WS, v)
    den = WS.sum(2)
    if enter is not None:
        num = num + (sc_e * scale)[..., None] * _split_mm(
            "bhdv,bthd->bthv", enter.C, q)
        den = den + sc_e * torch.einsum("bthd,bhd->bth", q, enter.n) * scale
    den = torch.maximum(den.abs(), torch.exp(-m_out))
    return num / den[..., None]


def plan_mlstm(q, k, v, g, i, chunk=K.CHUNK):
    """The wgmma path's decomposition: (y (B,S,H,hd), final ScanState)."""
    B, S, H, hd = q.shape
    state = ScanState(loga=torch.zeros(B, H), m=torch.full((B, H), NEG),
                      C=torch.zeros(B, H, hd, hd), n=torch.zeros(B, H, hd))
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(S, c0 + chunk))
        args = [t[:, sl] for t in (q, k, v, g, i)]
        ys.append(outputs(*args, None if c0 == 0 else state))
        state = state_step(state, *args[1:])
    return torch.cat(ys, dim=1), state


def _check(y, st, arrs, S):
    """y against the oracle over S positions, and a decode step from the
    final state against the oracle's next position."""
    want = _oracle(*arrs)
    np.testing.assert_allclose(y.numpy(), want[:, :S], atol=TOL, rtol=TOL)
    step, _ = recurrence_step(st, *(a[:, S] for a in arrs))
    np.testing.assert_allclose(step.numpy(), want[:, S], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,S,H,hd", [
    (2, 1, 2, 64), (2, 100, 2, 64), (1, 128, 2, 128), (2, 130, 2, 64),
    (1, 300, 2, 64)])
def test_plan_matches_oracle(B, S, H, hd):
    arrs = _inputs(S + hd, B, S + 1, H, hd)
    y, st = plan_mlstm(*(a[:, :S] for a in arrs))
    _check(y, st, arrs, S)


@pytest.mark.parametrize("S,chunk", [(128, 128), (256, 128), (96, 32)])
def test_plan_matches_pallas_interpret(S, chunk):
    arrs = _inputs(3 + S, 1, S, 2, 32)
    want = jmlstm(*(jnp.asarray(a.numpy()) for a in arrs), chunk=chunk,
                  interpret=True)
    y, _ = plan_mlstm(*arrs, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("S", [128, 200])
def test_plan_and_plain_hold_extreme_gates(S):
    """Forget logits +-10: |lg| reaches hundreds in a chunk of 128.  The
    plan and the plain version (both with lg in f64) hold the oracle."""
    arrs = _inputs(21, 2, S + 1, 2, 64, gates="extreme")
    head = [a[:, :S] for a in arrs]
    y, st = plan_mlstm(*head)
    assert torch.isfinite(y).all()
    _check(y, st, arrs, S)
    plain, pst = linear_recurrence(*head)
    _check(plain, pst, arrs, S)


@settings(max_examples=12, deadline=None)
@given(S=st.integers(1, 300), chunk=st.sampled_from([1, 16, 64, 128]),
       seed=st.integers(0, 2**16))
def test_plan_any_length_and_chunk(S, chunk, seed):
    arrs = _inputs(seed, 1, S + 1, 1, 16)
    y, st = plan_mlstm(*(a[:, :S] for a in arrs), chunk=chunk)
    _check(y, st, arrs, S)


def test_split_bf16_products_hold_f32():
    """hi + lo keeps x to 2^-16 of its size (one bf16 rounding keeps only
    2^-9); two bf16 products against a bf16 operand hold the f32 product
    within the tolerance."""
    rng = np.random.default_rng(5)
    wide = torch.from_numpy((rng.standard_normal((64, 128))
                             * np.exp(rng.uniform(-8, 8, (64, 128))))
                            .astype(np.float32))
    hi, lo = split_bf16(wide)
    assert ((wide - hi - lo).abs() <= 2.0 ** -16 * wide.abs()).all()
    assert ((wide - hi).abs() / wide.abs()).max() > 2.0 ** -10
    # operands as the kernel meets them: W*S, k*sc, C_enter
    x = torch.from_numpy((rng.standard_normal((64, 128))
                          * np.exp(rng.uniform(-2, 2, (64, 128))))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((128, 96)).astype(np.float32)
                         ).bfloat16().float()
    got = _split_mm("ts,sv->tv", x, v)
    np.testing.assert_allclose(got.numpy(), (x @ v).numpy(), atol=TOL,
                               rtol=TOL)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", mod)   # its dataclass looks it up
    spec.loader.exec_module(mod)
    return mod


def test_choose_path_for_every_chip_case():
    """Each chip_smoke.py case takes the path it asserts on the card (its
    tensors are fresh and 16-byte aligned); a view off alignment, f32 and
    hd 16/32 keep the CUDA-core path."""
    cases = _chip_smoke().MLSTM_CASES
    assert len(cases) == 9
    for name, B, S, H, hd, dtname, gates, path in cases:
        assert K.choose_path(getattr(torch, dtname), hd, True) == path, name
    assert K.choose_path(torch.bfloat16, 512, False) == "simt"
    assert K.choose_path(torch.float32, 512, True) == "simt"
    assert K.choose_path(torch.bfloat16, 32, True) == "simt"
    assert set(K.PATH_KERNELS) == set(K.PATHS)


def test_scratch_holds_the_entering_states():
    """One (hd*hd bf16 hi + lo, n, m) per (b, h) for every chunk after the
    first: none while S fits one chunk."""
    assert K.scratch_floats(4, 128, 4, 512) == 0
    assert K.scratch_floats(4, 1, 4, 512) == 0
    assert K.scratch_floats(2, 300, 4, 512) == 2 * 8 * (512 * 512 + 513)
    assert K.scratch_floats(2, 129, 4, 64) == 8 * (64 * 64 + 65)
