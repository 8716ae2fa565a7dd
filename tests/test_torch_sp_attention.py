"""Port vs JAX package on the CPU: ``attention_sp`` under ``train_sp``.

On a (1, R) ("data", "model") mesh of R = 2 and 4 gloo ranks
(``launch.ranks.sp_attention``) each rank holds its columns of q, k and
v; its rows of the output and the gradients of its columns (the k/v
gather's backward a reduce-scatter, the halo's the reverse sends) are
held against the reference's LOCAL ``attn_core`` over the whole
sequence and ``jax.vjp`` of it, at 2e-5 (f32, ``tests/test_kernels.py``'s
flash bar): causal; gemma3's reduced sliding window of 8 with the
``attn_halo`` knob off and on (at R = 4 and S 16 the window reaches two
4-column chunks back: rank 0 gets none, rank 1 one, the others two); the
encoder's non-causal self-attention; and cross-attention over another
sequence's keys.  Halo on is held against halo off at
``tests/sharded/knob_equiv_check.py``'s bars (1e-4 absolute, 1e-3
relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.attention import attn_core as j_attn_core
from repro_torch.launch import ranks

TOL = 2e-5
KNOB_ATOL, KNOB_RTOL = 1e-4, 1e-3       # knob_equiv_check.py
B, S, H, KV, HD = 2, 16, 4, 2, 16
SE = 32                                 # cross-attention's key length
WINDOW = 8                              # gemma3-12b's reduced window

CASES = {
    "causal": dict(causal=True, window=0, halo=False, Sk=S),
    "window": dict(causal=True, window=WINDOW, halo=False, Sk=S),
    "window_halo": dict(causal=True, window=WINDOW, halo=True, Sk=S),
    "encoder": dict(causal=False, window=0, halo=False, Sk=S),
    "cross": dict(causal=False, window=0, halo=False, Sk=SE),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    out = []
    for name, c in CASES.items():
        if name == "window_halo":     # the same inputs as "window"
            out.append(dict(out[-1], halo=True))
            continue
        out.append(dict(
            q=rng.standard_normal((B, S, H, HD)).astype(np.float32),
            k=rng.standard_normal((B, c["Sk"], KV, HD)).astype(np.float32),
            v=rng.standard_normal((B, c["Sk"], KV, HD)).astype(np.float32),
            cot=rng.standard_normal((B, S, H, HD)).astype(np.float32),
            causal=c["causal"], window=c["window"], halo=c["halo"]))
    return out


def _reference(c):
    """The reference's LOCAL attn_core over the whole sequence (queries at
    0..S-1, keys at 0..Sk-1), its output and (dq, dk, dv)."""
    qpos = jnp.broadcast_to(jnp.arange(S), (B, S))
    kpos = jnp.arange(c["k"].shape[1])

    def f(q, k, v):
        return j_attn_core(q, k, v, qpos, kpos, causal=c["causal"],
                           window=c["window"])

    y, vjp = jax.vjp(f, *(jnp.asarray(c[n]) for n in "qkv"))
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(c["cot"]))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for T in (2, 4):
        cases = _inputs(seed=T)
        pg = tmp_path_factory.mktemp(f"spa{T}") / "pg"
        out[T] = (cases, ranks.spawn(ranks.sp_attention, T, cases,
                                     init_method=f"file://{pg}"))
    return out


def _rows(a, T, s):
    n = a.shape[1] // T
    return a[:, s * n:(s + 1) * n]


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_attention_sp_matches_reference_attn_core(runs, T, case):
    cases, per_rank = runs[T]
    i = list(CASES).index(case)
    want_y, want_g = _reference(cases[i])
    for s, rank in enumerate(per_rank):
        y, grads, sends = rank[i]
        # the halo exchanges chunks (a batch of sends forward, one back)
        # where its window reaches fewer than R - 1 chunks: at R = 4 only
        assert sends == (2 if case == "window_halo" and T == 4 else 0)
        np.testing.assert_allclose(y, _rows(want_y, T, s), rtol=0, atol=TOL,
                                   err_msg=f"{case} rank {s} output")
        for name, got, want in zip("qkv", grads, want_g):
            np.testing.assert_allclose(
                got, _rows(want, T, s), rtol=0, atol=TOL,
                err_msg=f"{case} rank {s} d{name}")


@pytest.mark.parametrize("T", [2, 4])
def test_attn_halo_on_equals_off(runs, T):
    cases, per_rank = runs[T]
    on, off = list(CASES).index("window_halo"), list(CASES).index("window")
    for s, rank in enumerate(per_rank):
        (y_on, g_on, _), (y_off, g_off, _) = rank[on], rank[off]
        np.testing.assert_allclose(y_on, y_off, rtol=KNOB_RTOL,
                                   atol=KNOB_ATOL)
        for a, b in zip(g_on, g_off):
            np.testing.assert_allclose(a, b, rtol=KNOB_RTOL, atol=KNOB_ATOL)
