"""The SSM cores under ``train_sp`` on 2 and 4 gloo ranks against the JAX
package's LOCAL functions, forward and backward.

Each rank holds its columns of one seeded sequence (``launch.ranks.sp_ssm``
on a (1, R) ("data", "model") mesh): ``linear_recurrence`` (the exclusive
prefix across ranks) normalized, normalized over two 128-position chunks
a rank, and unnormalized with Hymba's q/k rows broadcast over the heads;
``kernels.ops.mlstm`` (the card's flow: a rank's own final state, the
gathered prefix, a second call from it; here on the plain version) in
both forms; ``causal_conv1d`` (the halo from the rank before); and
``slstm_apply`` (the gathered, replicated scan).  A loss reads the
outputs and, where there is one, the final state, which every rank holds
whole.  Held against ``repro.models.ssm`` on the whole sequence: the
outputs' columns, the final state on every rank, each input's gradient
columns and each weight's gradient summed over the ranks, at REL_TOL of
each one's largest magnitude (f32; the ranks chunk the sequence
otherwise than the reference's one call, so sums run in other orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import ssm as JS
from repro_torch.launch import ranks

REL_TOL = 1e-5
B = 2


def _gates(rng, *shape):
    g = -np.logaddexp(0.0, -(rng.standard_normal(shape) + 3.0))
    return g.astype(np.float32), (0.5 * rng.standard_normal(shape)).astype(
        np.float32)


def _rec_case(kind, S, seed, *, H=2, dq=16, dv=16, heads=None):
    """q, k (B, S, H, dq) -- or rows (B, S, dq) broadcast over ``heads``
    heads, the unnormalized form at scale 1 -- v (B, S, H, dv), the log
    gates and the cotangents of y and of the final state."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    H = heads or H
    qk = (B, S, dq) if heads else (B, S, H, dq)
    g, i = _gates(rng, B, S, H)
    return {"kind": kind, "cols": "qkvgi", "q": 0.5 * n(*qk),
            "k": 0.5 * n(*qk), "v": n(B, S, H, dv), "g": g, "i": i,
            "heads": heads,
            "form": ({"normalize": False, "scale": 1.0} if heads
                     else {"normalize": True}),
            "cot": n(B, S, H, dv),
            "cot_final": [n(B, H), n(B, H), n(B, H, dq, dv), n(B, H, dq)]}


def _conv_case(S, seed, C=8, cw=4):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"kind": "conv", "cols": ("x",), "weights": ("w", "b"),
            "x": n(B, S, C), "w": n(cw, C), "b": n(C), "cot": n(B, S, C)}


def _slstm_case(S, seed, D=16, nh=2):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    hd = D // nh
    return {"kind": "slstm", "cols": ("x",), "weights": ("bias", "r", "w"),
            "n_heads": nh, "x": n(B, S, D),
            "w": n(D, 4 * D) / np.float32(np.sqrt(D)),
            "r": n(4, nh, hd, hd) / np.float32(np.sqrt(hd)),
            "bias": 0.1 * n(4 * D), "cot": n(B, S, D),
            "cot_final": [n(B, nh, hd) for _ in range(4)]}


def _cases():
    return {
        "rec": _rec_case("rec", 64, 1),
        "rec_two_chunks": _rec_case("rec", 512, 2),
        "rec_unnormalized": _rec_case("rec", 64, 3, dq=8, dv=16, heads=3),
        "ops": _rec_case("rec_ops", 64, 4),
        "ops_unnormalized": _rec_case("rec_ops", 64, 5, dq=8, dv=16,
                                      heads=3),
        "conv": _conv_case(16, 6),
        "slstm": _slstm_case(16, 7),
    }


NAMES = list(_cases())
#: two chunks a rank at T 2; at T 4 a rank's 128 columns are one chunk
ONLY_T2 = ("rec_two_chunks",)


def _names(T):
    return [n for n in NAMES if T == 2 or n not in ONLY_T2]


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(y, final or None, the gradients of the inputs then the weights)
    of the JAX package's LOCAL function on the whole sequence."""
    c = _cases()[name]
    names = list(c["cols"]) + list(c.get("weights", ()))
    args = [jnp.asarray(c[k]) for k in names]
    n_in = len(c["cols"])

    def run(*a):
        ins, ws = a[:n_in], a[n_in:]
        if c["kind"] in ("rec", "rec_ops"):
            q, k, v, g, i = ins
            if c["heads"]:
                q, k = (jnp.broadcast_to(t[:, :, None], (*t.shape[:2],
                        c["heads"], t.shape[-1])) for t in (q, k))
            return JS.linear_recurrence(q, k, v, g, i, **c["form"])
        if c["kind"] == "conv":
            return JS.causal_conv1d(ins[0], *ws), None
        return JS.slstm_apply(dict(zip(c["weights"], ws)), ins[0],
                              c["n_heads"])

    def loss(*a):
        y, final = run(*a)
        total = jnp.sum(y * c["cot"])
        if final is not None:
            total += sum(jnp.sum(t * r) for t, r in zip(final,
                                                        c["cot_final"]))
        return total, (y, final)

    (_, (y, final)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
    final = None if final is None else [np.asarray(t) for t in final]
    return np.asarray(y), final, [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = _cases()
    out = {}
    for T in (2, 4):
        pg = tmp_path_factory.mktemp(f"spssm{T}") / "pg"
        res = ranks.spawn(ranks.sp_ssm, T, [cases[n] for n in _names(T)],
                          init_method=f"file://{pg}")
        out[T] = {n: [r[j] for r in res] for j, n in enumerate(_names(T))}
    return out


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= REL_TOL, (what, err)


@pytest.mark.parametrize("T, name", [(T, n) for n in NAMES
                                     for T in (2, 4) if n in _names(T)])
def test_ssm_core_under_train_sp_matches_reference_local(runs, T, name):
    c = _cases()[name]
    want_y, want_final, want_g = _reference(name)
    per_rank = runs[T][name]
    _close(np.concatenate([r[0] for r in per_rank], axis=1), want_y,
           f"{name} T{T} y")
    n_in = len(c["cols"])
    for j in range(n_in):
        got = np.concatenate([r[2][j] for r in per_rank], axis=1)
        _close(got, want_g[j], f"{name} T{T} d{c['cols'][j]}")
    for j in range(n_in, len(want_g)):
        _close(sum(r[2][j] for r in per_rank), want_g[j],
               f"{name} T{T} d{c['weights'][j - n_in]}")
    if want_final is not None:
        for s, r in enumerate(per_rank):
            for t, (a, b) in enumerate(zip(r[1], want_final)):
                _close(a, b, f"{name} T{T} rank {s} final[{t}]")
