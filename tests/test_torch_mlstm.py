"""Port mLSTM / SSM cores vs the JAX package, on the CPU.

The port's ``mlstm_chunk`` wrapper takes its plain version (the chunked
``linear_recurrence``) for CPU tensors.  It is held to the JAX sequential
oracle ``ref.reference_mlstm``, to ``ssm.linear_recurrence`` and, where S is
a multiple of the Pallas chunk, to ``mlstm_chunk(interpret=True)``, at
atol = rtol = 5e-4 as in tests/test_kernels.py; the final state is held to
JAX's raw (same chunking) and through one decode step.  ``recurrence_step``,
``causal_conv1d`` and ``slstm_apply`` are held to JAX at 1e-5 in f32.
Inputs are made with numpy from a seed and handed to both.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mlstm_chunk import mlstm_chunk as jmlstm
from repro.models import ssm as JS
from repro_torch.kernels import build, ops
from repro_torch.kernels import mlstm_chunk as K
from repro_torch.kernels.ref import reference_mlstm
from repro_torch.models import ssm as TS

torch.set_num_threads(2)

TOL = 5e-4
TOL_F32 = 1e-5


def _inputs(seed, B, S, H, hd, *, f_bias=3.0):
    """q/k/v (B,S,H,hd) and log gates g/i (B,S,H), f32, as the xLSTM
    block makes them: g = log_sigmoid(forget logits)."""
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((B, S, H, hd))).astype(np.float32)
    k = (0.5 * rng.standard_normal((B, S, H, hd))).astype(np.float32)
    v = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    f = rng.standard_normal((B, S, H)) + f_bias
    g = (-np.logaddexp(0.0, -f)).astype(np.float32)
    i = (0.5 * rng.standard_normal((B, S, H))).astype(np.float32)
    return q, k, v, g, i


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _state_np(st):
    return [np.asarray(t) for t in st]


@pytest.mark.parametrize("S", [1, 7, 128, 200])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_plain_mlstm_matches_jax(S, hd):
    arrs = _inputs(S * 100 + hd, 2, S, 2, hd)
    y, st = K.mlstm_chunk(*_t(*arrs))
    assert y.dtype == torch.float32 and y.shape == (2, S, 2, hd)
    want = jref.reference_mlstm(*_j(*arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    jy, jst = JS.linear_recurrence(*_j(*arrs), normalize=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    # the same chunking as JAX's: the raw state agrees too
    for got, exp in zip(st, _state_np(jst)):
        np.testing.assert_allclose(got.numpy(), exp, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("S,chunk", [(1, 1), (7, 7), (128, 64), (200, 40)])
def test_plain_mlstm_matches_pallas_interpret(S, chunk):
    arrs = _inputs(7 + S, 1, S, 2, 32)
    want = jmlstm(*_j(*arrs), chunk=chunk, interpret=True)
    y, _ = ops.mlstm(*_t(*arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("S", [7, 200])
def test_final_state_through_a_decode_step(S):
    B, H, hd = 2, 2, 32
    arrs = _inputs(11 + S, B, S + 1, H, hd)
    head = [a[:, :S] for a in arrs]
    step = [a[:, S] for a in arrs]
    _, st = ops.mlstm(*_t(*head))
    got, new = TS.recurrence_step(st, *_t(*step))
    _, jst = JS.linear_recurrence(*_j(*head), normalize=True)
    want, jnew = JS.recurrence_step(jst, *_j(*step), normalize=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # and the step continues the sequence the oracle runs in one go
    full = jref.reference_mlstm(*_j(*arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(full)[:, S],
                               atol=TOL, rtol=TOL)
    # the true memory C * exp(m) agrees however the states were chunked
    true_c = new.C * torch.exp(new.m)[..., None, None]
    want_c = np.asarray(jnew.C) * np.exp(np.asarray(jnew.m))[..., None, None]
    np.testing.assert_allclose(true_c.numpy(), want_c, atol=TOL, rtol=TOL)


def test_plain_mlstm_extreme_gates():
    B, S, H, hd = 1, 70, 2, 16
    rng = np.random.default_rng(3)
    q, k, v, _, _ = _inputs(3, B, S, H, hd)
    f = rng.choice([-10.0, 10.0], size=(B, S, H))
    g = (-np.logaddexp(0.0, -f)).astype(np.float32)
    i = rng.uniform(-10.0, 10.0, size=(B, S, H)).astype(np.float32)
    y, _ = ops.mlstm(*_t(q, k, v, g, i))
    want = jref.reference_mlstm(*_j(q, k, v, g, i))
    assert np.isfinite(y.numpy()).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_port_oracle_matches_jax_oracle():
    arrs = _inputs(5, 2, 33, 2, 16)
    got = reference_mlstm(*_t(*arrs))
    want = jref.reference_mlstm(*_j(*arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32,
                               rtol=TOL_F32)


def test_linear_recurrence_init_state_matches_jax():
    arrs = _inputs(9, 2, 24, 2, 16)
    first = [a[:, :10] for a in arrs]
    rest = [a[:, 10:] for a in arrs]
    _, st = TS.linear_recurrence(*_t(*first), chunk=5)
    _, jst = JS.linear_recurrence(*_j(*first), chunk=5, normalize=True)
    y, fin = TS.linear_recurrence(*_t(*rest), chunk=7, init_state=st)
    jy, jfin = JS.linear_recurrence(*_j(*rest), chunk=7, normalize=True,
                                    init_state=jst)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    for got, exp in zip(fin, _state_np(jfin)):
        np.testing.assert_allclose(got.numpy(), exp, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("start", ["random", "identity"])
def test_recurrence_step_matches_jax(start):
    """A step from a random state, and from the identity (a decode that
    starts from no prompt state: m = -1e30, C = n = 0)."""
    B, H, hd = 3, 2, 16
    rng = np.random.default_rng(12)
    state = [rng.standard_normal((B, H)).astype(np.float32),
             rng.standard_normal((B, H)).astype(np.float32),
             rng.standard_normal((B, H, hd, hd)).astype(np.float32),
             rng.standard_normal((B, H, hd)).astype(np.float32)]
    tst, jst = TS.ScanState(*_t(*state)), JS.ScanState(*_j(*state))
    if start == "identity":
        tst, jst = TS.state_identity(tst), JS.state_identity(jst)
    q, k, v, g, i = (a[:, 0] for a in _inputs(13, B, 1, H, hd))
    got, new = TS.recurrence_step(tst, *_t(q, k, v, g, i))
    want, jnew = JS.recurrence_step(jst, *_j(q, k, v, g, i), normalize=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32,
                               rtol=TOL_F32)
    for a, b in zip(new, _state_np(jnew)):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL_F32, rtol=TOL_F32)


def _mamba_inputs(seed, B, S, H, dq, dv):
    """Hymba's Mamba-head inputs as numpy: c/b (B,S,dq), shared by every
    head, v (B,S,H,dv), and the f32 gates of softplus dt, g = -dt exp(a)
    and i = log(dt + 1e-9)."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((B, S, dq)).astype(np.float32)
    b = rng.standard_normal((B, S, dq)).astype(np.float32)
    v = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, H)) - 2.0)
    a = 0.3 * rng.standard_normal(H)
    g = (-dt * np.exp(a)).astype(np.float32)
    i = np.log(dt + 1e-9).astype(np.float32)
    return c, b, v, g, i


def _bcast(c, b, v, g, i):
    """Torch and JAX arguments: q/k broadcast over the heads (an expand
    view in torch, its head stride 0, as the Hymba block passes them)."""
    H = v.shape[2]
    tq, tk = (torch.from_numpy(a)[:, :, None].expand(-1, -1, H, -1)
              for a in (c, b))
    jq, jk = (jnp.broadcast_to(jnp.asarray(a)[:, :, None],
                               a.shape[:2] + (H, a.shape[2]))
              for a in (c, b))
    return ([tq, tk, *_t(v, g, i)], [jq, jk, *_j(v, g, i)])


@pytest.mark.parametrize("S,chunk", [(16, 128), (64, 16), (40, 8)])
def test_unnormalized_recurrence_matches_jax(S, chunk):
    """Hymba's form (normalize=False, scale=1, q/k 8 wide over v 32 wide)
    against JAX's linear_recurrence at 1e-5, one chunk and chunk splits:
    y, the raw final state (the same chunking on both sides), and the
    wrapper's and ops' route on CPU tensors."""
    t_args, j_args = _bcast(*_mamba_inputs(S + chunk, 2, S, 3, 8, 32))
    assert t_args[0].stride(2) == 0
    y, st = TS.linear_recurrence(*t_args, chunk=chunk, normalize=False,
                                 scale=1.0)
    jy, jst = JS.linear_recurrence(*j_args, chunk=chunk, normalize=False,
                                   scale=1.0)
    assert y.shape == (2, S, 3, 32) and st.C.shape == (2, 3, 8, 32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL_F32,
                               rtol=TOL_F32)
    for got, exp in zip(st, _state_np(jst)):
        np.testing.assert_allclose(got.numpy(), exp, atol=TOL_F32,
                                   rtol=TOL_F32)
    if chunk == 128:
        for fn in (K.mlstm_chunk, ops.mlstm):
            y2, _ = fn(*t_args, normalize=False, scale=1.0)
            assert torch.equal(y2, y)


def test_unnormalized_output_does_not_depend_on_the_chunk():
    """The stabilizer of the unnormalized output is the state's running
    max, the same whatever the chunking: 128 (one chunk), 16 and 8 agree
    at 1e-5 (the kernel walks 32 a chunk)."""
    t_args, _ = _bcast(*_mamba_inputs(21, 2, 128, 3, 8, 32))
    ys = [TS.linear_recurrence(*t_args, chunk=c, normalize=False,
                               scale=1.0)[0] for c in (128, 16, 8)]
    for y in ys[1:]:
        np.testing.assert_allclose(y.numpy(), ys[0].numpy(), atol=TOL_F32,
                                   rtol=TOL_F32)


def test_unnormalized_init_state_and_scale_match_jax():
    """The unnormalized form continued from a prompt's state (init_state),
    and a scale other than 1, against JAX at 1e-5."""
    t_args, j_args = _bcast(*_mamba_inputs(23, 2, 30, 3, 8, 32))
    t_first, t_rest = [a[:, :12] for a in t_args], [a[:, 12:] for a in t_args]
    j_first, j_rest = [a[:, :12] for a in j_args], [a[:, 12:] for a in j_args]
    for scale in (1.0, 0.3):
        _, st = TS.linear_recurrence(*t_first, chunk=4, normalize=False,
                                     scale=scale)
        _, jst = JS.linear_recurrence(*j_first, chunk=4, normalize=False,
                                      scale=scale)
        y, fin = TS.linear_recurrence(*t_rest, chunk=6, init_state=st,
                                      normalize=False, scale=scale)
        jy, jfin = JS.linear_recurrence(*j_rest, chunk=6, normalize=False,
                                        scale=scale, init_state=jst)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL_F32,
                                   rtol=TOL_F32)
        for got, exp in zip(fin, _state_np(jfin)):
            np.testing.assert_allclose(got.numpy(), exp, atol=TOL_F32,
                                       rtol=TOL_F32)


@pytest.mark.parametrize("start", ["prompt", "identity"])
def test_unnormalized_recurrence_step_matches_jax(start):
    """Hymba's decode step (normalize=False, scale=1) from a prompt's state
    and from the identity, against JAX at 1e-5; a step from the prompt's
    state continues the sequence the chunked form runs in one go."""
    c, b, v, g, i = _mamba_inputs(31, 2, 13, 3, 8, 32)
    t_args, j_args = _bcast(c, b, v, g, i)
    head_t, head_j = [a[:, :12] for a in t_args], [a[:, :12] for a in j_args]
    step_t, step_j = [a[:, 12] for a in t_args], [a[:, 12] for a in j_args]
    _, st = TS.linear_recurrence(*head_t, normalize=False, scale=1.0)
    _, jst = JS.linear_recurrence(*head_j, normalize=False, scale=1.0)
    if start == "identity":
        st, jst = TS.state_identity(st), JS.state_identity(jst)
    got, new = TS.recurrence_step(st, *step_t, normalize=False, scale=1.0)
    want, jnew = JS.recurrence_step(jst, *step_j, normalize=False, scale=1.0)
    assert got.shape == (2, 3, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32,
                               rtol=TOL_F32)
    for a, e in zip(new, _state_np(jnew)):
        np.testing.assert_allclose(a.numpy(), e, atol=TOL_F32, rtol=TOL_F32)
    if start == "prompt":
        full, _ = TS.linear_recurrence(*t_args, normalize=False, scale=1.0)
        np.testing.assert_allclose(got.numpy(), full[:, 12].numpy(),
                                   atol=TOL_F32, rtol=TOL_F32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    init = rng.standard_normal((2, 3, 12)).astype(np.float32)
    kw = {"init_state": init} if with_state else {}
    got = TS.causal_conv1d(*_t(x, w, b),
                           **{k: torch.from_numpy(a) for k, a in kw.items()})
    want = JS.causal_conv1d(*_j(x, w, b),
                            **{k: jnp.asarray(a) for k, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32,
                               rtol=TOL_F32)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_apply_matches_jax(with_state):
    B, S, D, nh = 2, 6, 32, 4
    jp = JS.slstm_init(jax.random.PRNGKey(1), D, nh, jnp.float32)
    pnp = {k: np.array(a) for k, a in jp.items()}
    pnp["bias"] = (0.3 * np.random.default_rng(2).standard_normal(
        pnp["bias"].shape)).astype(np.float32)
    x = np.random.default_rng(3).standard_normal((B, S, D)).astype(np.float32)
    init = None
    if with_state:
        rng = np.random.default_rng(6)
        c, n, h = (rng.standard_normal((B, nh, D // nh)).astype(np.float32)
                   for _ in range(3))
        init = (c, np.abs(n) + 1.0, h, 0.1 * c)
    got, gst = TS.slstm_apply({k: torch.from_numpy(a) for k, a in pnp.items()},
                              torch.from_numpy(x), nh,
                              init_state=None if init is None else
                              tuple(_t(*init)))
    want, wst = JS.slstm_apply({k: jnp.asarray(a) for k, a in pnp.items()},
                               jnp.asarray(x), nh,
                               init_state=None if init is None else
                               tuple(_j(*init)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32,
                               rtol=TOL_F32)
    for a, b in zip(gst, wst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_F32,
                                   rtol=TOL_F32)


def test_cpu_mlstm_launches_no_kernel(monkeypatch):
    def no_build(name):
        raise AssertionError(f"CPU tensors built kernel {name}")

    monkeypatch.setattr(build, "load", no_build)
    build.LAUNCHES.clear()
    arrs = _inputs(1, 1, 9, 2, 16)
    y, st = ops.mlstm(*_t(*arrs))
    assert dict(build.LAUNCHES) == {}
    assert "mlstm_chunk" in build.SOURCES
    assert y.device.type == "cpu" and isinstance(st, TS.ScanState)
    assert st.C.shape == (1, 2, 16, 16) and st.m.shape == (1, 2)


def test_wrapper_refuses_other_devices_and_bad_shapes():
    q, k, v, g, i = (t.to("meta") for t in _t(*_inputs(1, 1, 4, 2, 16)))
    with pytest.raises(ValueError, match="no path for device"):
        K.mlstm_chunk(q, k, v, g, i)
    q, k, v, g, i = _t(*_inputs(1, 1, 4, 2, 16))
    with pytest.raises(ValueError, match="g, i"):
        K.mlstm_chunk(q, k, v, g[:, :3], i)
    with pytest.raises(ValueError, match="alike"):
        K.mlstm_chunk(q, k[..., :8], v, g, i)


def test_wgmma_path_keeps_the_square_normalized_form():
    """The tensor-core path takes bf16, hd a multiple of 64, aligned, v as
    wide as q/k and the normalized form; Hymba's form (unnormalized, q/k
    16 wide, v 128 wide) goes to the CUDA-core path.  The wrapper takes v
    wider than q/k and refuses q/k or v whose leading dims differ."""
    bf16 = torch.bfloat16
    assert K.choose_path(bf16, 64, True) == "wgmma"
    assert K.choose_path(bf16, 64, True, dv=64) == "wgmma"
    assert K.choose_path(bf16, 64, True, dv=128) == "simt"
    assert K.choose_path(bf16, 64, True, normalize=False) == "simt"
    assert K.choose_path(bf16, 16, True, dv=128, normalize=False) == "simt"
    t_args, _ = _bcast(*_mamba_inputs(41, 1, 5, 2, 8, 32))
    y, st = K.mlstm_chunk(*t_args, normalize=False, scale=1.0)
    assert y.shape == (1, 5, 2, 32) and st.n.shape == (1, 2, 8)
    q, k, v, g, i = t_args
    with pytest.raises(ValueError, match="alike"):
        K.mlstm_chunk(q, k, v[:, :4], g, i, normalize=False)


def test_kernels_layer_imports_no_model_module():
    """Dependencies point down: the kernels (and their plain versions)
    import nothing of ``repro_torch.models``; ``models.ssm`` takes the
    recurrence from ``kernels.mlstm_plain``."""
    kdir = pathlib.Path(K.__file__).parent
    for path in sorted(kdir.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.startswith("repro_torch.models")
                           for n in names), (path.name, names)
    from repro_torch.kernels import mlstm_plain
    assert TS.linear_recurrence is mlstm_plain.linear_recurrence
    assert TS.ScanState is K.ScanState is mlstm_plain.ScanState
