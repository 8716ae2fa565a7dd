"""Port vs JAX package on the CPU: the data-parallel combine across ranks.

``core.aggregation.masked_psum_mean`` on gloo process groups of 2 and 4
ranks (one worker a rank, as the reference's shard_map runs it), and 8
workers on 2 ranks (4 a rank), each rank holding its contiguous block of
the worker dim, against the reference's ``masked_mean_local`` on the same
seeded numpy gradients: 0/1, fractional and all-zero masks, within rtol
and atol 1e-6 (f32: the ranks' sum runs in another order than one pass).
The all-ones mask equals ``psum_mean`` bit for bit, as the reference's
``tests/sharded/dist_check.py`` and ``mask_agg_check.py`` demand, and
every rank holds the same result.  A (2, 2) mesh reduces over one of its
axes at a time.  The kernel's sum mode (its plain version here) against
numpy, and ``collectives`` routing a tree and a ``WorkerGrads`` buffer.

The ranks are spawned processes (``repro_torch.launch.ranks``) whose
process group meets at a ``file://`` path under the test's tmp_path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregation import masked_mean_local as j_masked_mean_local
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.masked_grad_agg import masked_grad_agg
from repro_torch.launch import ranks

RTOL = ATOL = 1e-6


def _grads(W, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((W, 4, 6)).astype(np.float32),
            "b": rng.standard_normal((W, 16)).astype(np.float32),
            "deep": [{"k": rng.standard_normal((W, 3, 2, 5))
                      .astype(np.float32)}]}


def _masks(W, seed=0):
    rng = np.random.default_rng(seed + 1)
    bits = (rng.uniform(size=W) < 0.6).astype(np.float32)
    bits[0], bits[-1] = 1.0, 0.0        # at least one in, one dropped
    return {"bits": bits,
            "fractional": rng.uniform(size=W).astype(np.float32),
            "zero": np.zeros(W, np.float32),
            "ones": np.ones(W, np.float32)}


def _flat(t):
    return [t["b"], t["deep"][0]["k"], t["w"]]


def _jax_local(grads, mask):
    out = j_masked_mean_local(
        {k: jnp.asarray(v) if k != "deep" else
         [{"k": jnp.asarray(v[0]["k"])}] for k, v in grads.items()},
        jnp.asarray(mask))
    return [np.asarray(x) for x in _flat(out)]


@pytest.mark.parametrize("R, W", [(2, 2), (4, 4), (2, 8)])
def test_masked_psum_mean_matches_reference_local(tmp_path, R, W):
    grads, masks = _grads(W), _masks(W)
    names = list(masks)
    out = ranks.spawn(ranks.masked_means, R, grads,
                      [masks[n] for n in names],
                      init_method=f"file://{tmp_path}/pg")
    for r in range(R):
        for i, name in enumerate(names):
            got = _flat(out[r][i])
            want = _jax_local(grads, masks[name])
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"rank {r} {name}")
            # every rank holds the same bits
            for g, g0 in zip(got, _flat(out[0][i])):
                assert np.array_equal(g, g0)
        zero = _flat(out[r][names.index("zero")])
        assert all(np.all(z == 0.0) for z in zero)
        # the all-ones mask is psum_mean's code: equal bit for bit
        ones, plain = out[r][names.index("ones")], out[r][-1]
        for a, b in zip(_flat(ones), _flat(plain)):
            assert np.array_equal(a, b)


def test_masked_out_workers_have_no_influence(tmp_path):
    """The reference's dist_check property 2, across 2 ranks: poisoning
    the dropped workers' rows with 1e30 leaves the result bit-equal."""
    W = 8
    grads = _grads(W, seed=3)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    poisoned = {k: v.copy() if k != "deep" else [{"k": v[0]["k"].copy()}]
                for k, v in grads.items()}
    for leaf in _flat(poisoned):
        leaf[2], leaf[6] = 1e30, -1e30
    base, pois = (ranks.spawn(ranks.masked_means, 2, g, [mask],
                              init_method=f"file://{tmp_path}/pg{i}")[0][0]
                  for i, g in enumerate((grads, poisoned)))
    for a, b in zip(_flat(base), _flat(pois)):
        assert np.array_equal(a, b)


def test_reduction_over_one_axis_of_a_2x2_mesh(tmp_path):
    """4 ranks on a (2, 2) ("pod", "data") mesh: over ("data",) each pod's
    two ranks reduce their own pair of workers (two groups of two), over
    ("pod", "data") all four reduce together."""
    W = 4
    grads, mask = _grads(W, seed=5), _masks(W, seed=5)["fractional"]
    by_data = ranks.spawn(ranks.masked_means, 4, _grads(2, seed=5),
                          [mask[:2]], (2, 2), ("pod", "data"), ("data",),
                          init_method=f"file://{tmp_path}/pg_data")
    both = ranks.spawn(ranks.masked_means, 4, grads, [mask], (2, 2),
                       ("pod", "data"), ("pod", "data"),
                       init_method=f"file://{tmp_path}/pg_both")
    want_pair = _jax_local(_grads(2, seed=5), mask[:2])
    want_all = _jax_local(grads, mask)
    for r in range(4):
        for g, w in zip(_flat(by_data[r][0]), want_pair):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        for g, w in zip(_flat(both[r][0]), want_all):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("W, N", [(1, 7), (3, 1000), (8, 4097)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sum_mode_matches_numpy(W, N, dtype):
    rng = np.random.default_rng(W * N)
    g = rng.standard_normal((W, N)).astype(np.float32)
    m = rng.uniform(size=W).astype(np.float32)
    gt = torch.from_numpy(g).to(dtype)
    got = masked_grad_agg(gt, torch.from_numpy(m), mean=False)
    assert got.dtype == dtype and got.shape == (N,)
    want = (gt.float().numpy() * m[:, None]).sum(axis=0)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               want.astype(np.float32), rtol=tol, atol=tol)
    # into a caller's buffer, and the mean mode divides the same sum
    out = torch.empty(N, dtype=dtype)
    assert masked_grad_agg(gt, torch.from_numpy(m), mean=False,
                           out=out) is out
    assert torch.equal(out, got)
    mean = masked_grad_agg(gt, torch.from_numpy(m))
    c = max(float(m.sum(dtype=np.float32)), 1.0)
    np.testing.assert_allclose(mean.float().numpy(), want / c, rtol=tol,
                               atol=tol)
    with pytest.raises(ValueError, match="out must be"):
        masked_grad_agg(gt, torch.from_numpy(m), mean=False,
                        out=torch.empty(N + 1, dtype=dtype))


def test_collectives_route_trees_and_buffers_locally():
    """Under LOCAL (and a mesh layout with no dp axes) the one-process
    combine: a tree and a filled ``WorkerGrads`` buffer agree with the
    reference's ``masked_mean_local``, and grad_mean is the all-ones
    mask."""
    W = 4
    grads = _grads(W, seed=7)
    mask = _masks(W, seed=7)["bits"]
    tgrads = {k: torch.from_numpy(v) if k != "deep" else
              [{"k": torch.from_numpy(v[0]["k"])}] for k, v in grads.items()}
    want = _jax_local(grads, mask)
    buf = ops.WorkerGrads.of_stacked(tgrads)
    no_dp = shd.Layout(mesh=object(), mode="train_fsdp", dp=())
    for lay in (None, shd.LOCAL, no_dp):
        for src in (tgrads, buf):
            got = collectives.masked_grad_mean(src, torch.from_numpy(mask),
                                               lay)
            for g, w in zip(_flat(got), want):
                np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                           atol=ATOL)
    full = collectives.grad_mean(tgrads)
    ones = collectives.masked_grad_mean(tgrads, torch.ones(W))
    for a, b in zip(_flat(full), _flat(ones)):
        assert torch.equal(a, b)
