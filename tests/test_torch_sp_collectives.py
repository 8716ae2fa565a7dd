"""The sequence-parallel collectives of ``train_sp`` (the port's
``dist.collectives``) on 2 and 4 gloo ranks against numpy, forward and
backward, and the layout helpers of ``dist.sharding``.

Each collective runs on a (1, R) ("data", "model") mesh under
``make_layout(mesh, "train_sp")`` (``launch.ranks.sp_collectives``) on
float64 pieces of one seeded array, with one seeded cotangent a rank;
the outputs and the gradients (the backward is each forward's transpose:
the all-gather's a reduce-scatter, the halo's and the ring's the reverse
sends, the all-to-all's the same exchange of the gradients, the
re-blocking of an untied head's rows the inverse exchange; the model
sums' the identity, the mean's 1/R) are held to 1e-12.
"""

import numpy as np
import pytest
import torch

from repro_torch.dist import sharding as shd
from repro_torch.launch import ranks
from repro_torch.perf.knobs import knobs, use_knobs

TOL = 1e-12
B, N, D = 2, 3, 5          # N columns a rank
A2A_ROWS = 2
W_COLS = 4                 # vocab columns a rank


def _data(T, seed=0):
    rng = np.random.default_rng(seed)
    S = N * T

    def rand(*shape):
        return rng.standard_normal(shape)

    return {"x": rand(B, S, D),
            "cot_gather": rand(T, B, S, D),
            "cot_halo1": rand(T, B, S, D), "cot_halo2": rand(T, B, S, D),
            "blocks": rand(T, 4, D), "cot_ring": rand(T, 4, D),
            "a2a": rand(T, T, A2A_ROWS, D),
            "cot_a2a": rand(T, T, A2A_ROWS, D),
            "w": rand(2 * T, W_COLS * T),
            "cot_vocab": rand(T, 2 * T, W_COLS),
            "v": rand(T, 3), "cot_v": rand(T, 3)}


def _want(d, T, s):
    """The numpy outputs and gradients rank s must give."""
    x, n = d["x"], N
    cols = lambda a, t: a[:, t * n:(t + 1) * n]          # noqa: E731
    out = {"gather": (x, sum(cols(d["cot_gather"][t], s) for t in range(T))),
           "ring": (d["blocks"][(s + 1) % T], d["cot_ring"][(s - 1) % T]),
           "a2a": (np.stack([d["a2a"][t][s] for t in range(T)]),
                   np.stack([d["cot_a2a"][t][s] for t in range(T)])),
           "sum": (d["v"].sum(0), d["cot_v"][s]),
           "mean": (d["v"].mean(0), d["cot_v"][s] / T)}
    out["act_gather"] = out["gather"]
    g = np.zeros_like(x)
    g[:, s * n:(s + 1) * n] = d["cot_gather"][s][:, :n]
    out["act_slice"] = (cols(x, s), g)
    for h in (1, 2):
        m = min(h, s)
        cot = d[f"cot_halo{h}"]
        grad = cols(cot[s], m).copy()
        for j in range(1, h + 1):
            if s + j < T:
                grad += cols(cot[s + j], min(h, s + j) - j)
        out[f"halo{h}"] = (x[:, (s - m) * n:(s + 1) * n], grad)
    w, rows = d["w"], d["w"].shape[0] // T
    full = np.concatenate([d["cot_vocab"][t] for t in range(T)], axis=1)
    out["vocab"] = (w[:, s * W_COLS:(s + 1) * W_COLS],
                    full[s * rows:(s + 1) * rows])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for T in (2, 4):
        d = _data(T, seed=T)
        calls = [(ranks.sp_collectives, (d,), {})]
        pg = tmp_path_factory.mktemp(f"spc{T}") / "pg"
        out[T] = (d, ranks.spawn(ranks.several, T, calls,
                                 init_method=f"file://{pg}"))
    return out


NAMES = ["gather", "act_gather", "act_slice", "halo1", "halo2", "ring",
         "a2a", "vocab", "sum", "mean"]


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_sequence_collective_and_its_backward_match_numpy(runs, T, name):
    d, per_rank = runs[T]
    for s, rank in enumerate(per_rank):
        got_y, (got_g,) = rank[0][name]
        want_y, want_g = _want(d, T, s)[name]
        assert got_y.shape == want_y.shape, (name, s)
        np.testing.assert_allclose(got_y, want_y, rtol=0, atol=TOL,
                                   err_msg=f"{name} rank {s} output")
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=TOL,
                                   err_msg=f"{name} rank {s} gradient")


class _Mesh:
    """A mesh by shape alone, with this rank's coordinates."""

    def __init__(self, shape, axes, coords):
        self.axis_names, self.shape = tuple(axes), dict(zip(axes, shape))
        self.coords = dict(zip(axes, coords))

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i


def test_seq_span_shard_and_act_under_train_sp():
    x = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    lay = shd.make_layout(_Mesh((2, 4), ("data", "model"), (1, 2)),
                          "train_sp")
    assert lay.dp == ("data",) and lay.seq_axis == "model"
    assert shd.is_zero3(lay) and shd.seq_parallel(lay)
    shd.require_data_parallel(lay, "a step")
    assert shd.seq_span(8, lay) == (4, 2)
    assert shd.seq_span(8) == (0, 8)              # LOCAL
    with shd.use_layout(lay):
        assert torch.equal(shd.seq_shard(x), x[:, 4:6])
        assert torch.equal(shd.seq_shard(x.reshape(2, 3, 8), 2),
                           x.reshape(2, 3, 8)[:, :, 4:6])
        # a local tensor is kept, a full one sliced: the caller says which
        assert shd.act(x, "dp", "sp", None) is x
        assert torch.equal(shd.act(x, "dp", "sp", None, seq="full"),
                           x[:, 4:6])
        assert shd.act(x, "dp", None, None, seq="full") is x
        with pytest.raises(ValueError, match="does not divide by 4"):
            shd.seq_span(6)
        with pytest.raises(ValueError, match="seq="):
            shd.act(x, "dp", "sp", None, seq="global")
    for mode in ("train_fsdp", "decode_tp"):
        assert not shd.seq_parallel(shd.make_layout(
            _Mesh((2, 4), ("data", "model"), (0, 0)), mode))


def test_attn_halo_is_a_knob_with_the_reference_default():
    assert knobs().attn_halo is False
    with use_knobs(attn_halo=True):
        assert knobs().attn_halo is True
    assert knobs().attn_halo is False
