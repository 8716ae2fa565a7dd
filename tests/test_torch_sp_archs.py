"""Port vs JAX package on the CPU: every attention arch's ``train_sp``
step, part 1 of 5.

Each attention arch (reduced; MoE at a capacity factor of n_experts)
takes one psum step of plain SGD at lr 1 under ``make_layout(mesh,
"train_sp")`` (the batch over "data", the sequence over "model", the
parameters ZeRO-3 over "model") on (1, 2) and (1, 4) ("data", "model")
meshes of gloo ranks, W = 4 with shard_check's mask (1, 0, 1, 1) at
S 16, and is held against the reference's LOCAL ``make_train_step`` at
the bars of ``tests/sharded/shard_check.py``: loss within 2e-4, the
aggregated gradient (the parameters' change) within 2e-2, on every
rank.  This file also runs the vocab-ring CE through the step, for the
tied head (qwen2-0.5b) and the untied one (starcoder2-3b), and holds the
helpers; the other archs are in ``test_torch_sp_archs*.py`` so each
file stays under a minute.
"""

import functools

import numpy as np
import pytest

import jax

from repro.models import model as JM
from repro_torch import tree, weights
from test_torch_zero3_archs import (GRAD_TOL, LOSS_TOL, _batch, _reduced,
                                    _reference)
from repro_torch.launch import ranks

AXES = ("data", "model")


def spawn_sp(runs, tmp_path_factory):
    """``runs``: (label, arch, mesh shape, knobs) -> {label: [(loss, p0 -
    p1) on each rank]}, one process group a mesh shape."""
    out, p0s = {}, {}
    for shape in dict.fromkeys(r[2] for r in runs):
        calls, labels = [], []
        for label, name, sh, kn in runs:
            if sh != shape:
                continue
            jc, tc = _reduced(name)
            params = JM.init_model(jc, jax.random.PRNGKey(0))
            p0 = tree.map(lambda x: x.numpy(), weights.from_jax(
                tc, jax.tree.map(np.asarray, params), device="cpu"))
            p0s[label] = [x.astype(np.float32) for x in tree.leaves(p0)]
            calls.append((ranks.zero3_steps,
                          (tc, p0, [_batch(jc)], "psum", 1.0, shape, AXES),
                          dict(optimizer="sgd", mode="train_sp",
                               knobs=kn)))
            labels.append(label)
        tag = "sp" + "x".join(map(str, shape))
        pg = tmp_path_factory.mktemp(tag) / "pg"
        res = ranks.spawn(ranks.several, int(np.prod(shape)), calls,
                          init_method=f"file://{pg}")
        for i, label in enumerate(labels):
            out[label] = [(rank[i][0][0]["loss"],
                           [a - b for a, b in zip(p0s[label],
                                                  tree.leaves(rank[i][1]))])
                          for rank in res]
    return out


@functools.lru_cache(maxsize=None)
def reference(name):
    """The reference's LOCAL step of ``name``, once a process."""
    return _reference(name)


def check_sp(runs, label, name):
    want_loss, want_g = reference(name)
    assert max(float(np.abs(g).max()) for g in want_g) > 0
    for r, (loss, got_g) in enumerate(runs[label]):
        assert abs(loss - want_loss) < LOSS_TOL, (label, r, loss, want_loss)
        assert len(got_g) == len(want_g)
        gap = max(float(np.abs(a - b).max()) for a, b in zip(got_g, want_g))
        assert gap < GRAD_TOL, (label, r, gap)


def arch_runs(names, shapes=((1, 2), (1, 4))):
    return [(f"{name}-{'x'.join(map(str, sh))}", name, sh, None)
            for sh in shapes for name in names]


RUNS = arch_runs(["qwen2-0.5b", "starcoder2-3b"]) + [
    (f"{name}-1x4-ring", name, (1, 4), {"ce_impl": "ring"})
    for name in ("qwen2-0.5b", "starcoder2-3b")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_sp(RUNS, tmp_path_factory)


@pytest.mark.parametrize("label, name", [(r[0], r[1]) for r in RUNS])
def test_sp_psum_step_matches_reference_local(runs, label, name):
    check_sp(runs, label, name)
