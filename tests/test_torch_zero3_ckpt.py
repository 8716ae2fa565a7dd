"""The ZeRO-3 ``Trainer``'s checkpoints on 2 gloo ranks, on the CPU.

A reduced qwen2-0.5b (2 layers) trains under first-k with stale reuse
(decay 0.5), W = 4, on a (1, 2) ("data", "model") mesh with zero1
(``launch.ranks.zero3_trainer``: the state held as shards, a checkpoint
gathered and written by rank 0 every 2 steps).  A run resumed from its
own step-2 checkpoint (the timer advanced to step 2) takes steps 3-4 as
the uninterrupted run does: losses, params, m and v bit for bit.  A
one-process trainer's checkpoint loads into the ZeRO-3 trainer and a
ZeRO-3 checkpoint into a one-process trainer, each state bit-equal to
the one saved; the runs they continue stay within the reference's bars
of the uninterrupted ones.
"""

import numpy as np
import pytest

from repro_torch import tree
from repro_torch.checkpoint import store
from repro_torch.launch import ranks
from test_torch_zero3_train import setup

MESH = ((1, 2), ("data", "model"))
KW = dict(zero1=True, stale_decay=0.5)


def _equal(a, b):
    return all(np.array_equal(x, y)
               for x, y in zip(tree.leaves(a), tree.leaves(b)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _, tc, _, p0 = setup()
    d = tmp_path_factory.mktemp("ck")
    full, part, one = (str(d / n) for n in ("full", "part", "one"))
    # the one-process trainer: 2 steps into "one", and 4 uninterrupted
    solo2 = ranks.zero3_trainer(tc, p0, None, None, 2, one, **KW)
    solo4 = ranks.zero3_trainer(tc, p0, None, None, 4, None, **KW)
    calls = [(ranks.zero3_trainer, (tc, p0) + MESH + (4, full), KW),
             (ranks.zero3_trainer, (tc, p0) + MESH + (2, part), KW),
             (ranks.zero3_trainer, (tc, p0) + MESH + (2, part), KW),
             (ranks.zero3_trainer, (tc, p0) + MESH + (2, one), KW)]
    pg = d / "pg"
    out = ranks.spawn(ranks.several, 2, calls, init_method=f"file://{pg}")
    names = ("full", "part", "resumed", "from_one")
    got = {n: [rank[i] for rank in out] for i, n in enumerate(names)}
    # a one-process trainer restores the uninterrupted ZeRO-3 run's newest
    # checkpoint (step 4)
    solo_from_z3 = ranks.zero3_trainer(tc, p0, None, None, 0, full, **KW)
    return dict(got=got, solo2=solo2, solo4=solo4,
                solo_from_z3=solo_from_z3, dirs=(full, part, one))


def test_zero3_resume_equals_the_uninterrupted_run(runs):
    got = runs["got"]
    for full, part, resumed in zip(got["full"], got["part"],
                                   got["resumed"]):
        assert part["step"] == 2 and resumed["step"] == 4
        assert _equal(resumed["restored"], part["params"])
        assert resumed["losses"] == full["losses"][2:]
        for key in ("params", "m", "v"):
            assert _equal(resumed[key], full[key]), key
    # the ranks' gathered states agree
    assert _equal(got["full"][0]["params"], got["full"][1]["params"])


def test_a_zero3_checkpoint_is_the_one_process_trainers_file(runs):
    full, part, one = runs["dirs"]
    for d in (full, part, one):
        assert store.groups(d, 2) == ["ctl", "meta", "stale", "state"]
    solo = runs["solo_from_z3"]
    assert solo["step"] == 4
    for key in ("params", "m", "v"):
        assert _equal(solo[key], runs["got"]["full"][0][key]), key


def test_a_one_process_checkpoint_loads_into_the_zero3_trainer(runs):
    solo2, solo4 = runs["solo2"], runs["solo4"]
    for rank in runs["got"]["from_one"]:
        assert _equal(rank["restored"], solo2["params"])
        assert rank["step"] == 4
        np.testing.assert_allclose(rank["losses"], solo4["losses"][2:],
                                   rtol=0, atol=1e-4)
        gap = max(float(np.abs(a - b).max()) for a, b in
                  zip(tree.leaves(rank["params"]),
                      tree.leaves(solo4["params"])))
        assert gap < 1e-3
    # the ZeRO-3 run is the one-process run's within the same bars
    for a, b in zip(runs["got"]["full"][0]["losses"], solo4["losses"]):
        assert abs(a - b) < 1e-4
