"""The ``Trainer`` under ``train_sp`` on gloo ranks, on the CPU.

A reduced qwen2-0.5b (2 layers) trains under first-k with stale reuse
(decay 0.5), W = 4, seq 16, on (1, 2) and (2, 2) ("data", "model")
meshes (``launch.ranks.zero3_trainer`` in ``train_sp``: the state held
as ZeRO-3 shards, the sequence over "model").  Only the lead rank, the
first of every rank of the dp and model axes, holds the controller and
the timer; its decision reaches the others by one broadcast a step, and
it writes the checkpoints.  Four steps, checkpointed every two, are
held against the one-process trainer's at the bars of
``tests/test_torch_zero3_ckpt.py`` (losses within 1e-4, parameters
within 1e-3), the ranks' gathered states equal, and the checkpoint of
step 4 loads into the one-process trainer, bit for bit.
"""

import numpy as np
import pytest

from repro_torch import tree
from repro_torch.launch import ranks
from test_torch_zero3_train import setup

KW = dict(stale_decay=0.5, mode="train_sp")
AXES = ("data", "model")


def _equal(a, b):
    return all(np.array_equal(x, y)
               for x, y in zip(tree.leaves(a), tree.leaves(b)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _, tc, _, p0 = setup()
    d = tmp_path_factory.mktemp("sptr")
    solo = ranks.zero3_trainer(tc, p0, None, None, 4, None,
                               stale_decay=0.5)
    out = {}
    for shape in ((1, 2), (2, 2)):
        ck = str(d / "x".join(map(str, shape)))
        out[shape] = (ck, ranks.spawn(
            ranks.zero3_trainer, int(np.prod(shape)), tc, p0, shape, AXES,
            4, ck, init_method=f"file://{d}/pg{shape[0]}{shape[1]}", **KW))
    restored = {shape: ranks.zero3_trainer(tc, p0, None, None, 0, ck,
                                           stale_decay=0.5)
                for shape, (ck, _) in out.items()}
    return solo, out, restored


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_train_sp_trainer_matches_the_one_process_trainer(runs, shape):
    solo, out, restored = runs
    _, per_rank = out[shape]
    for rank in per_rank:
        assert rank["step"] == 4
        np.testing.assert_allclose(rank["losses"], solo["losses"], rtol=0,
                                   atol=1e-4)
        gap = max(float(np.abs(a - b).max()) for a, b in
                  zip(tree.leaves(rank["params"]),
                      tree.leaves(solo["params"])))
        assert gap < 1e-3
        assert _equal(rank["params"], per_rank[0]["params"])
    # the lead's checkpoint is the one-process trainer's file
    back = restored[shape]
    assert back["step"] == 4
    for key in ("params", "m", "v"):
        assert _equal(back[key], per_rank[0][key]), key
