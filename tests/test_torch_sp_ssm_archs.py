"""Port vs JAX package on the CPU: the SSM archs' ``train_sp`` step, part
1 of 3: xlstm-350m (reduced: 3 mLSTM and 1 sLSTM blocks) on (1, 2) and
(1, 4); both archs on (2, 2) are in ``test_torch_sp_ssm_archs3.py``, so
each file stays under a minute.

One psum step of plain SGD at lr 1 under ``make_layout(mesh,
"train_sp")`` on ("data", "model") meshes of gloo ranks, W = 4 with shard_check's mask (1, 0, 1, 1) at S 16, held
against the reference's LOCAL ``make_train_step`` at the bars of
``tests/sharded/shard_check.py`` (loss within 2e-4, the aggregated
gradient within 2e-2) on every rank, as ``test_torch_sp_archs.py`` holds
the attention archs.  Under ``train_sp`` each rank's mLSTM columns start
from the exclusive prefix of the ranks before it, its conv reads the
previous rank's last three positions, and the sLSTM runs the gathered
sequence whole.
"""

import pytest

from test_torch_sp_archs import arch_runs, check_sp, spawn_sp

RUNS = arch_runs(["xlstm-350m"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_sp(RUNS, tmp_path_factory)


@pytest.mark.parametrize("label, name", [(r[0], r[1]) for r in RUNS])
def test_sp_ssm_psum_step_matches_reference_local(runs, label, name):
    check_sp(runs, label, name)
