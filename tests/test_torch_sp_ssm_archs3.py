"""Port vs JAX package on the CPU: the SSM archs' ``train_sp`` step, part
3 of 3 (``test_torch_sp_ssm_archs.py`` says what is held): xlstm-350m and
hymba-1.5b on a (2, 2) ("data", "model") mesh, the batch over two dp
ranks and each rank's half of the sequence starting from the other's
state, in one process group.
"""

import pytest

from test_torch_sp_archs import arch_runs, check_sp, spawn_sp

RUNS = arch_runs(["xlstm-350m", "hymba-1.5b"], shapes=((2, 2),))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_sp(RUNS, tmp_path_factory)


@pytest.mark.parametrize("label, name", [(r[0], r[1]) for r in RUNS])
def test_sp_ssm_psum_step_matches_reference_local(runs, label, name):
    check_sp(runs, label, name)
