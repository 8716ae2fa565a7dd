"""Port vs JAX package on the CPU: every attention arch's ``train_sp``
step, part 3 of 5 (``test_torch_sp_archs.py`` says what is held):
deepseek-moe-16b, whose expert banks stay sharded over "model" (expert
parallelism: each rank routes its own tokens and one all-to-all takes
them to the experts' owners and back).
"""

import pytest

from test_torch_sp_archs import arch_runs, check_sp, spawn_sp

RUNS = arch_runs(["deepseek-moe-16b"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_sp(RUNS, tmp_path_factory)


@pytest.mark.parametrize("label, name", [(r[0], r[1]) for r in RUNS])
def test_sp_psum_step_matches_reference_local(runs, label, name):
    check_sp(runs, label, name)
