"""Port vs JAX package on the CPU: every attention arch's ``train_sp``
step, part 5 of 5 (``test_torch_sp_archs.py`` says what is held):
qwen2-vl-7b (M-RoPE's (3, B, S) positions and the patch merge over each
rank's columns) and phi3.5-moe-42b-a6.6b (expert parallelism: its
reduced form's 8 experts over 2 or 4 ranks, no shared expert).
"""

import pytest

from test_torch_sp_archs import arch_runs, check_sp, spawn_sp

RUNS = arch_runs(["qwen2-vl-7b", "phi3.5-moe-42b-a6.6b"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_sp(RUNS, tmp_path_factory)


@pytest.mark.parametrize("label, name", [(r[0], r[1]) for r in RUNS])
def test_sp_psum_step_matches_reference_local(runs, label, name):
    check_sp(runs, label, name)
