"""Port vs JAX package on the CPU: every attention arch's ``train_sp``
step, part 4 of 5 (``test_torch_sp_archs.py`` says what is held):
whisper-base (the encoder over each rank's columns of the frames,
cross-attention over the gathered encoder output), and qwen2-0.5b on a
(2, 2) mesh (the batch over "data" too).
"""

import pytest

from test_torch_sp_archs import arch_runs, check_sp, spawn_sp

RUNS = (arch_runs(["whisper-base"])
        + arch_runs(["qwen2-0.5b"], shapes=((2, 2),)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_sp(RUNS, tmp_path_factory)


@pytest.mark.parametrize("label, name", [(r[0], r[1]) for r in RUNS])
def test_sp_psum_step_matches_reference_local(runs, label, name):
    check_sp(runs, label, name)
