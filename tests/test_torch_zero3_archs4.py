"""Port vs JAX package on the CPU: every arch's ZeRO-3 step, part 4 of 4
(``test_torch_zero3_archs.py`` says what is held).
"""

import pytest

from test_torch_zero3_archs import check_arch, spawn_archs

ARCHS = ['whisper-base', 'xlstm-350m']


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_archs(ARCHS, tmp_path_factory)


@pytest.mark.parametrize("name", ARCHS)
def test_zero3_psum_step_matches_reference_local(runs, name):
    check_arch(runs, name)
