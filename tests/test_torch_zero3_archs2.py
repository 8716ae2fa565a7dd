"""Port vs JAX package on the CPU: every arch's ZeRO-3 step, part 2 of 4
(``test_torch_zero3_archs.py`` says what is held).
"""

import pytest

from test_torch_zero3_archs import check_arch, spawn_archs

ARCHS = ['hymba-1.5b', 'phi3.5-moe-42b-a6.6b', 'qwen2-0.5b']


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_archs(ARCHS, tmp_path_factory)


@pytest.mark.parametrize("name", ARCHS)
def test_zero3_psum_step_matches_reference_local(runs, name):
    check_arch(runs, name)
