"""Port vs JAX package on the CPU: every attention arch's ``train_sp``
step, part 2 of 5 (``test_torch_sp_archs.py`` says what is held): the
dense archs stablelm-3b and gemma3-12b, gemma3's sliding windows also
with the ``attn_halo`` knob on at (1, 4) (its window of 8 reaches two
4-column chunks back).
"""

import pytest

from test_torch_sp_archs import arch_runs, check_sp, spawn_sp

RUNS = arch_runs(["stablelm-3b", "gemma3-12b"]) + [
    ("gemma3-12b-1x4-halo", "gemma3-12b", (1, 4), {"attn_halo": True})]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_sp(RUNS, tmp_path_factory)


@pytest.mark.parametrize("label, name", [(r[0], r[1]) for r in RUNS])
def test_sp_psum_step_matches_reference_local(runs, label, name):
    check_sp(runs, label, name)
