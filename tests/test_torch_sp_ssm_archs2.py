"""Port vs JAX package on the CPU: the SSM archs' ``train_sp`` step, part
2 of 3 (``test_torch_sp_ssm_archs.py`` says what is held): hymba-1.5b
(reduced: attention and Mamba heads in parallel, a global layer and
windowed ones with a window of 8), on (1, 2) and (1, 4), and with the
``attn_halo`` knob on at (1, 2) and (1, 4), where the windowed layers
fetch only the chunks their window reaches.  The Mamba heads' q/k rows
are broadcast over the heads into the recurrence, from each rank's
entering prefix.
"""

import pytest

from test_torch_sp_archs import arch_runs, check_sp, spawn_sp

RUNS = arch_runs(["hymba-1.5b"]) + [
    (f"hymba-1.5b-{'x'.join(map(str, sh))}-halo", "hymba-1.5b", sh,
     {"attn_halo": True}) for sh in ((1, 2), (1, 4))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_sp(RUNS, tmp_path_factory)


@pytest.mark.parametrize("label, name", [(r[0], r[1]) for r in RUNS])
def test_sp_ssm_psum_step_matches_reference_local(runs, label, name):
    check_sp(runs, label, name)
