"""Baseline cutoff controllers (the numpy-only part of ``repro.core.controller``).

Each controller implements::

    c = ctl.predict_cutoff()            # before the step (paper Alg. 1 l.23)
    ctl.observe(times, finished_mask)   # after the step (lines 25-26)

and ``resize(n_workers, col_map=None, model=None, members=None)`` for
elastic membership.  These are copies of the JAX package's prior-art
baselines: full sync, Chen et al.'s static cutoff and their backup-worker
(first-k) rule.  The paper's DMM controller needs the runtime model and a
twin of ``jax.random``, and comes with a later slice.
"""
from __future__ import annotations

from typing import Optional


class FullSyncController:
    def __init__(self, n_workers: int):
        self.n = n_workers

    def predict_cutoff(self) -> int:
        return self.n

    def observe(self, times, finished_mask=None):
        pass

    def resize(self, n_workers: int, col_map=None, model=None,
               members=None):
        """Elastic membership change: track the new worker count
        (width-only controllers ignore the global ``members`` ids)."""
        self.n = int(n_workers)


class StaticCutoffController(FullSyncController):
    """Chen et al. (2016): fixed c < n for the whole run."""

    def __init__(self, n_workers: int, cutoff: Optional[int] = None,
                 drop_frac: float = 0.06):
        super().__init__(n_workers)
        self.drop_frac = drop_frac
        self._cutoff = cutoff        # the configured cutoff, never clamped
        self.c = cutoff if cutoff is not None else max(
            1, int(round(n_workers * (1 - drop_frac))))

    def predict_cutoff(self) -> int:
        return self.c

    def resize(self, n_workers: int, col_map=None, model=None,
               members=None):
        super().resize(n_workers, col_map, model, members)
        if self._cutoff is not None:
            # clamp to the live width but keep the configured value, so a
            # transient shrink doesn't permanently lower the baseline
            self.c = min(self._cutoff, self.n)
        else:
            self.c = max(1, int(round(self.n * (1 - self.drop_frac))))


class FirstKController(FullSyncController):
    """Chen et al. (2016) backup-workers baseline: accept the first
    ``n - b`` gradient arrivals BY COUNT, where ``b`` backup workers are
    provisioned to absorb stragglers.

    The distinction from :class:`StaticCutoffController` is the
    parameterization: the backup COUNT is fixed capacity (Chen et al.
    provision b extra machines), so a resize keeps ``b`` constant and the
    cutoff moves with the live width — shrink a 32-worker job to 24 and a
    4-backup config still accepts the first 20, not ``24 * (1 - 4/32)``.
    Count-based acceptance never consults the runtime distribution, which
    is exactly the error–runtime trade-off the paper's DMM controller
    beats (tests/test_controllers.py races it on wall-clock-to-loss).
    """

    def __init__(self, n_workers: int, backup: Optional[int] = None,
                 backup_frac: float = 0.04):
        super().__init__(n_workers)
        self.backup = (int(backup) if backup is not None
                       else max(1, int(round(n_workers * backup_frac))))

    def predict_cutoff(self) -> int:
        return max(1, self.n - self.backup)

    # resize: FullSyncController already tracks the live width; the backup
    # count deliberately stays fixed (it is provisioned capacity).
