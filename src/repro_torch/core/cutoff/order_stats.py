"""Throughput-optimal cutoff from Monte-Carlo order statistics (paper §3).

A copy of ``repro.core.cutoff.order_stats``.  Throughput of waiting for the
fastest c of n workers:  Omega(c) = c / x_(c), where x_(c) is the c-th
order statistic of the joint runtime vector.  Given K predictive samples
of the next runtime vector, sort each, average Omega per cutoff, argmax.

Two implementations live side by side: the float64 numpy reference (host
path, easy to audit against the paper) and ``*_torch`` twins that run the
identical sort → curve → argmax logic in f32 on the tensors' device — the
controller's fused decision (``controller._observe_decide_core`` →
``RuntimeModel._decide_core``) calls those, so the whole decision is one
captured graph on the card with only the cutoff fetched to the host.
The JAX twins sort with a bitonic network because XLA's CPU sort is slow;
its values equal ``np.sort``'s, and so do ``torch.sort``'s.  The ragged
twins (``cutoff_and_iter_ragged_torch``) decide a stack of jobs of mixed
widths at once, for the multi-tenant parameter server (``repro_torch.ps``).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.cutoff.eps import OMEGA_FLOOR


def min_frac_floor(n: int, min_frac: float) -> int:
    """The smallest 0-based index the argmax may pick: c >= min_frac * n.

    Clamped so min_frac=1.0 degenerates to full sync instead of an empty
    argmax.  Shared by the numpy and torch cutoff implementations so the
    two paths can never disagree on the search window.
    """
    return min(int(np.ceil(min_frac * n)), n - 1)


def mc_order_stats(samples: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """samples: (K, n) -> (mean (n,), std (n,)) of each order statistic."""
    s = np.sort(np.asarray(samples), axis=1)
    return s.mean(axis=0), s.std(axis=0)


def throughput_curve(samples: np.ndarray) -> np.ndarray:
    """E[Omega(c)] for c = 1..n, from MC samples (K, n)."""
    s = np.sort(np.asarray(samples), axis=1)
    c = np.arange(1, s.shape[1] + 1, dtype=np.float64)
    return (c[None, :] / np.maximum(s, OMEGA_FLOOR)).mean(axis=0)


def optimal_cutoff(samples: np.ndarray, min_frac: float = 0.0) -> int:
    """argmax_c E[Omega(c)]; optionally restrict c >= min_frac * n.

    min_frac=0 reproduces the paper exactly; a floor (e.g. 0.5) bounds the
    gradient-noise increase when the model predicts an extreme tail.
    """
    omega = throughput_curve(samples)
    n = omega.shape[0]
    lo = min_frac_floor(n, min_frac)
    c = int(np.argmax(omega[lo:]) + lo) + 1
    return min(c, n)


def oracle_cutoff(actual: np.ndarray) -> int:
    """Best cutoff in hindsight for one observed runtime vector (n,)."""
    s = np.sort(np.asarray(actual))
    c = np.arange(1, s.shape[0] + 1, dtype=np.float64)
    return int(np.argmax(c / np.maximum(s, OMEGA_FLOOR))) + 1


def iter_time(actual: np.ndarray, c: int) -> float:
    """Wall-clock of one SGD iteration when waiting for the fastest c."""
    return float(np.sort(np.asarray(actual))[c - 1])


# ---------------------------------------------------------------------------
# torch twins (tensor-only: no host read, so they run inside a graph).
# ---------------------------------------------------------------------------


def mc_order_stats_torch(samples: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """samples: (K, n) -> (mean (n,), std (n,)) of each order statistic."""
    s = torch.sort(samples, dim=1).values
    return torch.mean(s, dim=0), torch.std(s, dim=0, correction=0)


def _omega(s: torch.Tensor) -> torch.Tensor:
    cs = torch.arange(1, s.shape[1] + 1, dtype=s.dtype, device=s.device)
    return torch.mean(cs[None, :] / torch.clamp(s, min=OMEGA_FLOOR), dim=0)


def throughput_curve_torch(samples: torch.Tensor) -> torch.Tensor:
    """E[Omega(c)] for c = 1..n, from MC samples (K, n)."""
    return _omega(torch.sort(samples, dim=1).values)


def _cutoff_from_sorted(s: torch.Tensor, lo: int) -> torch.Tensor:
    """Throughput argmax over PRE-SORTED samples (K, n), 0-based floor
    ``lo``: the one copy of the omega/argmax math of every torch cutoff
    entry point.  ``torch.argmax`` picks the first maximum, as
    ``jnp.argmax`` does."""
    n = s.shape[1]
    c = torch.argmax(_omega(s)[lo:]) + (lo + 1)
    return torch.clamp(c, max=n).to(torch.int32)


def cutoff_and_iter_torch(samples: torch.Tensor, lo: int):
    """(optimal cutoff int32, E[x_(c)] at that cutoff) from ONE shared
    sort: the decision and the posterior-predictive iteration wall time
    under it (what a multi-tenant scheduler ranks jobs by)."""
    s = torch.sort(samples, dim=1).values
    c = _cutoff_from_sorted(s, lo)
    col = (c.to(torch.int64) - 1).reshape(1)
    pred_iter = torch.mean(torch.index_select(s, 1, col))
    return c, pred_iter


def _cutoff_from_sorted_ragged(s: torch.Tensor, lo: torch.Tensor,
                               n_real: torch.Tensor) -> torch.Tensor:
    """Throughput argmax over PRE-SORTED samples (..., K, n_pad) whose last
    ``n_pad - n_real`` columns are +inf padding.

    ``lo`` and ``n_real`` are int tensors of the leading shape (a job axis
    (J,), or 0-d), so one captured graph serves every job width in a
    ragged bucket.  For ``n_real == n_pad`` the masked argmax scans the
    omega values ``_cutoff_from_sorted`` scans (padding contributes omega
    = c / inf = 0 outside the mask), so full-width jobs keep the static
    path's answer.
    """
    n = s.shape[-1]
    cs = torch.arange(1, n + 1, dtype=s.dtype, device=s.device)
    omega = torch.mean(cs / torch.clamp(s, min=OMEGA_FLOOR), dim=-2)
    i = torch.arange(n, device=s.device)
    valid = (i >= lo[..., None]) & (i < n_real[..., None])
    c = torch.argmax(torch.where(valid, omega, -math.inf), dim=-1) + 1
    return torch.minimum(c, n_real).to(torch.int32)


def cutoff_and_iter_ragged_torch(samples: torch.Tensor, lo: torch.Tensor,
                                 n_real: torch.Tensor):
    """Ragged twin of ``cutoff_and_iter_torch``: samples (..., K, n_pad)
    with +inf in the padded columns, per-job floors ``lo`` and real widths
    ``n_real``.  ``torch.sort`` puts the +inf pads above every real value,
    so the order statistics of the real workers land in columns
    [0, n_real) exactly as in a width-n_real sort (the reference's bitonic
    network gives the same values)."""
    s = torch.sort(samples, dim=-1).values
    c = _cutoff_from_sorted_ragged(s, lo, n_real)
    col = (c.to(torch.int64) - 1)[..., None, None].expand(
        s.shape[:-1] + (1,))
    pred_iter = torch.mean(torch.gather(s, -1, col)[..., 0], dim=-1)
    return c, pred_iter
