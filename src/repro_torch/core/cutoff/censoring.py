"""Censored run-time imputation (paper §4.2).

A copy of ``repro.core.cutoff.censoring``.  Workers dropped at the cutoff
never report their runtimes; the guide RNN was trained on fully-observed
vectors, so missing entries are imputed by sampling each worker's
predictive distribution left-truncated at the observed cutoff time x_(c):

    p(x | x > x_c) = p(x) / int_{x_c}^inf p(x) dx

Sampling via inverse-CDF on the truncated normal.

The numpy reference runs in f64 on the host; ``truncated_normal_sample_torch``
is the f32 twin the device controller fuses into its observe+decide.  Both
accept pre-drawn uniforms ``u`` so the two paths consume the SAME random
stream (``api.colwise_uniform``): that is what lets the backends give
identical cutoff sequences while the imputed values differ at f32
precision only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cutoff._normal import (ndtr as _ndtr,
                                             ndtr_torch as _ndtr_torch,
                                             ndtri as _ndtri,
                                             ndtri_torch as _ndtri_torch)
from repro_torch.core.cutoff.eps import CDF_CLIP, SIGMA_FLOOR, U_CLIP_LO


def truncated_normal_sample(mu, sigma, lower, rng=None, u=None) -> np.ndarray:
    """Sample x ~ N(mu, sigma^2) | x > lower (elementwise).

    Far in the right tail (lower >> mu) the CDF saturates and the
    inverse-CDF draw degenerates, so the result is clamped at ``lower`` —
    the correct limit of the truncated distribution as its mass above the
    bound vanishes.  The truncation CDF and the effective uniform are
    clipped at the shared ``eps`` constants, so the f64 and f32 twins
    sample the same capped-tail distribution.

    Uniforms come from ``u`` when given (shared-stream mode; shape of
    ``mu``), otherwise from ``rng.uniform``.
    """
    mu = np.asarray(mu, np.float64)
    lower = np.asarray(lower, np.float64)
    sigma = np.maximum(np.asarray(sigma, np.float64), SIGMA_FLOOR)
    a = _ndtr((lower - mu) / sigma)
    a = np.clip(a, 0.0, 1.0 - CDF_CLIP)
    if u is None:
        u = rng.uniform(size=mu.shape)
    u = a + (1.0 - a) * np.asarray(u, np.float64)
    return np.maximum(
        mu + sigma * _ndtri(np.clip(u, U_CLIP_LO, 1 - CDF_CLIP)), lower)


def impute_censored(observed: np.ndarray, finished_mask: np.ndarray,
                    pred_mu: np.ndarray, pred_std: np.ndarray,
                    cutoff_time: float, rng=None, u=None) -> np.ndarray:
    """Fill unobserved worker runtimes with truncated predictive samples.

    observed: (n,) runtimes (garbage where ~finished_mask);
    pred_mu/pred_std: (n,) per-worker predictive moments for THIS iteration.
    """
    imputed = truncated_normal_sample(pred_mu, pred_std,
                                      np.full_like(pred_mu, cutoff_time),
                                      rng, u=u)
    return np.where(finished_mask, observed, imputed)


# ---------------------------------------------------------------------------
# torch twins (tensor-only: fused into the controller's observe path).
# ---------------------------------------------------------------------------


def truncated_normal_sample_torch(mu, sigma, lower, u) -> torch.Tensor:
    """Twin of :func:`truncated_normal_sample` with explicit uniforms, in
    the inputs' dtype; the same clip epsilons as the reference."""
    sigma = torch.clamp(sigma, min=SIGMA_FLOOR)
    a = _ndtr_torch((lower - mu) / sigma)
    a = torch.clamp(a, 0.0, 1.0 - CDF_CLIP)
    uu = a + (1.0 - a) * u
    x = mu + sigma * _ndtri_torch(torch.clamp(uu, U_CLIP_LO, 1.0 - CDF_CLIP))
    return torch.maximum(x, lower)


def impute_censored_torch(observed, finished_mask, pred_mu, pred_std,
                          cutoff_time, u) -> torch.Tensor:
    """Twin of :func:`impute_censored`; ``cutoff_time`` is a 0-d tensor
    (it stays on the device)."""
    imputed = truncated_normal_sample_torch(
        pred_mu, pred_std, cutoff_time.expand(pred_mu.shape), u)
    return torch.where(finished_mask, observed, imputed)
