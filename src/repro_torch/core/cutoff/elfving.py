"""Analytic iid-normal order statistics — Elfving (1947)/Royston (1982).

A copy of ``repro.core.cutoff.elfving``, in float64 numpy:

    E[x_(j)] ~= mu + Phi^{-1}((j - pi/8) / (n - pi/4 + 1)) * sigma

This is the paper's "order" baseline (Eq. 3).  Paper validation (§4.1):
n=158, mu=1.057, sigma=0.393  =>  E[x_(158)] ~= 2.1063.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.cutoff._normal import ndtr, ndtri


def expected_order_stats(n: int, mu: float, sigma: float) -> np.ndarray:
    """E[x_(j)] for j = 1..n under iid N(mu, sigma^2)."""
    j = np.arange(1, n + 1, dtype=np.float64)
    alpha = math.pi / 8.0
    p = (j - alpha) / (n - 2 * alpha + 1.0)
    return mu + ndtri(p) * sigma


def expected_max(n: int, mu: float, sigma: float) -> float:
    return float(expected_order_stats(n, mu, sigma)[-1])


def expected_idle_fraction(n: int, mu: float, sigma: float) -> float:
    """Mean idle time per worker under full sync ~= E[x_(n)] - E[x_(n/2)]
    (paper Eq. 2)."""
    e = expected_order_stats(n, mu, sigma)
    return float(e[-1] - e[n // 2 - 1])


def elfving_cutoff(n: int, mu: float, sigma: float,
                   min_frac: float = 0.5) -> int:
    """Throughput-optimal cutoff under the iid-normality assumption.

    min_frac guards the degenerate low-c region: with mu/sigma ratios typical
    of runtime data, E[x_(1)] approaches 0 under the (wrong) normal model and
    Omega(1) explodes; real systems never drop more than half the batch.
    """
    e = np.maximum(expected_order_stats(n, mu, sigma), 1e-9)
    c = np.arange(1, n + 1, dtype=np.float64)
    lo = int(np.ceil(min_frac * n)) - 1
    return int(np.argmax((c / e)[lo:])) + lo + 1


def exact_order_stat_mean(n: int, j: int, mu: float = 0.0,
                          sigma: float = 1.0) -> float:
    """E[x_(j)] by numerical quadrature of the exact density (paper §3.1.1):

        E = Z(n,j) * int x phi(x) Phi(x)^{j-1} (1-Phi(x))^{n-j} dx

    The paper's printed 2.1063 for (n=158, mu=1.057, sigma=0.393) matches
    this exact integral; the Elfving approximation gives 2.1047.
    """
    x = np.linspace(-12.0, 12.0, 48_001)
    cdf = ndtr(x)
    logpdf = -0.5 * x * x - 0.5 * math.log(2 * math.pi)
    logz = math.lgamma(n + 1) - math.lgamma(j) - math.lgamma(n - j + 1)
    with np.errstate(divide="ignore"):
        logw = (logz + logpdf + (j - 1) * np.log(np.clip(cdf, 1e-300, None))
                + (n - j) * np.log(np.clip(1 - cdf, 1e-300, None)))
    w = np.exp(logw)
    e = np.trapezoid(x * w, x) / max(np.trapezoid(w, x), 1e-300)
    return mu + sigma * float(e)
