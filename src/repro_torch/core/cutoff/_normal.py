"""Normal CDF / inverse-CDF: float64 numpy reference + float32 torch twins.

A copy of ``repro.core.cutoff._normal``.  Acklam's rational approximation
of the inverse normal CDF is accurate to ~1.15e-9 in f64, which matches
the paper's printed figures (E[max] = 2.1063 at n=158).  The ``*_torch``
twins run the same rational approximation in the input's dtype (f32 on
the controller's decision path, on the CPU or inside the card's captured
graph); they agree with the numpy reference to f32 precision away from
the extreme tails.
"""
from __future__ import annotations

import math
from math import erf

import numpy as np
import torch

_A = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
      1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
_B = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
      6.680131188771972e+01, -1.328068155288572e+01]
_C = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
      -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
_D = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
      3.754408661907416e+00]
_P_LOW = 0.02425


def ndtri(p):
    """Inverse standard normal CDF (vectorized, float64)."""
    p = np.asarray(p, np.float64)
    plow, phigh = _P_LOW, 1 - _P_LOW

    lo = p < plow
    hi = p > phigh

    q = np.sqrt(-2 * np.log(np.where(lo, p, 0.5)))
    out_lo = ((((((_C[0] * q + _C[1]) * q + _C[2]) * q + _C[3]) * q + _C[4])
               * q + _C[5])
              / ((((_D[0] * q + _D[1]) * q + _D[2]) * q + _D[3]) * q + 1))
    q = p - 0.5
    r = q * q
    out_mid = ((((((_A[0] * r + _A[1]) * r + _A[2]) * r + _A[3]) * r + _A[4])
                * r + _A[5]) * q
               / (((((_B[0] * r + _B[1]) * r + _B[2]) * r + _B[3]) * r
                   + _B[4]) * r + 1))
    q = np.sqrt(-2 * np.log(np.where(hi, 1 - p, 0.5)))
    out_hi = -((((((_C[0] * q + _C[1]) * q + _C[2]) * q + _C[3]) * q + _C[4])
                * q + _C[5])
               / ((((_D[0] * q + _D[1]) * q + _D[2]) * q + _D[3]) * q + 1))
    return np.where(lo, out_lo, np.where(hi, out_hi, out_mid))


def ndtr(x):
    """Standard normal CDF (vectorized, float64)."""
    x = np.asarray(x, np.float64)
    return 0.5 * (1.0 + np.vectorize(erf)(x / np.sqrt(2.0)))


# ---------------------------------------------------------------------------
# torch twins (tensor-only: the controller's decision path).
# ---------------------------------------------------------------------------


def ndtri_torch(p: torch.Tensor) -> torch.Tensor:
    """Inverse standard normal CDF, Acklam's approximation in torch ops.

    Same branch structure as :func:`ndtri`; callers must keep ``p`` inside
    (0, 1) — in f32 that means clipping at ~1e-7 from either end.
    """
    plow, phigh = _P_LOW, 1 - _P_LOW

    lo = p < plow
    hi = p > phigh

    q = torch.sqrt(-2.0 * torch.log(torch.where(lo, p, 0.5)))
    out_lo = ((((((_C[0] * q + _C[1]) * q + _C[2]) * q + _C[3]) * q + _C[4])
               * q + _C[5])
              / ((((_D[0] * q + _D[1]) * q + _D[2]) * q + _D[3]) * q + 1))
    q = p - 0.5
    r = q * q
    out_mid = ((((((_A[0] * r + _A[1]) * r + _A[2]) * r + _A[3]) * r + _A[4])
                * r + _A[5]) * q
               / (((((_B[0] * r + _B[1]) * r + _B[2]) * r + _B[3]) * r
                   + _B[4]) * r + 1))
    q = torch.sqrt(-2.0 * torch.log(torch.where(hi, 1.0 - p, 0.5)))
    out_hi = -((((((_C[0] * q + _C[1]) * q + _C[2]) * q + _C[3]) * q + _C[4])
                * q + _C[5])
               / ((((_D[0] * q + _D[1]) * q + _D[2]) * q + _D[3]) * q + 1))
    return torch.where(lo, out_lo, torch.where(hi, out_hi, out_mid))


def ndtr_torch(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF in torch ops (``torch.erf``)."""
    return 0.5 * (1.0 + torch.erf(x / float(np.float32(math.sqrt(2.0)))))
