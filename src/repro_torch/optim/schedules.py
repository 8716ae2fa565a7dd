"""Learning-rate schedules of a host-int step, in float32 arithmetic.

Twins of ``repro.optim.schedules``: the same formulas in the same float32
operations, evaluated with numpy on the host, so the rate reaches the
kernel as an argument and no device value is read back.
"""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant(v: float):
    return lambda step: _F(v)


def linear_warmup(base: float, warmup_steps: int):
    def fn(step: int):
        s = _F(step)
        return _F(base) * np.minimum(_F(1.0), (s + _F(1))
                                     / _F(max(warmup_steps, 1)))
    return fn


def cosine_schedule(base: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step: int):
        s = _F(step)
        warm = _F(base) * np.minimum(_F(1.0), (s + _F(1))
                                     / _F(max(warmup_steps, 1)))
        t = np.clip((s - _F(warmup_steps))
                    / _F(max(total_steps - warmup_steps, 1)), _F(0), _F(1))
        cos = _F(final_frac) + _F(1 - final_frac) * _F(0.5) * (
            _F(1) + np.cos(_F(np.pi) * t))
        return warm * (_F(1.0) if s < _F(warmup_steps) else cos)
    return fn
