"""Tree optimizers (the port's ``repro.optim.optimizers``).

An ``Optimizer`` is (init, update); ``update`` maps (grads, state, params)
-> (updates, state), where updates are *added* to params by
:func:`apply_updates` (learning rate folded in, sign flipped).  The step
count in the state is a host int, so schedules and Adam's bias corrections
are host float32 values and no device value is read back.

The one exception is ``adam(..., fused=True)``: its update writes p, m and v
IN PLACE through ``kernels.ops.adam_update_tree`` (one Hopper kernel launch
over every leaf on the card) and returns ``None`` as its updates, which
``apply_updates`` reads as "already applied".  In-place update is the
port's counterpart of the donated train state of the JAX package.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch import tree
from repro_torch.kernels import ops
from repro_torch.kernels.fused_adam import LeafTable

Schedule = Union[float, Callable[[int], np.float32]]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)
    #: the fused Adam's device leaf table (``uploads`` counts its rebuilds)
    table: Optional[LeafTable] = None


def _lr_at(lr: Schedule, step: int) -> np.float32:
    return np.float32(lr(step) if callable(lr) else lr)


def global_norm(t) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, on the leaves'
    device (a 0-d tensor, not read back)."""
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tree.leaves(t)]).sum())


def apply_updates(params, updates):
    """params + updates, each update cast to its param's dtype.  ``None``
    updates (the fused Adam's) mean the params were already updated in
    place."""
    if updates is None:
        return params
    return tree.map(lambda p, u: p + u.to(p.dtype), params, updates)


def _zeros_f32(params):
    return tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


# ---------------------------------------------------------------------------


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return {"step": 0}

    def update(grads, state, params=None):
        step = state["step"]
        lr_t = float(_lr_at(lr, step))
        ups = tree.map(lambda g: -lr_t * g.float(), grads)
        return ups, {"step": step + 1}

    return Optimizer(init, update)


def momentum(lr: Schedule, beta: float = 0.9, nesterov: bool = False
             ) -> Optimizer:
    def init(params):
        return {"step": 0, "mu": _zeros_f32(params)}

    def update(grads, state, params=None):
        step = state["step"]
        lr_t = float(_lr_at(lr, step))
        mu = tree.map(lambda m, g: beta * m + g.float(), state["mu"], grads)
        if nesterov:
            ups = tree.map(lambda m, g: -lr_t * (beta * m + g.float()),
                           mu, grads)
        else:
            ups = tree.map(lambda m: -lr_t * m, mu)
        return ups, {"step": step + 1, "mu": mu}

    return Optimizer(init, update)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0, *,
         fused: bool = False) -> Optimizer:
    """Adam(W).  ``fused=True`` updates p, m and v in place through
    ``kernels.ops.adam_update_tree``: the Hopper kernel on the card, its
    plain version on the CPU.  It computes p' directly, where the unfused
    path (and the JAX fused path) add an update p' - p back to p, so the two
    may differ by one rounding of p."""
    table = LeafTable() if fused else None

    def init(params):
        return {"step": 0, "m": _zeros_f32(params), "v": _zeros_f32(params)}

    def fused_update(grads, state, params):
        if params is None:
            raise ValueError("adam(fused=True) needs params at update time")
        step = state["step"]
        ops.adam_update_tree(params, grads, state["m"], state["v"], step,
                             _lr_at(lr, step), b1=b1, b2=b2, eps=eps,
                             wd=weight_decay, table=table)
        return None, {"step": step + 1, "m": state["m"], "v": state["v"]}

    def update(grads, state, params=None):
        if fused:
            return fused_update(grads, state, params)
        step = state["step"] + 1
        lr_t = _lr_at(lr, state["step"])
        m = tree.map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree.map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        t = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        lr_f = float(lr_t)
        lr_wd = float(lr_t * np.float32(weight_decay))

        def upd(m_, v_, p):
            u = -(lr_f * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps))
            if weight_decay:
                u = u - lr_wd * p.float()
            return u

        ups = tree.map(upd, m, v, params if weight_decay else m)
        return ups, {"step": step, "m": m, "v": v}

    return Optimizer(init, update, table)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01, *,
          fused: bool = False) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay, fused=fused)


def clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    def update(grads, state, params=None):
        gn = global_norm(grads)
        scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
        grads = tree.map(lambda g: g * scale.to(g.dtype), grads)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update, opt.table)


def chain(*fns):
    """Compose gradient-mapping callables before an optimizer's update."""
    *pre, opt = fns

    def update(grads, state, params=None):
        for f in pre:
            grads = f(grads)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update, opt.table)
