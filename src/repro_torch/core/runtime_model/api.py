"""RuntimeModel: ELBO training + real-time posterior-predictive inference.

The port of ``repro.core.runtime_model.api``.  Implements the paper's Eq. 5 approximation: sample z_{T-l:T}
trajectories from the guide, push the last-step marginal through the
transition and emission to obtain K Monte-Carlo samples of the next joint
runtime vector x_{T+1}.

Observations are normalized by 2x the mean of the first lag window (paper
§3.1.3) so one trained model transfers across network/batch-size scales.

Every draw comes from the ``jax.random`` twin (``repro_torch.random``)
with the reference's key layout, so a model with the reference's params
gives the reference's samples to f32 rounding.  Params live on
``device`` (``None`` means the card).

The multi-tenant server (``repro_torch.ps``) decides J jobs at once: the
ragged mode of ``_decide_core`` (``width=``) runs the same body over an
explicit leading job axis, on params stacked by ``stack_models_padded``
and laid out by ``batched_layout``, so the batched body launches about
the kernels of one job whatever J is.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import optim, resolve_device, tree
from repro_torch import random as R
from repro_torch.core.cutoff import order_stats
from repro_torch.core.runtime_model import dmm as D
from repro_torch.core.runtime_model import guide as G


# ---------------------------------------------------------------------------
# Width-stable per-column RNG: column i of a width-shaped draw is a function
# of (key, i) alone, so the same key gives the same columns at any padded
# width (the reference's contract for its ragged dispatch).
# ---------------------------------------------------------------------------


def _colwise_keys(key, n: int):
    """(..., n, 2): the n column keys of each key of the stack ``key``."""
    return R.fold_in(key[..., None, :], torch.arange(n, device=key.device))


def colwise_uniform(key, n: int):
    """(..., n) uniforms in [0, 1); entry i depends only on (key, i).  A
    key stack (J, 2) gives row j from ``key[j]``."""
    return R.uniform(_colwise_keys(key, n))


def colwise_normal(key, rows: int, n: int):
    """(..., rows, n) standard normals; column i depends only on
    (key, i)."""
    return R.normal(_colwise_keys(key, n), (rows,)).transpose(-1, -2)


@dataclass
class RuntimeModel:
    n_workers: int
    lag: int = 20
    z_dim: int = 32
    hidden: int = 64
    params: dict = field(default=None, repr=False)
    norm_scale: float = 1.0
    device: Optional[str] = None     # None = the card; raises without one

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------
    def init(self, seed: int = 0):
        """Seeded params, drawn on the CPU (so every device gets the same
        bits) and moved to ``device``."""
        k1, k2 = R.split(R.PRNGKey(seed))
        params = {
            "dmm": D.dmm_init(k1, self.n_workers, self.z_dim, self.hidden),
            "guide": G.guide_init(k2, self.n_workers, self.z_dim,
                                  self.hidden),
        }
        self.params = tree.map(lambda x: x.to(self.device), params)
        return self

    def to(self, device):
        """A copy of this model with its params on ``device``."""
        device = resolve_device(device)
        return RuntimeModel(self.n_workers, self.lag, self.z_dim,
                            self.hidden,
                            tree.map(lambda x: x.to(device), self.params),
                            self.norm_scale, device)

    # ------------------------------------------------------------------
    @staticmethod
    def _elbo(params, x, key):
        """x: (B, T, n) normalized windows. Single-sample ELBO."""
        zs, mus, stds = G.guide_sample(params["guide"], x, key)
        dmm = params["dmm"]
        B, T, n = x.shape
        # log p(x_t | z_t)
        emu, estd = D.emission(dmm, zs)
        lpx = torch.sum(D.gaussian_logpdf(x, emu, estd), dim=(1, 2))
        # log p(z_t | z_{t-1}) (z_0 prior from learned z0)
        z_prev = torch.cat([dmm["z0_mu"].expand(B, 1, zs.shape[-1]),
                            zs[:, :-1]], dim=1)
        tmu, tstd = D.transition(dmm, z_prev)
        lpz = torch.sum(D.gaussian_logpdf(zs, tmu, tstd), dim=(1, 2))
        # log q(z_t | ...)
        lqz = torch.sum(D.gaussian_logpdf(zs, mus, stds), dim=(1, 2))
        return torch.mean(lpx + lpz - lqz)

    def elbo(self, x, key):
        return self._elbo(self.params, x, key)

    # ------------------------------------------------------------------
    def fit(self, traces: np.ndarray, *, steps: int = 800, batch: int = 16,
            lr: float = 3e-3, seed: int = 0, verbose: bool = False,
            clip: float = 5.0):
        """traces: (T_total, n) raw runtimes from the instrumented cluster.

        Step for step the reference's fit: the same numpy batch indices,
        ``key = PRNGKey(seed + 1)`` split once a step, Adam under a global
        norm clip, the gradient of -ELBO by autograd.  Returns the losses
        as floats, fetched once at the end (or every 100 steps when
        ``verbose``)."""
        traces = np.asarray(traces, np.float32)
        assert traces.shape[1] == self.n_workers
        self.norm_scale = float(2.0 * traces[: self.lag + 1].mean())
        xs = traces / self.norm_scale
        T = self.lag + 1
        n_windows = xs.shape[0] - T
        if n_windows < 1:
            raise ValueError("trace too short for the lag window")
        windows = torch.as_tensor(
            np.stack([xs[i:i + T] for i in range(n_windows)]),
            device=self.device)

        if self.params is None:
            self.init(seed)
        opt = optim.clip_by_global_norm(optim.adam(lr), clip)
        params = self.params
        state = opt.init(params)

        rng = np.random.default_rng(seed)
        key = R.PRNGKey(seed + 1, device=self.device)
        losses = []
        for i in range(steps):
            idx = rng.integers(0, n_windows, size=min(batch, n_windows))
            key, sub = R.split(key)
            batch_x = windows[torch.as_tensor(idx, device=self.device)]
            flat = [p.detach().requires_grad_(True)
                    for p in tree.leaves(params)]
            loss = -self._elbo(tree.unflatten(params, flat), batch_x, sub)
            # z0_logstd takes no part in the ELBO: its gradient is zero
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = tree.unflatten(params, [
                torch.zeros_like(p) if g is None else g
                for p, g in zip(flat, grads)])
            ups, state = opt.update(grads, state, params)
            params = optim.apply_updates(
                tree.map(lambda p: p.detach(), params), ups)
            losses.append(loss.detach())
            if verbose and i % 100 == 0:
                print(f"  elbo step {i}: -elbo={float(losses[-1]):.3f}")
        self.params = params
        return torch.stack(losses).tolist()

    # ------------------------------------------------------------------
    @staticmethod
    def _predict(params, window_norm, key, k_samples: int):
        """window_norm: (T, n) -> K samples of x_{T+1} plus (mu, std)."""
        x = window_norm[None].expand((k_samples,) + window_norm.shape)
        k1, k2, k3, _ = R.split(key, 4)
        zs, _, _ = G.guide_sample(params["guide"], x, k1)
        z_T = zs[:, -1]                                   # (K, zd)
        tmu, tstd = D.transition(params["dmm"], z_T)
        z_next = tmu + tstd * R.normal(k2, tmu.shape)
        emu, estd = D.emission(params["dmm"], z_next)     # (K, n)
        x_next = emu + estd * colwise_normal(k3, k_samples, emu.shape[1])
        return x_next, emu, estd

    def predict_next(self, window: np.ndarray, k_samples: int = 64,
                     seed: int = 0):
        """window: (lag+1, n) raw runtimes.

        Returns (samples (K, n), mu (K, n), std (K, n)) in RAW time units,
        as f32 numpy arrays.
        """
        w = torch.as_tensor(np.asarray(window, np.float32),
                            device=self.device) / self.norm_scale
        key = R.PRNGKey(seed, device=self.device)
        with torch.no_grad():
            s, mu, std = self._predict(self.params, w, key, k_samples)
        return tuple(t.cpu().numpy() * self.norm_scale for t in (s, mu, std))

    # ------------------------------------------------------------------
    # Fused decision (the controller's hot path).
    # ------------------------------------------------------------------
    @staticmethod
    def _decide_core(params, ring, head, key, norm_scale, k_samples: int,
                     lo, width=None):
        """guide → transition → emission → sample → sort → argmax → moments
        over the ring buffer: the decision body of the controller's fused
        observe+decide (``controller._observe_decide_core``).

        ``width=None`` (the single-job path): ring (lag+1, n) raw f32
        runtime rows; ``head`` (a 0-d int64 tensor on the ring's device)
        the index of the OLDEST row; ``norm_scale`` and ``lo`` python
        numbers.  The window is gathered at ``(arange + head) % (lag+1)``
        on the device, so neither it nor ``head`` is read by the host.
        RNG layout mirrors ``_predict`` (split(key, 4), k1/k2/k3), with the
        guide's broadcast form.

        A ``width`` tensor selects the RAGGED mode, the multi-tenant
        server's, over an explicit leading job axis: params stacked and
        laid out by ``batched_layout(stack_models_padded(...))``, rings
        (J, lag+1, n_pad), heads, ``norm_scale``, ``lo`` and ``width`` (J,)
        tensors, keys (J, 2).  Columns >= width are padding: they are
        zeroed out of the guide's input and their samples forced to +inf
        (the sort pushes them past every real order statistic, where the
        masked argmax of ``order_stats.cutoff_and_iter_ragged_torch``
        cannot pick them).  With zero-padded params and the column-wise
        RNG, row j is the decision job j's standalone width-n controller
        makes.

        Returns (cutoff int32, samples (K, n) raw, pred_mu (n,),
        pred_std (n,) — the aggregated predictive moments the censored
        imputation needs — and pred_iter, the posterior-predictive
        E[x_(c)] wall time of the decided step), each with the leading job
        axis in the ragged mode.
        """
        if width is not None:
            return RuntimeModel._decide_ragged(params, ring, head, key,
                                               norm_scale, k_samples, lo,
                                               width)
        cap, n = ring.shape
        rows = (torch.arange(cap, device=ring.device) + head) % cap
        # the scale as a tensor, as the ragged mode holds it: CUDA divides
        # by a python float as a product with its reciprocal, one ulp off
        # true division in up to 500 of 3,318 entries at n = 158, which
        # the censored imputation's tail turns into ~1e-4 of window
        # (ROADMAP C.12)
        norm_scale = torch.full((), norm_scale, dtype=ring.dtype,
                                device=ring.device)
        window = torch.index_select(ring, 0, rows) / norm_scale
        k1, k2, k3, _ = R.split(key, 4)
        z_T = G.guide_sample_broadcast(params["guide"], window, k1, k_samples)
        tmu, tstd = D.transition(params["dmm"], z_T)
        z_next = tmu + tstd * R.normal(k2, tmu.shape)
        emu, estd = D.emission(params["dmm"], z_next)     # (K, n)
        x_next = emu + estd * colwise_normal(k3, k_samples, n)
        samples = x_next * norm_scale
        cutoff, pred_iter = order_stats.cutoff_and_iter_torch(samples, lo)
        pred_mu = torch.mean(emu, dim=0) * norm_scale
        # mixture-variance law over the K mixture components:
        # Var = E[std^2] + Var[mu] (E[std]^2 under-disperses the tail)
        pred_std = torch.sqrt(torch.mean(estd ** 2, dim=0)
                              + torch.var(emu, dim=0, correction=0)
                              ) * norm_scale
        return cutoff, samples, pred_mu, pred_std, pred_iter

    @staticmethod
    def _decide_ragged(params, rings, heads, keys, norm_scales,
                       k_samples: int, los, widths):
        """The ragged mode of :meth:`_decide_core` (see there)."""
        J, cap, n = rings.shape
        rows = (torch.arange(cap, device=rings.device)[None, :]
                + heads[:, None]) % cap
        window = torch.gather(rings, 1, rows[:, :, None].expand(J, cap, n))
        window = window / norm_scales[:, None, None]
        colm = torch.arange(n, device=rings.device)[None, :] < widths[:, None]
        window = torch.where(colm[:, None, :], window, 0.0)
        k1, k2, k3, _ = R.split(keys, 4).unbind(-2)
        z_T = G.guide_sample_broadcast(params["guide"], window, k1,
                                       k_samples)             # (J, K, zd)
        tmu, tstd = D.transition(params["dmm"], z_T)
        z_next = tmu + tstd * R.normal(k2, tmu.shape[1:])
        emu, estd = D.emission(params["dmm"], z_next)      # (J, K, n)
        x_next = emu + estd * colwise_normal(k3, k_samples, n)
        scale = norm_scales[:, None, None]
        samples = torch.where(colm[:, None, :], x_next * scale, math.inf)
        cutoff, pred_iter = order_stats.cutoff_and_iter_ragged_torch(
            samples, los, widths)
        pred_mu = torch.mean(emu, dim=1) * norm_scales[:, None]
        pred_std = torch.sqrt(torch.mean(estd ** 2, dim=1)
                              + torch.var(emu, dim=1, correction=0)
                              ) * norm_scales[:, None]
        return cutoff, samples, pred_mu, pred_std, pred_iter


# ---------------------------------------------------------------------------
# Stacked params for the multi-tenant server's batched decision.
# ---------------------------------------------------------------------------


def _check_arch(models, what: str, fields, noun: str):
    """Every model shares ``fields`` with the first, else ValueError."""
    if not models:
        raise ValueError(f"{what} needs at least one model")
    want = tuple(getattr(models[0], f) for f in fields)
    for m in models[1:]:
        got = tuple(getattr(m, f) for f in fields)
        if got != want:
            raise ValueError(f"cannot stack RuntimeModels of {noun} {want} "
                             f"and {got}")


def _stack(param_trees, models):
    params = tree.map(lambda *xs: torch.stack(xs), *param_trees)
    scales = torch.tensor([m.norm_scale for m in models],
                          dtype=torch.float32,
                          device=tree.leaves(params)[0].device)
    return params, scales


def stack_models(models):
    """Stack J same-architecture RuntimeModels for the batched decision.

    Returns (stacked params tree with a leading (J,) job axis, norm_scales
    (J,) f32).  All models must share (n_workers, lag, z_dim, hidden): the
    job axis batches DECISIONS, it does not pad shapes (that is
    ``stack_models_padded``)."""
    _check_arch(models, "stack_models",
                ("n_workers", "lag", "z_dim", "hidden"), "shapes")
    return _stack([m.params for m in models], models)


def _pad_width_params(params, n: int, n_pad: int):
    """Zero-pad the width-shaped parameter leaves from n to n_pad workers.

    The width appears in exactly four places (everything else is
    (z_dim, hidden)-shaped and width-free): the emission mean head's last
    layer (hidden, n) + bias, the emission std layer (n, n) + bias — padded
    on BOTH axes — and the guide RNNs' input projections (n, hidden),
    padded on the input axis.  The pads are structural, not inferred by
    matching dim == n, which would misfire whenever n equals ``hidden``.

    Zero pads leave the real columns' math unchanged (zero input rows add
    nothing to any matmul) and keep the padded columns finite (emission
    std = softplus(0) + 1e-3).
    """
    if n == n_pad:
        return params
    d = n_pad - n
    pad_last = lambda a: F.pad(a, (0, d))
    pad_first = lambda a: F.pad(a, (0, 0, 0, d))
    dmm = dict(params["dmm"])
    emit_mu = [dict(lyr) for lyr in dmm["emit_mu"]]
    emit_mu[-1] = {"w": pad_last(emit_mu[-1]["w"]),
                   "b": pad_last(emit_mu[-1]["b"])}
    dmm["emit_mu"] = emit_mu
    emit_std = [dict(lyr) for lyr in dmm["emit_std"]]
    emit_std[0] = {"w": pad_last(pad_first(emit_std[0]["w"])),
                   "b": pad_last(emit_std[0]["b"])}
    dmm["emit_std"] = emit_std
    guide = dict(params["guide"])
    for name in ("rnn_left", "rnn_right"):
        rnn = dict(guide[name])
        rnn["wx"] = pad_first(rnn["wx"])
        guide[name] = rnn
    return {"dmm": dmm, "guide": guide}


def stack_models_padded(models, n_pad: int):
    """Ragged twin of ``stack_models``: stack J RuntimeModels whose worker
    widths may differ, zero-padding every width-shaped leaf to ``n_pad``
    columns (``_pad_width_params``).  Architectures (lag, z_dim, hidden)
    must still match: only the worker axis pads.  For a bucket whose jobs
    all share ``n_pad`` this is element for element ``stack_models``."""
    _check_arch(models, "stack_models_padded", ("lag", "z_dim", "hidden"),
                "architectures")
    for m in models:
        if m.n_workers > n_pad:
            raise ValueError(f"model width {m.n_workers} exceeds the bucket "
                             f"pad width {n_pad}")
    return _stack([_pad_width_params(m.params, m.n_workers, n_pad)
                   for m in models], models)


def batched_layout(stacked):
    """The stacked params as the ragged decision reads them: every bias
    (J, d) viewed as (J, 1, d), so ``x @ w + b`` broadcasts over a
    (J, rows, d_in) input and (J, d_in, d_out) weights.  Views only: no
    copy."""
    return tree.map(lambda x: x[:, None] if x.ndim == 2 else x, stacked)
