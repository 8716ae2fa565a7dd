"""RuntimeModel: ELBO training + real-time posterior-predictive inference.

The port of ``repro.core.runtime_model.api`` (the single-job, static-width
part).  Implements the paper's Eq. 5 approximation: sample z_{T-l:T}
trajectories from the guide, push the last-step marginal through the
transition and emission to obtain K Monte-Carlo samples of the next joint
runtime vector x_{T+1}.

Observations are normalized by 2x the mean of the first lag window (paper
§3.1.3) so one trained model transfers across network/batch-size scales.

Every draw comes from the ``jax.random`` twin (``repro_torch.random``)
with the reference's key layout, so a model with the reference's params
gives the reference's samples to f32 rounding.  Params live on
``device`` (``None`` means the card).  The ragged and stacked decision
modes of the multi-tenant server are not ported here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

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
    return R.fold_in(key, torch.arange(n, device=key.device))


def colwise_uniform(key, n: int):
    """(n,) uniforms in [0, 1); entry i depends only on (key, i)."""
    return R.uniform(_colwise_keys(key, n))


def colwise_normal(key, rows: int, n: int):
    """(rows, n) standard normals; column i depends only on (key, i)."""
    return R.normal(_colwise_keys(key, n), (rows,)).T


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
    def _decide_core(params, ring, head, key, norm_scale: float,
                     k_samples: int, lo: int):
        """guide → transition → emission → sample → sort → argmax → moments
        over the ring buffer: the decision body of the controller's fused
        observe+decide (``controller._observe_decide_core``).

        ring: (lag+1, n) raw f32 runtime rows; ``head`` (a 0-d int64 tensor
        on the ring's device) the index of the OLDEST row.  The window is
        gathered at ``(arange + head) % (lag+1)`` on the device, so neither
        it nor ``head`` is read by the host.  RNG layout mirrors
        ``_predict`` (split(key, 4), k1/k2/k3), with the guide's broadcast
        form.

        Returns (cutoff int32 0-d, samples (K, n) raw, pred_mu (n,),
        pred_std (n,) — the aggregated predictive moments the censored
        imputation needs — and pred_iter, the posterior-predictive E[x_(c)]
        wall time of the decided step).
        """
        cap, n = ring.shape
        rows = (torch.arange(cap, device=ring.device) + head) % cap
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
