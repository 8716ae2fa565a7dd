"""Amortized inference network (paper §3.1.3): structured left-right guide.

The port of ``repro.core.runtime_model.guide``:

    q_phi(z_t | z_{t-1}, x_{T-l:T}) = N(mu_q, sigma_q)
    h_out   = 1/3 * (MLP_1(z_{t-1}, Tanh) + h_left[t] + h_right[t])
    h_left  = RNN(x_{T-l:t-1}, ReLU)   (forward pass)
    h_right = RNN(x_{t+1:T},  ReLU)    (backward pass)
    mu_q    = MLP_1(h_out, Identity);  sigma_q = MLP_1(mu_q, Softplus)

Sampling is sequential in t (q conditions on the sampled z_{t-1}); JAX's
``lax.scan``s are Python loops over the T = lag + 1 steps, which a
captured CUDA graph records as they run.
"""
from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.core.runtime_model.dmm import (_ID, _RELU, _SOFTPLUS, _TANH,
                                                _mlp, _mlp_init, dense_init)


def guide_init(key, n_workers: int, z_dim: int = 32, hidden: int = 64):
    ks = R.split(key, 7)

    def rnn(k):
        k1, k2 = R.split(k)
        return {"wx": dense_init(k1, n_workers, hidden),
                "wh": dense_init(k2, hidden, hidden),
                "b": torch.zeros((hidden,))}
    return {
        "rnn_left": rnn(ks[0]),
        "rnn_right": rnn(ks[1]),
        "z_proj": _mlp_init(ks[2], (z_dim, hidden)),
        "mu": _mlp_init(ks[3], (hidden, z_dim)),
        "std": _mlp_init(ks[4], (z_dim, z_dim)),
    }


def _rnn_sweep(p, xs):
    """xs: (T, ..., B, n) -> hidden states (T, ..., B, hidden), ReLU RNN
    (a job axis before B meets stacked (J, n, hidden) weights)."""
    h = xs.new_zeros(xs.shape[1:-1] + (p["wh"].shape[-1],))
    hs = []
    for x in xs:
        h = _RELU(x @ p["wx"] + h @ p["wh"] + p["b"])
        hs.append(h)
    return torch.stack(hs)


def _shifted_sweeps(guide_params, xt):
    """Both RNN sweeps over xt (T, ..., B, n), shifted one step so that
    ``h_left[t]`` summarizes x_{<t} and ``h_right[t]`` summarizes x_{>t};
    returns (h_left, h_right), each (T, ..., B, hidden)."""
    h_left_all = _rnn_sweep(guide_params["rnn_left"], xt)
    h_right_all = _rnn_sweep(guide_params["rnn_right"],
                             torch.flip(xt, (0,))).flip(0)
    zeros = h_left_all.new_zeros((1,) + h_left_all.shape[1:])
    h_left = torch.cat([zeros, h_left_all[:-1]], dim=0)
    h_right = torch.cat([h_right_all[1:], zeros], dim=0)
    return h_left, h_right


def guide_sample(guide_params, x_window, key, z0=None):
    """Sample a z trajectory for one window (the ELBO path).

    x_window: (B, T, n) normalized runtimes.
    Returns (zs (B, T, zd), mus, stds) — everything needed for the ELBO.
    The step-t normals are ``normal(split(key, T)[t], (B, zd))``, drawn
    for every step at once.
    """
    B, T, n = x_window.shape
    xt = x_window.transpose(0, 1)                  # (T, B, n)
    h_left, h_right = _shifted_sweeps(guide_params, xt)

    zd = guide_params["mu"][0]["w"].shape[1]
    z = x_window.new_zeros((B, zd)) if z0 is None else z0
    eps = R.normal(R.split(key, T), (B, zd))       # (T, B, zd)
    zs, mus, stds = [], [], []
    for t in range(T):
        hz = _TANH(_mlp(guide_params["z_proj"], z, (_ID,)))
        h_out = (hz + h_left[t] + h_right[t]) / 3.0
        mu = _mlp(guide_params["mu"], h_out, (_ID,))
        std = _mlp(guide_params["std"], mu, (_SOFTPLUS,)) + 1e-3
        z = mu + std * eps[t]
        zs.append(z)
        mus.append(mu)
        stds.append(std)
    st = lambda xs: torch.stack(xs, dim=1)
    return st(zs), st(mus), st(stds)


def guide_sample_broadcast(guide_params, x_window, key, k_samples: int):
    """K posterior samples of z_T for ONE window, sweeping the RNNs once
    (the decision path).

    Equivalent to ``guide_sample`` on ``x_window`` broadcast to
    (k_samples, T, n): the deterministic RNN sweeps run at B=1 and only
    the z-chain carries the K batch; the per-step normals are one batched
    draw (the same bits as ``normal(keys[t], (K, zd))`` per step); and the
    z-chain folds the mu and std projections into one matmul via the
    precomputed ``[W_mu | W_mu @ W_std]`` concatenation.  The
    reassociation perturbs samples at f32 rounding scale (~1e-6) relative
    to ``guide_sample``.

    x_window: (T, n) normalized runtimes.  Returns z_T: (k_samples, zd).
    A job stack (J, T, n) with keys (J, 2) and params laid out by
    ``api.batched_layout`` gives (J, k_samples, zd), row j job j's.
    """
    T = x_window.shape[-2]
    lead = x_window.shape[:-2]
    xt = x_window.movedim(-2, 0)[..., None, :]     # (T, ..., 1, n)
    h_left, h_right = _shifted_sweeps(guide_params, xt)
    h_sum = h_left + h_right                       # (T, ..., 1, hidden)

    zd = guide_params["mu"][0]["w"].shape[-1]
    # (..., T, K, zd) -> (T, ..., K, zd)
    eps = R.normal(R.split(key, T), (k_samples, zd)).movedim(-3, 0)

    wz, bz = guide_params["z_proj"][0]["w"], guide_params["z_proj"][0]["b"]
    wm, bm = guide_params["mu"][0]["w"], guide_params["mu"][0]["b"]
    ws, bs = guide_params["std"][0]["w"], guide_params["std"][0]["b"]
    w_cat = torch.cat([wm, wm @ ws], dim=-1)       # (hidden, 2*zd)
    b_cat = torch.cat([bm, bm @ ws + bs], dim=-1)

    z = x_window.new_zeros(lead + (k_samples, zd))
    for t in range(T):
        h_out = (_TANH(z @ wz + bz) + h_sum[t]) / 3.0
        ms = h_out @ w_cat + b_cat                 # [mu | std_pre]
        z = ms[..., :zd] + (_SOFTPLUS(ms[..., zd:]) + 1e-3) * eps[t]
    return z
