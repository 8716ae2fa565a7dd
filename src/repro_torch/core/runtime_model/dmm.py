"""Deep Markov Model of joint worker run-times (paper §3.1.2–3.1.3).

The port of ``repro.core.runtime_model.dmm``.  Generative model (Krishnan
et al. 2017 "deep linear dynamical model"):

    z_t ~ N(G_theta(z_{t-1}), H_theta(z_{t-1}))
    x_t ~ N(I_theta(z_t),     J_theta(z_t))

with the gated transition

    G(z) = (1 - g) * Linear(z) + g * h,   g = MLP_2(z, ReLU, Sigmoid),
    h = MLP_2(z, ReLU, Identity),          H = MLP_1(ReLU(G), Softplus)

and emission I = MLP_2(z, Id, Id), J = MLP_2(I(z), ReLU, Softplus).
H/J parameterize standard deviations (Softplus > 0).

Params are dict trees of tensors, ``w`` in the JAX ``(d_in, d_out)``
layout; init draws from the ``jax.random`` twin, so a seed gives JAX's
params to the last few ulps of its normals.
"""
from __future__ import annotations

import math

import torch

from repro_torch import random as R


def dense_init(key, d_in: int, d_out: int) -> torch.Tensor:
    """``repro.models.layers.dense_init`` in f32: normal / sqrt(d_in)."""
    return R.normal(key, (d_in, d_out)) * (1.0 / math.sqrt(d_in))


def _mlp_init(key, dims):
    ks = R.split(key, len(dims) - 1)
    return [{"w": dense_init(ks[i], dims[i], dims[i + 1]),
             "b": torch.zeros((dims[i + 1],))}
            for i in range(len(dims) - 1)]


def _mlp(params, x, acts):
    for p, a in zip(params, acts):
        x = a(x @ p["w"] + p["b"])
    return x


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


_ID = lambda x: x
_SOFTPLUS = _softplus
_RELU = torch.relu
_SIG = torch.sigmoid
_TANH = torch.tanh


def dmm_init(key, n_workers: int, z_dim: int = 32, hidden: int = 64):
    ks = R.split(key, 6)
    return {
        "trans_lin": _mlp_init(ks[0], (z_dim, z_dim)),
        "trans_h": _mlp_init(ks[1], (z_dim, hidden, z_dim)),
        "trans_g": _mlp_init(ks[2], (z_dim, hidden, z_dim)),
        "trans_std": _mlp_init(ks[3], (z_dim, z_dim)),
        "emit_mu": _mlp_init(ks[4], (z_dim, hidden, n_workers)),
        "emit_std": _mlp_init(ks[5], (n_workers, n_workers)),
        "z0_mu": torch.zeros((z_dim,)),
        "z0_logstd": torch.zeros((z_dim,)),
    }


def transition(params, z):
    """p(z_t | z_{t-1}) -> (mu, std)."""
    lin = _mlp(params["trans_lin"], z, (_ID,))
    h = _mlp(params["trans_h"], z, (_RELU, _ID))
    g = _mlp(params["trans_g"], z, (_RELU, _SIG))
    mu = (1.0 - g) * lin + g * h
    std = _mlp(params["trans_std"], _RELU(mu), (_SOFTPLUS,)) + 1e-3
    return mu, std


def emission(params, z):
    """p(x_t | z_t) -> (mu, std) over the n_workers runtime vector."""
    mu = _mlp(params["emit_mu"], z, (_ID, _ID))
    std = _mlp(params["emit_std"], _RELU(mu), (_SOFTPLUS,)) + 1e-3
    return mu, std


def gaussian_logpdf(x, mu, std):
    z = (x - mu) / std
    return -0.5 * (z * z + 2.0 * torch.log(std) + math.log(2.0 * math.pi))
