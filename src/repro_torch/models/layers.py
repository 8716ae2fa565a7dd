"""Core layers: norms, MLPs, RoPE (standard, partial-rotary and M-RoPE).

Twins of ``repro.models.layers`` with the same rounding points: norms
compute in f32 and cast back; RoPE builds cos/sin in f32 and casts them to
``q.dtype`` before rotating.  Weights keep the JAX ``(d_in, d_out)`` layout,
so a dense layer is ``x @ w``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------


def apply_norm(cfg, params, x):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"].float()
    return y.to(x.dtype)


def rms_head_norm(x, scale, eps):
    """Per-head RMS norm (gemma3 qk-norm); x: (..., hd)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Dense MLPs.
# ---------------------------------------------------------------------------


def apply_mlp(cfg, params, x):
    p = params
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    else:
        h = x @ p["w_up"]
        if "b_up" in p:
            h = h + p["b_up"]
        h = F.gelu(h, approximate="tanh")
    y = h @ p["w_down"]
    if "b_down" in p:
        y = y + p["b_down"]
    return y


# ---------------------------------------------------------------------------
# RoPE: standard, partial-rotary, M-RoPE (qwen2-vl).
# ---------------------------------------------------------------------------


def _rope_cos_sin(positions, rot_dim: int, theta: float, dtype):
    """positions: (..., S) int -> cos/sin (..., S, rot_dim/2)."""
    half = rot_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs  # (..., S, half)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def _rotate(x, cos, sin):
    """x: (B, S, H, rot_dim); cos/sin: (B, S, half) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(cfg, q, k, positions):
    """q: (B,S,H,hd); k: (B,S,KV,hd); positions: (B,S) or (3,B,S) for
    M-RoPE (a non-M-RoPE arch reads stream 0 of a (3,B,S) array)."""
    if cfg.rope_theta == 0.0:
        return q, k  # learned-absolute-position archs (whisper)
    hd = cfg.head_dim
    rot = int(hd * cfg.partial_rotary)
    rot -= rot % 2
    if cfg.mrope_sections:
        cos, sin = _mrope_cos_sin(cfg, positions, rot, q.dtype)
    else:
        if positions.dim() == 3:
            positions = positions[0]
        cos, sin = _rope_cos_sin(positions, rot, cfg.rope_theta, q.dtype)

    def rope_one(x):
        if rot == hd:
            return _rotate(x, cos, sin)
        xr = _rotate(x[..., :rot], cos, sin)
        return torch.cat([xr, x[..., rot:]], dim=-1)

    return rope_one(q), rope_one(k)


def _mrope_cos_sin(cfg, positions, rot_dim: int, dtype):
    """M-RoPE: positions (3, B, S) = the (t, h, w) streams; frequency f
    takes the stream its section assigns (``mrope_sections`` counts
    half-dim frequencies, summing to rot_dim // 2).  (B, S) positions are
    three equal streams (decode), where M-RoPE is the standard RoPE.
    Each frequency's angle is its stream's position times the frequency,
    in f32, as the reference's one-hot selection computes it."""
    if positions.dim() == 2:
        positions = positions[None].expand((3,) + tuple(positions.shape))
    half = rot_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (cfg.rope_theta ** exponent)
    sec = torch.cat([torch.full((s,), i, dtype=torch.int64,
                                device=positions.device)
                     for i, s in enumerate(cfg.mrope_sections)])   # (half,)
    pos = positions.float()[sec]                   # (half, B, S)
    ang = pos.permute(1, 2, 0) * freqs             # (B, S, half)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)
