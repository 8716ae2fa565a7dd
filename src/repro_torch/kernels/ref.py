"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Twins of ``repro.kernels.ref``.  The wrappers run these for tensors that
lie on the CPU, and ``chip_smoke.py`` holds each kernel against them on
the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def reference_attention(q, k, v, *, causal=True, window=0, length=None):
    """Dense attention, the contract of ``flash_attention``.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd).  Query head h reads KV head
    h // (H // KV).  Query row i sits at global position i + Sk - Sq
    (aligned suffixes).  Statistics in f32; output in ``q.dtype``.
    ``length`` (a 0-d integer tensor) keeps the keys below it visible and
    puts row i at i + length - Sq, over all Sk slots, as JAX's
    ``_decode_block`` masks a padded cache by ``kpos <= pos``.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    s = s / math.sqrt(hd)
    kpos = torch.arange(Sk, device=q.device)
    n = Sk if length is None else length.to(kpos.dtype)
    qpos = torch.arange(Sq, device=q.device) + (n - Sq)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if length is not None:
        mask &= kpos[None, :] < n
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", a, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def reference_mlstm(q, k, v, g, i):
    """Sequential stabilized mLSTM recurrence (the ``mlstm_chunk`` contract).

    q/k/v: (B, S, H, hd); g/i: (B, S, H) log forget/input gates -> f32
    output (B, S, H, hd).  One step per position, in f32: the oracle the
    chunked forms are held to.
    """
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    qf, kf, vf, gf, if_ = (t.float() for t in (q, k, v, g, i))
    ys = []
    for t in range(S):
        qt, kt, vt, gt, it = qf[:, t], kf[:, t], vf[:, t], gf[:, t], if_[:, t]
        m_new = torch.maximum(gt + m, it)
        fp = torch.exp(gt + m - m_new)[..., None, None]
        ip = torch.exp(it - m_new)[..., None, None]
        C = fp * C + ip * (kt[..., :, None] * vt[..., None, :])
        n = fp[..., 0] * n + ip[..., 0] * kt
        num = torch.einsum("bhq,bhqv->bhv", qt, C) * scale
        den = torch.einsum("bhq,bhq->bh", qt, n) * scale
        den = torch.maximum(torch.abs(den), torch.exp(-m_new))
        m = m_new
        ys.append(num / den[..., None])
    return torch.stack(ys, dim=1)


def reference_adam(p, g, m, v, scalars, *, b1=0.9, b2=0.999, eps=1e-8,
                   wd=0.0):
    """One AdamW step, the contract of ``fused_adam``; returns new tensors.

    scalars: ``(lr, 1 - b1**t, 1 - b2**t)`` as host floats (f32 values).
    p and g in any float dtype, m and v f32; the result p' keeps p's dtype.
    """
    lr, bc1, bc2 = (float(s) for s in scalars)
    gf = g.float()
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * gf * gf
    up = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if wd:
        up = up + wd * p.float()
    return (p.float() - lr * up).to(p.dtype), m_new, v_new


def reference_masked_agg(grads, mask, *, mean: bool = True):
    """grads (W, N), mask (W, 1) -> (1, N): the ``masked_grad_agg`` contract,
    ``sum_w m_w g_w / max(sum m, 1)`` in f32, out in the grads' dtype;
    ``mean=False`` gives the masked sum, undivided."""
    m = mask.float()
    acc = torch.sum(grads.float() * m, dim=0, keepdim=True)
    if not mean:
        return acc.to(grads.dtype)
    c = torch.clamp(torch.sum(m), min=1.0)
    return (acc / c).to(grads.dtype)
