"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Twins of ``repro.kernels.ref``.  The wrappers run these for tensors that
lie on the CPU, and ``chip_smoke.py`` holds each kernel against them on
the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def reference_attention(q, k, v, *, causal=True, window=0):
    """Dense attention, the contract of ``flash_attention``.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd).  Query head h reads KV head
    h // (H // KV).  Query row i sits at global position i + Sk - Sq
    (aligned suffixes).  Statistics in f32; output in ``q.dtype``.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    s = s / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", a, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)
