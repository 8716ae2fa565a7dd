"""SSM cores: the mLSTM decode step, the causal conv and the sLSTM.

Twin of ``repro.models.ssm`` on one device.  The chunked stabilized linear
recurrence (``ScanState``, ``combine``, ``linear_recurrence``) is the plain
version of the Hopper kernel and lives beside it in
``kernels.mlstm_plain``; it is re-exported here so the module keeps the
JAX module's names.  The JAX module also shards the sequence over the
"model" axis under the ``train_sp`` layout (an exclusive prefix across
shards, a conv halo, a gathered sLSTM); those branches wait for ROADMAP
A.15.3b (``dist.sharding.WAITS_FOR["train_sp_ssm"]``): under
``train_sp`` the recurrence, the causal conv and the sLSTM raise
``NotImplementedError`` naming it rather than run on one rank's columns
as if they were the whole sequence.  Every function here is the JAX
local path.

The xLSTM and Hymba prefills on the card go through the kernel
``kernels.mlstm_chunk``; on CPU tensors they run ``linear_recurrence``.
Decode runs ``recurrence_step`` on either device, as the JAX package
computes it outside any kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as shd
from repro_torch.kernels.mlstm_plain import (  # noqa: F401  (re-exports)
    NEG, ScanState, combine, linear_recurrence, state_identity)


def recurrence_step(state: ScanState, q, k, v, g, i, *,
                    normalize: bool = True, scale: Optional[float] = None):
    """Single-token decode update: normalized and scaled by 1/sqrt(dq) by
    default, as the xLSTM asks; ``normalize=False`` returns the numerator at
    the new state's stabilizer m, as JAX does (Hymba's Mamba heads, with
    ``scale=1.0``).  q/k: (B,h,dq); v: (B,h,dv); g/i: (B,h)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    kf = k.float()
    elem = ScanState(
        loga=g.float(), m=i.float(),
        C=torch.einsum("bhq,bhv->bhqv", kf, v.float()), n=kf)
    new = combine(state, elem)
    qf = q.float()
    num = torch.einsum("bhq,bhqv->bhv", qf, new.C) * scale
    if not normalize:
        return num, new
    den = torch.einsum("bhq,bhq->bh", qf, new.n) * scale
    den = torch.maximum(torch.abs(den), torch.exp(-new.m))
    return num / den[..., None], new


# ---------------------------------------------------------------------------
# Causal depthwise conv.
# ---------------------------------------------------------------------------


def causal_conv1d(x, w, b=None, *, init_state=None):
    """x: (B, S, C); w: (cw, C) depthwise; left-pads with zeros (or
    ``init_state`` (B, cw-1, C) during decode/chunked prefill)."""
    shd.require_no_ssm("causal_conv1d")
    cw = w.shape[0]
    S = x.shape[1]
    left = (init_state if init_state is not None
            else x.new_zeros((x.shape[0], cw - 1, x.shape[2])))
    xp = torch.cat([left, x], dim=1)
    y = sum(xp[:, j:j + S] * w[j] for j in range(cw))
    return y + (b if b is not None else 0.0)


# ---------------------------------------------------------------------------
# sLSTM (strictly sequential; xLSTM scalar-memory cell).
# ---------------------------------------------------------------------------


def slstm_apply(params, x, n_heads: int, *, init_state=None):
    """x: (B, S, D).  Returns (h (B,S,D) in x's dtype, final_state).

    The state is (c, n, h, m), each (B, n_heads, hd) f32.  A Python loop
    over S, one step per position, as the JAX ``lax.scan`` runs it.
    """
    shd.require_no_ssm("slstm_apply")
    B, S, D = x.shape
    hd = D // n_heads
    pre = (x @ params["w"] + params["bias"]).float()   # (B,S,4D)
    r = params["r"].float()                             # (4, nh, hd, hd)
    if init_state is None:
        z = torch.zeros((B, n_heads, hd), dtype=torch.float32,
                        device=x.device)
        init_state = (z, z, z, torch.full_like(z, NEG))
    c, n, h, m = init_state
    hs = []
    for t in range(S):
        rec = torch.einsum("bkh,gkhj->bgkj", h, r).reshape(B, -1)
        zi, zf, zz, zo = (u.reshape(B, n_heads, hd)
                          for u in torch.chunk(pre[:, t] + rec, 4, dim=-1))
        logf = F.logsigmoid(zf)
        m_new = torch.maximum(logf + m, zi)
        fp = torch.exp(logf + m - m_new)
        ip = torch.exp(zi - m_new)
        c = fp * c + ip * torch.tanh(zz)
        n = fp * n + ip
        h = torch.sigmoid(zo) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(B, S, D)
    return out.to(x.dtype), (c, n, h, m)
