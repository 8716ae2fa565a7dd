"""SSM cores: the mLSTM decode step, the causal conv and the sLSTM.

Twin of ``repro.models.ssm``.  The chunked stabilized linear recurrence
(``ScanState``, ``combine``, ``linear_recurrence``) is the plain version of
the Hopper kernel and lives beside it in ``kernels.mlstm_plain``; it is
re-exported here so the module keeps the JAX module's names.  Under the
``train_sp`` layout, where each rank holds its own columns of the
sequence, the three take the JAX module's branches: the recurrence the
exclusive prefix across ranks (``mlstm_plain``; ``kernels.ops.mlstm`` on
the card), the causal conv a halo of the ``cw - 1`` positions before a
rank's columns from the rank before it, and the sLSTM, which is not
associative, a gather of its input projection and the whole scan on every
rank, each keeping its own columns.

The xLSTM and Hymba prefills on the card go through the kernel
``kernels.mlstm_chunk``; on CPU tensors they run its plain version.
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
    ``init_state`` (B, cw-1, C) during decode/chunked prefill).  Under
    ``train_sp`` on more than one rank, x is this rank's columns and the
    pad is the rank before it's last ``cw - 1`` positions (zeros on rank 0),
    as the reference's ``ppermute`` sends them (its ``:256-264``)."""
    cw = w.shape[0]
    S = x.shape[1]
    if shd.seq_parallel() and shd.layout().n_shards > 1:
        left = _halo_left(x, cw - 1)
    else:
        left = (init_state if init_state is not None
                else x.new_zeros((x.shape[0], cw - 1, x.shape[2])))
    xp = torch.cat([left, x], dim=1)
    y = sum(xp[:, j:j + S] * w[j] for j in range(cw))
    return y + (b if b is not None else 0.0)


def _halo_left(x, n):
    """The ``n`` positions before this rank's columns ``x`` (B, S_l, C):
    the previous rank's last ``n``, by one point-to-point send each way
    (``dist.collectives.halo``, whose backward sends the gradient back);
    zeros on the first rank."""
    from repro_torch.dist import collectives as C

    if x.shape[1] < n:
        raise ValueError(f"causal_conv1d under train_sp: a rank's {x.shape[1]}"
                         f" columns are fewer than the conv's {n}-position "
                         f"halo")
    got = C.halo(x[:, x.shape[1] - n:], 1, 1)
    if got.shape[1] == n:   # the first rank: nothing before it, but its
        # tail's gradient comes back from the next rank in the backward
        return C.depend(x.new_zeros((x.shape[0], n, x.shape[2])), got)
    return got[:, :n]


# ---------------------------------------------------------------------------
# sLSTM (strictly sequential; xLSTM scalar-memory cell).
# ---------------------------------------------------------------------------


def slstm_apply(params, x, n_heads: int, *, init_state=None):
    """x: (B, S, D).  Returns (h (B,S,D) in x's dtype, final_state).

    The state is (c, n, h, m), each (B, n_heads, hd) f32.  A Python loop
    over S, one step per position, as the JAX ``lax.scan`` runs it.  Under
    ``train_sp`` x is this rank's columns: the input projection is gathered
    over the model axis, every rank runs the whole scan, and h is this
    rank's columns of it (the reference's replicated scan, its
    ``:298-333``); the final state is the whole sequence's, its gradient
    carried by the last rank alone, as ``linear_recurrence``'s is.
    """
    B, _, D = x.shape
    hd = D // n_heads
    pre = shd.act(x @ params["w"] + params["bias"], "dp", None, None)
    S = pre.shape[1]
    pre = pre.float()                                   # (B,S,4D)
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
    out = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    final = (c, n, h, m)
    if not shd.seq_last():   # every rank holds it; the last one's counts
        final = tuple(t.detach() for t in final)
    return shd.act(out, "dp", "sp", None, seq="full"), final
