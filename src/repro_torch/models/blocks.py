"""Layer blocks: dense ``attn_mlp``, xLSTM ``mlstm`` and ``slstm``.

Twin of ``repro.models.blocks`` for the dense and xLSTM families.  Contract:
``apply_block(cfg, spec, params, x, ctx, cache) -> (x, cache')``

  * train:   cache None -> None (nothing is cached)
  * prefill: cache None -> freshly built cache
  * decode:  cache in   -> updated cache

The caches follow JAX's layout: ``{"attn": {"k", "v"}}`` for attention
(written in place at ``ctx.pos``), ``{"state": ScanState, "conv": tail}``
for the mLSTM and ``{"state": (c, n, h, m)}`` for the sLSTM.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


@dataclass(frozen=True)
class LayerSpec:
    kind: str        # attn_mlp | mlstm | slstm; the others raise
    window: int = 0  # 0 = full attention


class Ctx(NamedTuple):
    mode: str                      # train | prefill | decode
    positions: Any                 # (B, S) int
    pos: Optional[int] = None      # decode: host int cache write position


def _attn_sublayer(cfg, p, x, ctx, cache, *, window: int):
    B, Sx, _ = x.shape
    rope = cfg.rope_theta != 0.0
    q, k, v = A.project_qkv(cfg, p, x, ctx.positions, rope=rope)
    if ctx.mode == "decode":
        y, ck, cv = A.attn_decode(q, k, v, cache["k"], cache["v"], ctx.pos,
                                  window=window,
                                  softcap=cfg.attn_logit_softcap)
        cache = {"k": ck, "v": cv}
    else:
        y = A.attention(q, k, v, causal=True, window=window,
                        softcap=cfg.attn_logit_softcap)
        cache = {"k": k, "v": v} if ctx.mode == "prefill" else None
    y = y.reshape(B, Sx, cfg.qkv_dim) @ p["wo"]
    if "bo" in p:
        y = y + p["bo"]
    return y, cache


def _round128(x: float) -> int:
    return max(16, int(-(-x // 16) * 16)) if x < 128 else int(-(-x // 128) * 128)


def slstm_ff_dim(cfg) -> int:
    return _round128(cfg.d_model * 4 / 3)


def _mlstm_block(cfg, p, x, ctx, cache):
    B, Sx, d = x.shape
    di = cfg.ssm_expand * d
    cw = cfg.ssm_conv_width
    h0 = L.apply_norm(cfg, p["norm1"], x)
    xs, z = torch.chunk(h0 @ p["w_in"], 2, dim=-1)
    if ctx.mode == "decode":
        conv_in = torch.cat([cache["conv"], xs], dim=1)
        xc = sum(conv_in[:, j:j + 1] * p["conv_w"][j]
                 for j in range(cw)) + p["conv_b"]
        new_conv = conv_in[:, 1:]
    else:
        xc = S.causal_conv1d(xs, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    nh = cfg.n_heads
    hd = di // nh
    q = (xc @ p["wq"]).reshape(B, Sx, nh, hd)
    k = (xc @ p["wk"]).reshape(B, Sx, nh, hd)
    v = (xs @ p["wv"]).reshape(B, Sx, nh, hd)
    gates = xc @ p["w_gates"] + p["b_gates"]
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)          # (B,S,nh)
    g = F.logsigmoid(f_pre.float())
    ig = i_pre.float()
    if ctx.mode == "decode":
        y, st = S.recurrence_step(cache["state"], q[:, 0], k[:, 0], v[:, 0],
                                  g[:, 0], ig[:, 0])
        y = y[:, None]
        new_cache = {"state": st, "conv": new_conv}
    else:
        # the Hopper kernel on the card, linear_recurrence on the CPU
        y, st = ops.mlstm(q, k, v, g, ig)
        new_cache = None
        if ctx.mode == "prefill":
            new_cache = {"state": st,
                         "conv": xs[:, -(cw - 1):].contiguous()}
    y = y.reshape(B, Sx, di).to(x.dtype)
    y = L.rms_head_norm(y.reshape(B, Sx, nh, hd),
                        p["head_norm"]["scale"].reshape(nh, hd),
                        cfg.norm_eps).reshape(B, Sx, di)
    y = y * F.silu(z)
    return x + y @ p["w_out"], new_cache


def _slstm_block(cfg, p, x, ctx, cache):
    h0 = L.apply_norm(cfg, p["norm1"], x)
    state = cache["state"] if cache else None
    if ctx.mode == "decode":
        y, st = S.slstm_apply(p["slstm"], h0, cfg.n_heads, init_state=state)
    else:
        y, st = S.slstm_apply(p["slstm"], h0, cfg.n_heads)
    new_cache = {"state": st} if ctx.mode != "train" else None
    x = x + y @ p["w_out"]
    h1 = L.apply_norm(cfg, p["norm2"], x)
    return x + L.apply_mlp(cfg, p["mlp"], h1), new_cache


def apply_block(cfg, spec: LayerSpec, p, x, ctx: Ctx, cache):
    if spec.kind == "mlstm":
        return _mlstm_block(cfg, p, x, ctx, cache)
    if spec.kind == "slstm":
        return _slstm_block(cfg, p, x, ctx, cache)
    if spec.kind != "attn_mlp":
        raise NotImplementedError(
            f"block kind {spec.kind!r} is not ported yet: the port covers "
            f"the dense attn_mlp and the xLSTM mlstm/slstm blocks; MoE, "
            f"hybrid and encoder-decoder blocks come with their own later "
            f"slices")
    h = L.apply_norm(cfg, p["norm1"], x)
    attn_cache = cache["attn"] if cache else None
    y, attn_cache = _attn_sublayer(cfg, p["attn"], h, ctx, attn_cache,
                                   window=spec.window)
    x = x + y
    h = L.apply_norm(cfg, p["norm2"], x)
    x = x + L.apply_mlp(cfg, p["mlp"], h)
    return x, ({"attn": attn_cache} if attn_cache is not None else None)
