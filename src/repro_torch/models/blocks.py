"""Layer blocks: dense ``attn_mlp``, MoE ``attn_moe`` and ``attn_dense``,
xLSTM ``mlstm`` and ``slstm``, Hymba ``hybrid``, whisper's ``enc`` and
``dec``.

Twin of ``repro.models.blocks`` for every family.
Contract: ``block_forward(cfg, spec, params, x, ctx, cache) -> (x,
cache', aux)``, the reference's ``apply_block``, where ``aux`` is the
layer's f32 load-balance loss for ``attn_moe`` and None for the kinds
that have none (the reference's zero); ``apply_block`` returns ``(x,
cache')`` alone.

  * train:   cache None -> None (nothing is cached)
  * prefill: cache None -> freshly built cache
  * decode:  cache in   -> updated cache

The caches follow JAX's layout: ``{"attn": {"k", "v"}}`` for attention
(written in place at the device index ``ctx.pos``), ``{"state":
ScanState, "conv": tail}`` for the mLSTM, ``{"state": (c, n, h, m)}``
for the sLSTM, ``{"attn": {"k", "v"}, "mamba": {"state": ScanState,
"conv": tail}}`` for the hybrid
and ``{"attn": {"k", "v"}, "cross": {"ck", "cv"}}`` for whisper's decoder
(the encoder output's keys and values, written once by prefill and read
whole by every decode step).  The encoder's ``enc`` blocks run in train
mode only, non-causally.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.mlstm_plain import ScanState
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S


@dataclass(frozen=True)
class LayerSpec:
    kind: str        # attn_mlp | attn_moe | attn_dense | mlstm | slstm |
    #                  hybrid | enc | dec
    window: int = 0  # 0 = full attention


class Ctx(NamedTuple):
    mode: str                      # train | prefill | decode
    positions: Any                 # (B, S) or (3, B, S) int
    # decode: the cache write position, a 0-d int64 tensor on the
    # caches' device
    pos: Any = None
    encoder_out: Any = None        # whisper cross-attention source (B,Se,D)


def _attn_sublayer(cfg, p, x, ctx, cache, *, window: int,
                   causal: bool = True):
    B, Sx, _ = x.shape
    rope = cfg.rope_theta != 0.0
    q, k, v = A.project_qkv(cfg, p, x, ctx.positions, rope=rope)
    if ctx.mode == "decode":
        y, ck, cv = A.attn_decode(q, k, v, cache["k"], cache["v"], ctx.pos,
                                  window=window,
                                  softcap=cfg.attn_logit_softcap)
        cache = {"k": ck, "v": cv}
    else:
        # under train_sp q is this rank's columns at their global
        # positions and k/v are gathered; elsewhere it is attention()
        qpos = (ctx.positions[0] if ctx.positions.dim() == 3
                else ctx.positions)
        y = A.attention_sp(q, k, v, qpos, causal=causal, window=window,
                           softcap=cfg.attn_logit_softcap)
        cache = {"k": k, "v": v} if ctx.mode == "prefill" else None
    y = y.reshape(B, Sx, cfg.qkv_dim) @ p["wo"]
    if "bo" in p:
        y = y + p["bo"]
    return y, cache


def _cross_attn_sublayer(cfg, p, x, ctx, cache):
    """Whisper's cross-attention: q from x, k/v from the encoder output
    (train, prefill; prefill caches them as ``{"ck", "cv"}``) or from that
    cache (decode), every key visible: the flash kernel non-causally,
    Sq <= Se.  Under ``train_sp`` the encoder output is this rank's
    columns and its k/v are gathered (``attention_sp``).  Returns (y,
    cache')."""
    B, Sx, _ = x.shape
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, Sx, cfg.n_heads, cfg.head_dim)
    if ctx.mode == "decode":
        k, v = cache["ck"], cache["cv"]
    else:
        enc = ctx.encoder_out
        k, v = enc @ p["wk"], enc @ p["wv"]
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        shape = (B, enc.shape[1], cfg.n_kv_heads, cfg.head_dim)
        k, v = k.reshape(shape), v.reshape(shape)
        cache = {"ck": k, "cv": v} if ctx.mode == "prefill" else None
    y = A.attention_sp(q, k, v, causal=False)
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


def mamba_apply(cfg, p, x, ctx, cache):
    """Hymba's Mamba sublayer (Mamba-2/SSD form, one scalar decay a head),
    twin of ``repro.models.blocks.mamba_apply``: the causal conv (decode
    from the cached 3-position tail), B/C of ``ssm_state`` wide shared by
    every head, softplus dt, the gates g = -dt exp(a_log) (f32) and i =
    log(dt + 1e-9) (the activation dtype, as JAX), the unnormalized
    recurrence at scale 1, the ``d_skip`` term in f32 and the silu(z) gate.
    Train and prefill run the recurrence through ``ops.mlstm`` (the
    ``mlstm_chunk`` kernel on the card, with q/k as a head broadcast that
    is never materialized); decode takes one ``recurrence_step``.  Returns
    (y, cache')."""
    B, Sx, d = x.shape
    di = cfg.ssm_expand * d
    h = cfg.n_heads
    hd = di // h
    n = cfg.ssm_state
    cw = cfg.ssm_conv_width
    xs, z = torch.chunk(x @ p["w_in"], 2, dim=-1)
    if ctx.mode == "decode":
        conv_in = torch.cat([cache["conv"], xs], dim=1)
        xc = sum(conv_in[:, j:j + 1] * p["conv_w"][j]
                 for j in range(cw)) + p["conv_b"]
        new_conv = conv_in[:, 1:]
    else:
        xc = S.causal_conv1d(xs, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    b_, c_ = torch.chunk(xc @ p["w_bc"], 2, dim=-1)       # (B,S,N) each
    dt = F.softplus(xc @ p["w_dt"] + p["dt_bias"])        # (B,S,h)
    g = -dt * torch.exp(p["a_log"].float())               # f32
    i = torch.log(dt + 1e-9)
    v = xs.reshape(B, Sx, h, hd)
    k = b_[:, :, None, :].expand(B, Sx, h, n)
    q = c_[:, :, None, :].expand(B, Sx, h, n)
    if ctx.mode == "decode":
        y, st = S.recurrence_step(cache["state"], q[:, 0], k[:, 0], v[:, 0],
                                  g[:, 0], i[:, 0], normalize=False,
                                  scale=1.0)
        y = y[:, None]
        cache = {"state": st, "conv": new_conv}
    else:
        y, st = ops.mlstm(q, k, v, g, i.float(), normalize=False, scale=1.0)
        cache = None
        if ctx.mode == "prefill":
            cache = {"state": st, "conv": xs[:, -(cw - 1):].contiguous()}
    y = y + p["d_skip"].float()[None, None, :, None] * v.float()
    y = y.reshape(B, Sx, di).to(x.dtype) * F.silu(z)
    return y @ p["w_out_m"], cache


def _hybrid_block(cfg, spec, p, x, ctx, cache):
    """Attention and Mamba heads in parallel on the same norm, each branch
    RMS-normed, averaged, then the MLP."""
    h = L.apply_norm(cfg, p["norm1"], x)
    ya, attn_cache = _attn_sublayer(cfg, p["attn"], h, ctx,
                                    cache["attn"] if cache else None,
                                    window=spec.window)
    ym, mamba_cache = mamba_apply(cfg, p["mamba"], h, ctx,
                                  cache["mamba"] if cache else None)
    ya = L.apply_norm(cfg, p["branch_norm_attn"], ya)
    ym = L.apply_norm(cfg, p["branch_norm_ssm"], ym)
    x = x + 0.5 * (ya + ym)
    h = L.apply_norm(cfg, p["norm2"], x)
    x = x + L.apply_mlp(cfg, p["mlp"], h)
    if attn_cache is None and mamba_cache is None:
        return x, None
    return x, {"attn": attn_cache, "mamba": mamba_cache}


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


def _attn_ffn_block(cfg, spec, p, x, ctx, cache):
    """Attention then an FFN: the dense MLP (``attn_mlp``; ``attn_dense``,
    deepseek's first layer, with ``dense_d_ff``; whisper's ``enc``, whose
    attention is non-causal, and ``dec``, which cross-attends to the
    encoder output between the two) or the MoE (``attn_moe``, whose aux it
    returns)."""
    h = L.apply_norm(cfg, p["norm1"], x)
    attn_cache = cache["attn"] if cache else None
    y, attn_cache = _attn_sublayer(cfg, p["attn"], h, ctx, attn_cache,
                                   window=spec.window,
                                   causal=spec.kind != "enc")
    x = x + y
    new_cache = {"attn": attn_cache} if attn_cache is not None else None
    if spec.kind == "dec":
        h = L.apply_norm(cfg, p["norm_cross"], x)
        y, cross_cache = _cross_attn_sublayer(
            cfg, p["cross"], h, ctx, cache["cross"] if cache else None)
        x = x + y
        if cross_cache is not None:
            new_cache = dict(new_cache or {}, cross=cross_cache)
    h = L.apply_norm(cfg, p["norm2"], x)
    if spec.kind == "attn_moe":
        y, aux = MOE.moe_apply(cfg, p["moe"], h)
    else:
        y, aux = L.apply_mlp(cfg, p["mlp"], h), None
    x = x + y
    return x, new_cache, aux


def block_forward(cfg, spec: LayerSpec, p, x, ctx: Ctx, cache):
    """(x, cache', aux): aux the layer's f32 load-balance loss for
    ``attn_moe``, None for every other kind (a model of other kinds makes
    no zero tensor a layer)."""
    aux = None
    # the block's ZeRO-3 shards, gathered in one collective (the identity
    # outside a ZeRO-3 step): the reference's use sites of attn, cross,
    # mamba, the mLSTM and sLSTM weights, the MLP and the shared experts
    # all lie in this block
    if spec.kind == "attn_moe" and shd.seq_parallel():
        # expert parallelism: the bank stays this rank's experts
        moe = dict(p["moe"])
        bank = moe.pop("experts")
        p = shd.use_weight(dict(p, moe=moe))
        p["moe"] = dict(p["moe"], experts=shd.use_shard(bank))
    else:
        p = shd.use_weight(p)
    if spec.kind == "mlstm":
        x, cache = _mlstm_block(cfg, p, x, ctx, cache)
    elif spec.kind == "slstm":
        x, cache = _slstm_block(cfg, p, x, ctx, cache)
    elif spec.kind in ("attn_mlp", "attn_moe", "attn_dense", "enc", "dec"):
        x, cache, aux = _attn_ffn_block(cfg, spec, p, x, ctx, cache)
    elif spec.kind == "hybrid":
        x, cache = _hybrid_block(cfg, spec, p, x, ctx, cache)
    else:
        raise ValueError(f"unknown layer kind {spec.kind!r}")
    return x, cache, aux


def apply_block(cfg, spec: LayerSpec, p, x, ctx: Ctx, cache):
    """(x, cache'): :func:`block_forward` without the aux."""
    x, cache, _ = block_forward(cfg, spec, p, x, ctx, cache)
    return x, cache


# ---------------------------------------------------------------------------
# Cache shapes (the decode entry point's).
# ---------------------------------------------------------------------------


def cache_struct(cfg, spec: LayerSpec, batch: int, cache_len: int, dtype):
    """One layer's decode cache as tensors on the meta device (shapes and
    dtypes, nothing allocated): the reference's ``cache_struct``."""
    def meta(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    hd = cfg.head_dim
    f32 = torch.float32
    out = {}
    if spec.kind in ("attn_mlp", "attn_moe", "attn_dense", "dec", "hybrid"):
        out["attn"] = {"k": meta(batch, cache_len, cfg.n_kv_heads, hd),
                       "v": meta(batch, cache_len, cfg.n_kv_heads, hd)}
    if spec.kind == "dec":
        out["cross"] = {
            "ck": meta(batch, cfg.encoder_seq_len, cfg.n_kv_heads, hd),
            "cv": meta(batch, cfg.encoder_seq_len, cfg.n_kv_heads, hd)}
    di, h = cfg.ssm_expand * cfg.d_model, cfg.n_heads
    if spec.kind == "hybrid":
        n = cfg.ssm_state
        out["mamba"] = {
            "state": ScanState(loga=meta(batch, h, dt=f32),
                               m=meta(batch, h, dt=f32),
                               C=meta(batch, h, n, di // h, dt=f32),
                               n=meta(batch, h, n, dt=f32)),
            "conv": meta(batch, cfg.ssm_conv_width - 1, di)}
    if spec.kind == "mlstm":
        out = {"state": ScanState(loga=meta(batch, h, dt=f32),
                                  m=meta(batch, h, dt=f32),
                                  C=meta(batch, h, di // h, di // h, dt=f32),
                                  n=meta(batch, h, di // h, dt=f32)),
               "conv": meta(batch, cfg.ssm_conv_width - 1, di)}
    if spec.kind == "slstm":
        z = meta(batch, h, cfg.d_model // h, dt=f32)
        out = {"state": (z, z, z, z)}
    return out
