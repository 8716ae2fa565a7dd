"""Layer blocks: the dense ``attn_mlp`` block and its per-layer KV cache.

Twin of ``repro.models.blocks`` for the dense family.  Contract:
``apply_block(cfg, spec, params, x, ctx, cache) -> (x, cache')``

  * train:   cache None -> None (nothing is cached)
  * prefill: cache None -> freshly built cache {"attn": {"k", "v"}}
  * decode:  cache in   -> the same cache, written in place at ``ctx.pos``
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

from repro_torch.models import attention as A
from repro_torch.models import layers as L


@dataclass(frozen=True)
class LayerSpec:
    kind: str        # attn_mlp; the other kinds raise until ported
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


def apply_block(cfg, spec: LayerSpec, p, x, ctx: Ctx, cache):
    if spec.kind != "attn_mlp":
        raise NotImplementedError(
            f"block kind {spec.kind!r} is not ported yet: the serving slice "
            f"covers the dense attn_mlp family; MoE, SSM, hybrid and "
            f"encoder-decoder blocks come with their own later slices")
    h = L.apply_norm(cfg, p["norm1"], x)
    attn_cache = cache["attn"] if cache else None
    y, attn_cache = _attn_sublayer(cfg, p["attn"], h, ctx, attn_cache,
                                   window=spec.window)
    x = x + y
    h = L.apply_norm(cfg, p["norm2"], x)
    x = x + L.apply_mlp(cfg, p["mlp"], h)
    return x, ({"attn": attn_cache} if attn_cache is not None else None)
