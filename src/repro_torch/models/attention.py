"""Attention: projections, a plain core, the sequence-parallel wrapper
and one-token decode.

Twin of ``repro.models.attention``.  Prefill and decode reach the Hopper
flash-attention kernel through ``kernels.ops.attention``, training
through its autograd Function ``FlashAttention``; ``attn_core`` is the
plain path with explicit positions and logit softcap, for the cases the
kernel does not take.  ``attention_sp`` is the reference's
sequence-parallel wrapper: under ``train_sp`` the queries stay this
rank's columns and the keys and values are gathered over the model axis
(or, with the ``attn_halo`` knob on a sliding-window layer, fetched from
the ranks the window reaches), still through the flash kernel.
"""
from __future__ import annotations

import torch

from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.models import layers as L
from repro_torch.perf.knobs import knobs

NEG_INF = -1e30


def project_qkv(cfg, p, x, positions, *, rope: bool = True):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd), roped + qk-normed."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_head_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_head_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q, k = L.apply_rope(cfg, q, k, positions)
    return q, k, v


def attn_core(q, k, v, qpos, kpos, *, causal=True, window=0, softcap=0.0):
    """Dense attention with explicit positions (f32 scores).

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); qpos: (B, Sq); kpos: (Sk,).
    Probabilities are cast to ``v.dtype`` before the value product, as the
    JAX ``attn_core`` does.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    s = s * (1.0 / float(hd) ** 0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kb = kpos[None, None, None, None, :]
    qb = qpos[:, None, None, :, None]
    mask = torch.ones((B, 1, 1, Sq, kpos.shape[0]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (kb <= qb)
    if window > 0:
        mask = mask & (kb > qb - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", a.to(v.dtype), v)
    return o.reshape(B, Sq, H, hd)


def attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Attention over a fresh sequence (positions 0..S-1): causal
    self-attention, or with ``causal=False`` an encoder's self-attention
    or cross-attention over Sk >= Sq keys (every key visible).

    With grad enabled on q, k or v (training) the kernel runs through
    ``FlashAttention``, whose backward is the plain attention's.
    """
    if softcap:
        S = q.shape[1]
        pos = torch.arange(S, device=q.device)
        return attn_core(q, k, v, pos.expand(q.shape[0], S), pos,
                         causal=causal, window=window, softcap=softcap)
    return _flash(q, k, v, causal, window)


def _flash(q, k, v, causal, window):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return ops.attention(q, k, v, causal=causal, window=window)


def attention_sp(q, k, v, qpos=None, *, causal=True, window=0,
                 softcap=0.0):
    """Train and prefill attention under the active layout.

    Outside ``train_sp`` it is :func:`attention` over a fresh sequence.
    Under ``train_sp`` q (B, S_loc, H, hd) is this rank's columns, at
    global positions s S_loc + i, and k/v (B, Sk_loc, KV, hd) its columns
    of the keys (this sequence's own, or the encoder output's for
    cross-attention); ``qpos`` (B, S_loc) are the queries' global
    positions, read only with a logit softcap (the plain ``attn_core``).

      * Causal: k and v are gathered over the model axis in one
        all-gather and cut to their first (s + 1) S_loc keys, so the
        kernel's aligned-suffix rule (query row i at i + Sk - Sq, ROADMAP
        C.1) puts row i at s S_loc + i.  With the ``attn_halo`` knob on a
        sliding-window layer whose window reaches h = ceil(window /
        S_loc) < T - 1 chunks back, the rank instead receives the min(h,
        s) chunks before its own by point-to-point sends, and the kernel
        gets those and its own: the chunks before the first rank, which
        the reference fills with zeros and masks, are never passed.
      * Not causal (whisper's encoder, cross-attention over the gathered
        encoder output): every key is visible; all of them are passed
        (Sq <= Sk, C.19).

    The gathers' and sends' backwards (a reduce-scatter, the reverse
    sends) hand each rank the gradient of its own k/v columns.
    """
    if not shd.seq_parallel():
        return attention(q, k, v, causal=causal, window=window,
                         softcap=softcap)
    ax = C.model_axis()
    S_loc, s, T = k.shape[1], ax.index, ax.size
    hops = -(-window // S_loc) if window > 0 else 0
    if knobs().attn_halo and causal and window > 0 and hops < T - 1:
        kv = C.halo(torch.stack([k, v]), hops, dim=2)
        start = (s - min(hops, s)) * S_loc
    else:
        kv = C.seq_gather(torch.stack([k, v]), dim=2)
        if causal and s + 1 < T:
            kv = kv.narrow(2, 0, (s + 1) * S_loc)
        start = 0
    k, v = kv[0], kv[1]
    if softcap:
        kpos = torch.arange(start, start + k.shape[1], device=q.device)
        return attn_core(q, k, v, qpos, kpos, causal=causal, window=window,
                         softcap=softcap)
    return _flash(q, k, v, causal, window)


def decode_position(pos, device):
    """``pos`` as the decode step takes it: a 0-d int64 tensor on
    ``device`` (a host int is turned into one)."""
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype != torch.int64 or pos.device != device:
            raise ValueError(f"pos must be a 0-d int64 tensor on {device}; "
                             f"got {pos.dtype} {tuple(pos.shape)} on "
                             f"{pos.device}")
        return pos
    return torch.tensor(int(pos), dtype=torch.int64, device=device)


def attn_decode(q, k_new, v_new, cache_k, cache_v, pos, *, window=0,
                softcap=0.0):
    """One-token decode.

    q/k_new/v_new: (B, 1, {H|KV}, hd); cache_{k,v}: (B, L, KV, hd).
    pos: a 0-d int64 tensor on the caches' device (or a host int), the
    number of tokens already in the cache; the new token is written at
    index ``pos`` and attends over [0, pos] of the whole padded cache,
    masked by ``length = pos + 1`` read on the device (JAX's traced
    ``pos`` over ``kpos = arange(L)``), so nothing here waits for the
    card and a CUDA graph of the step serves every position.
    Returns (y (B,1,H,hd), cache_k, cache_v).

    Unlike JAX's ``dynamic_update_slice``, the new k/v are written into the
    cache tensors IN PLACE: the caches passed in are the caches returned.
    """
    pos = decode_position(pos, cache_k.device)
    idx = pos.reshape(1)
    cache_k.index_copy_(1, idx, k_new)
    cache_v.index_copy_(1, idx, v_new)
    if softcap:
        B = q.shape[0]
        kpos = torch.arange(cache_k.shape[1], device=q.device)
        y = attn_core(q, cache_k, cache_v, pos.expand(B, 1), kpos,
                      causal=True, window=window, softcap=softcap)
    else:
        # Sq = 1 over the first ``length`` keys: the aligned-suffix rule
        # puts the query at position pos
        y = ops.attention(q, cache_k, cache_v, causal=True, window=window,
                          length=(pos + 1).to(torch.int32))
    return y, cache_k, cache_v
