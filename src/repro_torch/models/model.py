"""Model assembly: layer specs, init, train/prefill/decode entry points.

Twin of ``repro.models.model`` for the dense LM, MoE and xLSTM families
on one device.  Where JAX stacks the layers of a segment and runs them under
``jax.lax.scan``, the port keeps one parameter dict per layer
(``params["layers"]``) and loops over them in Python.

Parameters are plain dicts of tensors in the JAX layout: a dense weight is
``(d_in, d_out)`` and applied as ``x @ w``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.blocks import (Ctx, LayerSpec, block_forward,
                                       slstm_ff_dim)


@dataclass(frozen=True)
class Segment:
    pattern: Tuple[LayerSpec, ...]
    repeats: int


# ---------------------------------------------------------------------------
# Layer specs & segments (the JAX package's grouping, for weight transfer).
# ---------------------------------------------------------------------------


def layer_specs(cfg) -> List[LayerSpec]:
    specs = []
    for i in range(cfg.n_layers):
        if cfg.family == "moe":
            kind = "attn_dense" if i < cfg.first_dense_layers else "attn_moe"
        elif cfg.family == "ssm":
            kind = ("slstm" if cfg.slstm_every and
                    (i % cfg.slstm_every == cfg.slstm_every - 1) else "mlstm")
        elif cfg.family == "hybrid":
            kind = "hybrid"
        elif cfg.is_encoder_decoder:
            kind = "dec"
        else:
            kind = "attn_mlp"
        window = 0
        if kind in ("attn_mlp", "attn_moe", "attn_dense", "hybrid"):
            if cfg.attn_kind(i) == "L" and cfg.sliding_window:
                window = cfg.sliding_window
        specs.append(LayerSpec(kind=kind, window=window))
    return specs


def build_segments(specs: Sequence[LayerSpec]) -> List[Segment]:
    n = len(specs)
    # cyclic grouping with the smallest period
    for period in range(1, min(12, n) + 1):
        if n % period:
            continue
        if all(specs[i] == specs[i % period] for i in range(n)):
            return [Segment(tuple(specs[:period]), n // period)]
    # run-length fallback
    segs: List[Segment] = []
    i = 0
    while i < n:
        j = i
        while j < n and specs[j] == specs[i]:
            j += 1
        segs.append(Segment((specs[i],), j - i))
        i = j
    return segs


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def init_model(cfg, generator: torch.Generator, device=None, dtype=None):
    """Seeded init with the JAX package's distributions (not its bits).

    Every weight is drawn in f32 from ``generator`` on the generator's own
    device, then cast to ``dtype`` and moved to ``device``: one CPU seed
    gives the same weights on every device, and a CUDA generator draws a
    model too large for the host's memory in f32 (full-depth
    deepseek-moe-16b) on the card, one weight at a time.
    """
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)

    def normal(shape, std):
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (t * std).to(device=device, dtype=dtype)

    def dense(d_in, d_out):
        return normal((d_in, d_out), 1.0 / math.sqrt(d_in))

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def norm(d):
        p = {"scale": const((d,), 1.0)}
        if cfg.norm == "layernorm":
            p["bias"] = const((d,), 0.0)
        return p

    def mlp(d_ff):
        p = {}
        if cfg.mlp in ("swiglu", "geglu"):
            p["w_gate"] = dense(d, d_ff)
        p["w_up"] = dense(d, d_ff)
        if cfg.mlp not in ("swiglu", "geglu") and cfg.mlp_bias:
            p["b_up"] = const((d_ff,), 0.0)
        p["w_down"] = dense(d_ff, d)
        if cfg.mlp_bias:
            p["b_down"] = const((d,), 0.0)
        return p

    def attention():
        attn = {"wq": dense(d, qd), "wk": dense(d, kvd), "wv": dense(d, kvd),
                "wo": dense(qd, d)}
        if cfg.attn_bias:
            attn.update(bq=const((qd,), 0.0), bk=const((kvd,), 0.0),
                        bv=const((kvd,), 0.0))
        if cfg.attn_out_bias:
            attn["bo"] = const((d,), 0.0)
        if cfg.qk_norm:
            attn["q_norm"] = const((cfg.head_dim,), 1.0)
            attn["k_norm"] = const((cfg.head_dim,), 1.0)
        return {"norm1": norm(d), "attn": attn, "norm2": norm(d)}

    def attn_mlp():
        return dict(attention(), mlp=mlp(cfg.d_ff))

    def attn_dense():   # deepseek's first layer
        return dict(attention(), mlp=mlp(cfg.dense_d_ff or cfg.d_ff))

    def attn_moe():
        return dict(attention(), moe=MOE.moe_init(cfg, normal))

    def mlstm():
        di, nh = cfg.ssm_expand * d, cfg.n_heads
        b_gates = torch.cat([torch.zeros(nh), torch.full((nh,), 3.0)])
        return {"norm1": norm(d), "w_in": dense(d, 2 * di),
                "conv_w": normal((cfg.ssm_conv_width, di), 0.2),
                "conv_b": const((di,), 0.0),
                "wq": dense(di, di), "wk": dense(di, di), "wv": dense(di, di),
                "w_gates": dense(di, 2 * nh),
                # forget-gate bias high
                "b_gates": b_gates.to(device=device, dtype=dtype),
                "head_norm": {"scale": const((di,), 1.0)},
                "w_out": dense(di, d)}

    def slstm():
        nh = cfg.n_heads
        hd = d // nh
        cell = {"w": normal((d, 4 * d), 1.0 / math.sqrt(d)),
                "r": normal((4, nh, hd, hd), 1.0 / math.sqrt(hd)),
                "bias": const((4 * d,), 0.0)}
        return {"norm1": norm(d), "slstm": cell, "w_out": dense(d, d),
                "norm2": norm(d), "mlp": mlp(slstm_ff_dim(cfg))}

    d, qd, kvd = cfg.d_model, cfg.qkv_dim, cfg.kv_dim
    make = {"attn_mlp": attn_mlp, "attn_dense": attn_dense,
            "attn_moe": attn_moe, "mlstm": mlstm, "slstm": slstm}
    layers = []
    for spec in layer_specs(cfg):
        if spec.kind not in make:
            raise NotImplementedError(
                f"block kind {spec.kind!r} is not ported yet: hybrid "
                f"(Hymba) and encoder-decoder (whisper) blocks come with "
                f"their own later slices")
        layers.append(make[spec.kind]())
    params = {"embed": {"table": normal((cfg.vocab_size, d), 0.02)},
              "layers": layers, "final_norm": norm(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense(d, cfg.vocab_size)}
    return params


# ---------------------------------------------------------------------------
# Embedding / head.
# ---------------------------------------------------------------------------


def embed_tokens(cfg, params, tokens):
    x = F.embedding(tokens, params["embed"]["table"])
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def lm_logits(cfg, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T.to(x.dtype)   # (V, D)
    return x @ params["lm_head"]["w"].to(x.dtype)            # (D, V)


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def check_positions(positions):
    """Train and prefill attention masks by index, so their positions must
    be 0..S-1 on every row; others (offset, packed) raise ``ValueError``
    rather than get a mask other than JAX's.  Only host data is checked:
    numpy arrays and CPU tensors.  A tensor on the card is never read (that
    would wait for the device); ``launch.train`` checks its batches while
    they are still numpy."""
    if isinstance(positions, torch.Tensor):
        if positions.device.type != "cpu":
            return
        positions = positions.numpy()
    pos = np.asarray(positions)
    if not np.array_equal(pos, np.broadcast_to(np.arange(pos.shape[-1]),
                                               pos.shape)):
        raise ValueError(
            "train and prefill take positions 0..S-1 on every row (their "
            "attention masks by index, not by position); offset or packed "
            "positions are not supported")


def forward(cfg, params, batch, mode: str = "prefill", caches=None,
            pos=None):
    """Train, prefill or decode.

    batch: tokens (B, S) and positions (B, S).  RoPE reads
    ``batch["positions"]``, as the JAX forward does, but the attention mask
    of train and prefill is by index (the flash kernel's aligned-suffix
    rule), where JAX masks by position: so train and prefill take the
    positions 0..S-1 on every row (``SyntheticTokens`` and the serving
    engine give them) and raise ``ValueError`` for others given on the
    host (:func:`check_positions`).  Decode has S == 1, a host int ``pos``
    and ``caches``.

    Returns (logits, caches, aux): train gives the full (B, S, V) logits
    and no caches; prefill gives the last position's logits (B, 1, V) and
    fresh caches; decode the next logits and the updated caches (KV caches
    written in place).  ``aux`` is the auxiliary loss, 0 for the dense and
    xLSTM families, the sum over the MoE layers (f32) for the MoE family.
    The JAX forward rematerializes each layer in training;
    at the port's sizes (one H100, 80 GB) the activations fit, so nothing
    is recomputed.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: want train, prefill or decode")
    if cfg.is_encoder_decoder or "patch_embeds" in batch:
        raise NotImplementedError(
            "encoder-decoder and vision inputs are not ported yet")
    if mode != "decode":
        check_positions(batch["positions"])
    x = embed_tokens(cfg, params, batch["tokens"])
    ctx = Ctx(mode=mode, positions=batch["positions"], pos=pos)
    new_caches = []
    aux = x.new_zeros((), dtype=torch.float32)
    for i, (spec, p) in enumerate(zip(layer_specs(cfg), params["layers"])):
        x, c, a = block_forward(cfg, spec, p, x, ctx,
                                caches[i] if caches is not None else None)
        if a is not None:
            aux = aux + a
        new_caches.append(c)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if mode == "prefill":
        # serving needs the last position's logits only: slice BEFORE the
        # head so the (B, S, V) logits tensor never materializes
        x = x[:, -1:]
    return (lm_logits(cfg, params, x),
            None if mode == "train" else new_caches, aux)


def _ce_sum_dense(logits, labels, weights=None):
    """Sum over tokens of the cross-entropy, in f32, each example's tokens
    weighted by ``weights`` (B,) when given."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    ce = lse - ll
    if weights is not None:
        ce = ce * weights.float()[:, None].expand(ce.shape)
    return torch.sum(ce)


def cross_entropy(logits, labels, weights=None):
    """Mean CE with optional per-example/token weights (the cutoff mask).

    The paper's Alg. 1 line 29 normalization: sum(w * ce) / sum(w), i.e.
    the update averages over *included* workers only.
    """
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    ce = lse - ll
    if weights is None:
        return torch.mean(ce)
    w = weights.float().reshape(
        tuple(weights.shape) + (1,) * (ce.dim() - weights.dim())
    ).expand(ce.shape)
    return torch.sum(w * ce) / torch.clamp(torch.sum(w), min=1e-6)


def train_loss(cfg, params, batch, aux_coef: float = 0.01):
    logits, _, aux = forward(cfg, params, batch, mode="train")
    loss = cross_entropy(logits, batch["labels"], batch.get("weights"))
    return loss + aux_coef * aux, {"ce": loss, "aux": aux}


def prefill(cfg, params, batch):
    logits, caches, _ = forward(cfg, params, batch, mode="prefill")
    return logits[:, -1], caches


def decode_step(cfg, params, tokens, pos: int, caches, positions=None):
    """tokens: (B, 1); pos: host int cache length so far.  The caches are
    updated in place and returned."""
    B = tokens.shape[0]
    if positions is None:
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=tokens.device)
    batch = {"tokens": tokens, "positions": positions}
    logits, caches, _ = forward(cfg, params, batch, mode="decode",
                                caches=caches, pos=pos)
    return logits, caches


def pad_caches(caches, target_len: int):
    """Grow the attention KV caches (leaves named k/v) to ``target_len``
    slots, zeros after; every other leaf (the SSM states, the conv tails)
    is kept as it is."""

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for name, t in node.items():
                if name in ("k", "v") and isinstance(t, torch.Tensor):
                    ax = t.dim() - 3
                    shape = list(t.shape)
                    shape[ax] = target_len
                    grown = t.new_zeros(shape)
                    grown.narrow(ax, 0, t.shape[ax]).copy_(t)
                    out[name] = grown
                else:
                    out[name] = walk(t)
            return out
        if isinstance(node, (list, tuple)):
            items = [walk(t) for t in node]
            if hasattr(node, "_fields"):   # NamedTuple (ScanState)
                return type(node)(*items)
            return type(node)(items)
        return node

    return walk(caches)
