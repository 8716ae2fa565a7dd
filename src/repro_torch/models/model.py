"""Model assembly: layer specs, init, train/prefill/decode entry points.

Twin of ``repro.models.model`` for every family (dense LMs, MoE, xLSTM,
the Hymba hybrid, whisper's encoder-decoder and qwen2-vl's M-RoPE and
patch merge) on one device.  Where JAX stacks the layers of a segment
and runs them under ``jax.lax.scan``, the port keeps one parameter dict per
layer (``params["layers"]``; whisper's encoder ``params["encoder"]
["layers"]``) and loops over them in Python.

Parameters are plain dicts of tensors in the JAX layout: a dense weight is
``(d_in, d_out)`` and applied as ``x @ w``.

Under a ZeRO-3 train step (``dist.sharding.use_weight``) the parameters
are this rank's slices: every block's weights are gathered where the
block runs (``block_forward``), the embedding, head, final norms and
position tables where they are used, and each block runs under
``dist.sharding.remat``, so its gathered weights are gathered again in
the backward instead of kept.  Outside one every use site is the
identity.

Under ``train_sp`` (``dist.sharding.seq_parallel``) the forward is given
the full sequence of this rank's rows and takes its own columns of it
(tokens, positions, the patch merge's inputs, whisper's frames), so every
activation is this rank's columns; attention gathers the keys
(``attention.attention_sp``), the MoE exchanges tokens with the experts'
owners, and :func:`ring_ce_sum` streams the vocab round the model ring.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.blocks import (Ctx, LayerSpec, block_forward,
                                       cache_struct, slstm_ff_dim)


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


def encoder_layer_specs(cfg) -> List[LayerSpec]:
    return [LayerSpec(kind="enc", window=0)
            for _ in range(cfg.n_encoder_layers)]


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


#: rows of whisper's learned decoder position table (the reference's)
DEC_POS_LEN = 32_768


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def init_model(cfg, generator: torch.Generator, device=None, dtype=None):
    """Seeded init with the JAX package's distributions (not its bits).

    Every weight is drawn in f32 from ``generator`` on the generator's own
    device, then cast to ``dtype`` and moved to ``device``: one CPU seed
    gives the same weights on every device, and a CUDA generator draws a
    model too large for the host's memory in f32 (full-depth
    deepseek-moe-16b) on the card, one weight at a time.  On the meta
    device nothing is drawn: the tree's shapes and dtypes, at any size.
    """
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)

    def normal(shape, std):
        if device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=device)
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

    def attn_weights():
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
        return attn

    def attention():
        return {"norm1": norm(d), "attn": attn_weights(), "norm2": norm(d)}

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

    def mamba():   # repro.models.blocks.mamba_init
        di, nh, n = cfg.ssm_expand * d, cfg.n_heads, cfg.ssm_state
        return {"w_in": dense(d, 2 * di),
                "conv_w": normal((cfg.ssm_conv_width, di), 0.2),
                "conv_b": const((di,), 0.0),
                "w_bc": dense(di, 2 * n), "w_dt": dense(di, nh),
                "dt_bias": const((nh,), -2.0), "a_log": const((nh,), 0.0),
                "d_skip": const((nh,), 1.0), "w_out_m": dense(di, d)}

    def hybrid():
        return dict(attention(), mlp=mlp(cfg.d_ff), mamba=mamba(),
                    branch_norm_attn={"scale": const((d,), 1.0)},
                    branch_norm_ssm={"scale": const((d,), 1.0)})

    def slstm():
        nh = cfg.n_heads
        hd = d // nh
        cell = {"w": normal((d, 4 * d), 1.0 / math.sqrt(d)),
                "r": normal((4, nh, hd, hd), 1.0 / math.sqrt(hd)),
                "bias": const((4 * d,), 0.0)}
        return {"norm1": norm(d), "slstm": cell, "w_out": dense(d, d),
                "norm2": norm(d), "mlp": mlp(slstm_ff_dim(cfg))}

    def dec():   # whisper's decoder: self-attention, cross-attention, MLP
        return dict(attn_mlp(), norm_cross=norm(d), cross=attn_weights())

    d, qd, kvd = cfg.d_model, cfg.qkv_dim, cfg.kv_dim
    make = {"attn_mlp": attn_mlp, "attn_dense": attn_dense,
            "attn_moe": attn_moe, "mlstm": mlstm, "slstm": slstm,
            "hybrid": hybrid, "enc": attn_mlp, "dec": dec}
    layers = [make[s.kind]() for s in layer_specs(cfg)]   # drawn first
    params = {"embed": {"table": normal((cfg.vocab_size, d), 0.02)},
              "layers": layers, "final_norm": norm(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense(d, cfg.vocab_size)}
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": [make[s.kind]() for s in encoder_layer_specs(cfg)],
            "final_norm": norm(d),
            "pos_table": normal((cfg.encoder_seq_len, d), 0.02)}
        params["dec_pos_table"] = normal((DEC_POS_LEN, d), 0.02)
    return params


# ---------------------------------------------------------------------------
# Embedding / head.
# ---------------------------------------------------------------------------


def embed_tokens(cfg, params, tokens, batch=None):
    """Token embeddings; where ``batch`` carries ``patch_embeds`` (B, S,
    D), the rows its ``image_mask`` (B, S) sets take them instead, cast to
    the embeddings' dtype (qwen2-vl's stubbed vision frontend)."""
    x = F.embedding(tokens, shd.use_weight(params["embed"])["table"])
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if batch is not None and "patch_embeds" in batch:
        x = torch.where(batch["image_mask"][..., None].bool(),
                        batch["patch_embeds"].to(x.dtype), x)
    return x


def lm_logits(cfg, params, x):
    if cfg.tie_embeddings:
        w = shd.use_weight(params["embed"])["table"]          # (V, D)
        return x @ w.T.to(x.dtype)
    return x @ shd.use_weight(params["lm_head"])["w"].to(x.dtype)  # (D, V)


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def check_positions(positions):
    """Train and prefill attention masks by index, so their positions must
    be 0..S-1 on every row; others (offset, packed) raise ``ValueError``
    rather than get a mask other than JAX's.  M-RoPE's (3, B, S) positions
    are checked on stream 0 (t), the one the reference masks by; the h/w
    streams only rotate.  Only host data is checked: numpy arrays and CPU
    tensors.  A tensor on the card is never read (that would wait for the
    device); ``launch.train`` checks its batches while they are still
    numpy."""
    if isinstance(positions, torch.Tensor):
        if positions.device.type != "cpu":
            return
        # reprolint: disable=host-sync-in-hot-path -- only a CPU tensor gets here (a card tensor returns above): host data, no transfer
        positions = positions.numpy()
    pos = np.asarray(positions)
    if pos.ndim == 3:
        pos = pos[0]
    if not np.array_equal(pos, np.broadcast_to(np.arange(pos.shape[-1]),
                                               pos.shape)):
        raise ValueError(
            "train and prefill take positions 0..S-1 on every row (their "
            "attention masks by index, not by position); offset or packed "
            "positions are not supported")


def _run_encoder(cfg, params, frames):
    """Whisper's encoder over precomputed frame embeddings (B, Se, D),
    cast to the config's dtype: learned positions, non-causal blocks in
    train mode (no caches), the final norm.  Under ``train_sp`` it runs
    on this rank's columns of the frames, at their global positions, and
    returns its columns of the output."""
    enc = params["encoder"]
    pos_table = shd.use_weight(enc["pos_table"])
    start, Se = shd.seq_span(frames.shape[1])
    frames = frames.narrow(1, start, Se)
    x = frames.to(_dtype(cfg)) + pos_table[start:start + Se]
    B = frames.shape[0]
    ctx = Ctx(mode="train", positions=torch.arange(
        start, start + Se, device=frames.device).expand(B, Se))
    for spec, p in zip(encoder_layer_specs(cfg), enc["layers"]):
        x, _, _ = shd.remat(block_forward, cfg, spec, p, x, ctx, None)
    return L.apply_norm(cfg, shd.use_weight(enc["final_norm"]), x)


def forward(cfg, params, batch, mode: str = "train", caches=None,
            pos=None, head: bool = True):
    """Train, prefill or decode.

    batch: tokens (B, S) and positions (B, S), or (3, B, S) for M-RoPE;
    qwen2-vl may add ``patch_embeds`` (B, S, D) and ``image_mask`` (B, S),
    whisper needs ``frames`` (B, Se, D) except in decode.  RoPE reads
    ``batch["positions"]``, as the JAX forward does, but the attention mask
    of train and prefill is by index (the flash kernel's aligned-suffix
    rule), where JAX masks by position: so train and prefill take the
    positions 0..S-1 on every row (stream 0 of M-RoPE's) and raise
    ``ValueError`` for others given on the host (:func:`check_positions`).
    Decode has S == 1, ``pos`` (a 0-d int64 tensor on the caches'
    device, or a host int, which becomes one) and ``caches``: nothing in a
    decode step reads a value off the card, so a CUDA graph of it serves
    every position.

    Under ``train_sp`` the batch holds this rank's rows, full length;
    the forward takes its columns of them (:func:`seq_columns`) and
    returns those columns' logits (B, S/T, V) or hidden state.

    Returns (logits, caches, aux): train gives the full (B, S, V) logits
    and no caches; prefill gives the last position's logits (B, 1, V) and
    fresh caches; decode the next logits and the updated caches (KV caches
    written in place).  ``aux`` is the auxiliary loss, 0 for every family
    but MoE, the sum over the MoE layers (f32) for the MoE family.
    ``head=False`` returns the final-norm hidden state (B, S, D) in place
    of the logits, every position's (the fused CEs apply the head
    themselves).
    The JAX forward rematerializes each layer in training;
    at the port's sizes (one H100, 80 GB) the activations fit, so nothing
    is recomputed.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: want train, prefill or decode")
    positions = batch["positions"]
    if mode != "decode":
        check_positions(positions)
    if shd.seq_parallel():
        if mode != "train":
            raise ValueError(f"train_sp runs the train forward; got "
                             f"mode {mode!r}")
        batch = seq_columns(batch)
        positions = batch["positions"]
    # under train_sp the tokens are this rank's columns: act keeps them
    x = shd.act(embed_tokens(cfg, params, batch["tokens"], batch),
                "dp", "sp", None)
    encoder_out = None
    if cfg.is_encoder_decoder:
        qpos = positions[0] if positions.dim() == 3 else positions
        x = x + shd.use_weight(params["dec_pos_table"])[qpos]
        if mode != "decode":
            encoder_out = _run_encoder(cfg, params, batch["frames"])
    if mode == "decode":
        pos = A.decode_position(pos, x.device)
    ctx = Ctx(mode=mode, positions=positions, pos=pos,
              encoder_out=encoder_out)
    new_caches = []
    aux = x.new_zeros((), dtype=torch.float32)
    for i, (spec, p) in enumerate(zip(layer_specs(cfg), params["layers"])):
        x, c, a = shd.remat(block_forward, cfg, spec, p, x, ctx,
                            caches[i] if caches is not None else None)
        if a is not None:
            aux = aux + a
        new_caches.append(c)
    x = L.apply_norm(cfg, shd.use_weight(params["final_norm"]), x)
    if not head:
        return x, None if mode == "train" else new_caches, aux
    if mode == "prefill":
        # serving needs the last position's logits only: slice BEFORE the
        # head so the (B, S, V) logits tensor never materializes
        x = x[:, -1:]
    return (lm_logits(cfg, params, x),
            None if mode == "train" else new_caches, aux)


def seq_columns(batch):
    """This rank's columns of a full-length batch under ``train_sp``:
    tokens, labels, the patch merge's ``patch_embeds`` and ``image_mask``
    on dim 1, positions on their last dim (M-RoPE's (3, B, S) on dim 2);
    whisper's ``frames`` stay whole for the encoder, which takes its own
    columns of them; the per-example ``weights`` and anything else stay
    as they are.  The batch itself under other layouts."""
    out = dict(batch)
    for k in ("tokens", "labels", "patch_embeds", "image_mask"):
        if k in out:
            out[k] = shd.seq_shard(out[k], 1)
    pos = out["positions"]
    out["positions"] = shd.seq_shard(pos, pos.dim() - 1)
    return out


def ring_ce_sum(cfg, params, x, labels, weights=None):
    """Sum over tokens of the weighted CE of the final hidden ``x`` (B, S,
    D): the reference's vocab-ring fused CE.

    Outside ``train_sp`` (LOCAL, and the data-parallel layouts, where each
    rank holds its own rows) that is the dense sum over the head's logits,
    as the reference's local branch computes it.  Under ``train_sp``
    ``x`` and ``labels`` are this rank's columns; the head stays
    vocab-sharded: rank s starts from vocab block s (``dist.sharding.
    use_shard``: a tied head's ZeRO-3 shard of the (V, D) table is that
    block; an untied head's shard is its (D/T, V) rows, re-blocked once
    by one all-to-all, ``collectives.vocab_block``), and the blocks go
    round the model ring (``collectives.ring_shift``) while the rank
    streams its tokens through running (max, sum-exp, label-logit)
    accumulators in f32.  Neither the (V, D) table nor any (B, S, V)
    logits tensor is built.  The result is summed over the model axis,
    the ranks that share these rows (``collectives.model_sum``); a dp
    rank's rows are other workers', whose sums the step adds as it adds
    their gradients.
    """
    lay = shd.layout()
    if not shd.seq_parallel(lay):
        return _ce_sum_dense(lm_logits(cfg, params, x), labels, weights)
    from repro_torch.dist import collectives as C

    ax = C.model_axis(lay)
    T, V, D = ax.size, cfg.vocab_size, x.shape[-1]
    if V % T:
        raise ValueError(f"ring_ce_sum: a vocab of {V} does not split over "
                         f"{T} ranks")
    v_loc = V // T
    if cfg.tie_embeddings:
        blk = shd.use_shard(params["embed"])["table"]      # (V/T, D)
        want = (v_loc, D)
    else:
        w = shd.use_shard(params["lm_head"])["w"]          # (D/T, V)
        if tuple(w.shape) != (D // T, V):
            raise ValueError(f"ring_ce_sum: the untied head's shard is "
                             f"{tuple(w.shape)}, not its (D/T, V) = "
                             f"{(D // T, V)} rows")
        blk = C.vocab_block(w, lay)                        # (D, V/T)
        want = (D, v_loc)
    if tuple(blk.shape) != want:
        raise ValueError(f"ring_ce_sum: the head's vocab block is "
                         f"{tuple(blk.shape)}, want {want}")
    xf = x.reshape(-1, D).float()
    labf = labels.reshape(-1).long()
    run = _ce_start(xf.shape[0], x.device)
    for r in range(T):
        wb = blk.float()
        run = _ce_block(run, xf @ (wb.T if cfg.tie_embeddings else wb), labf,
                        ((ax.index + r) % T) * v_loc)
        if r < T - 1:
            blk = C.ring_shift(blk, lay)
    return C.model_sum(_ce_end(run, weights, x.shape[:2]), lay)


def _ce_start(n: int, device):
    """The running (max, sum-exp, label-logit) of ``n`` tokens, f32."""
    return (torch.full((n,), -1e30, dtype=torch.float32, device=device),
            torch.zeros((n,), dtype=torch.float32, device=device),
            torch.zeros((n,), dtype=torch.float32, device=device))


def _ce_block(run, logits, labf, off: int):
    """``run`` with one block of logits (n tokens, the vocab columns
    ``[off, off + logits.shape[1])``) streamed in."""
    m_run, s_run, ll = run
    n = logits.shape[1]
    m_new = torch.maximum(m_run, torch.max(logits, dim=-1).values)
    s_run = (s_run * torch.exp(m_run - m_new)
             + torch.sum(torch.exp(logits - m_new[:, None]), dim=-1))
    rel = labf - off
    inr = (rel >= 0) & (rel < n)
    pick = torch.gather(logits, 1, torch.clamp(rel, 0, n - 1)[:, None])[:, 0]
    return m_new, s_run, torch.where(inr, pick, ll)


def _ce_end(run, weights, shape):
    """The sum over tokens of the streamed CE, each example's (B, S)
    tokens weighted by ``weights`` (B,) when given."""
    m_run, s_run, ll = run
    ce = (m_run + torch.log(torch.clamp(s_run, min=1e-30))) - ll
    if weights is not None:
        B, S = shape
        ce = ce * weights.float()[:, None].expand(B, S).reshape(-1)
    return torch.sum(ce)


def chunked_ce_sum(cfg, params, x, labels, weights, vchunk: int):
    """Vocab-chunked fused CE: the sum over tokens of the weighted CE of
    the final hidden ``x`` (B, S, D), the head streamed in slices of
    ``vchunk`` columns with running (max, sum-exp, label-logit)
    accumulators in f32, so no (B S, V) logits tensor is built at once.

    When ``vchunk`` does not divide V the last slice holds the remaining
    columns.  (The reference's ``dynamic_slice`` clamps that slice's start
    into range, so its last chunk re-reads earlier columns under the pad
    columns' labels and its sum differs from the dense CE; the port
    computes the dense CE's value, ROADMAP C.21.)
    """
    # tied: the (V, D) embedding rows; else the (D, V) lm_head
    w = (shd.use_weight(params["embed"])["table"] if cfg.tie_embeddings
         else shd.use_weight(params["lm_head"])["w"])
    D = x.shape[-1]
    xf = x.reshape(-1, D).float()
    labf = labels.reshape(-1).long()
    run = _ce_start(xf.shape[0], x.device)
    for off in range(0, cfg.vocab_size, vchunk):
        if cfg.tie_embeddings:
            logits = xf @ w[off:off + vchunk].float().T
        else:
            logits = xf @ w[:, off:off + vchunk].float()
        run = _ce_block(run, logits, labf, off)
    return _ce_end(run, weights, x.shape[:2])


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


def decode_step(cfg, params, tokens, pos, caches, positions=None):
    """tokens: (B, 1); pos: the cache length so far, a 0-d int64 tensor
    on the tokens' device (JAX's traced ``jnp.int32(S + t)``) or a host
    int.  The positions (B, 1) are built from it on the device.  The KV
    caches are written in place; the other leaves (SSM states, conv
    tails) come back as new tensors, as JAX returns them."""
    B = tokens.shape[0]
    pos = A.decode_position(pos, tokens.device)
    if positions is None:
        positions = pos.expand(B, 1)
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


def cache_structs(cfg, batch: int, cache_len: int, dtype=None):
    """Every layer's decode cache as tensors on the meta device (shapes and
    dtypes only), one entry a layer: the reference's ``cache_structs``
    unstacked from its segments."""
    dtype = dtype or _dtype(cfg)
    return [cache_struct(cfg, spec, batch, cache_len, dtype)
            for spec in layer_specs(cfg)]
