"""Mixture-of-Experts FFN: routing, capacity dispatch, aux loss.

Twin of ``repro.models.moe``: the no-mesh path (the ``tp == 1`` branch
of ``_dispatch_compute_combine``, which its decode takes too, with the
capacity of B tokens) and the ``train_sp`` expert parallelism (the bank
sharded over the model axis, each rank routing its own tokens and one
all-to-all to the experts' owners and back).  The ``decode_tp`` masked
psum waits for the port's ``decode_tp`` slice (ROADMAP A.15.4).  Plain
PyTorch throughout, as the reference computes MoE outside any Pallas
kernel: the expert products are batched matmuls, JAX's ``jnp.einsum``
over the banks.

Dispatch is sort-based, as in JAX: a stable sort of the (token, slot)
entries by expert id, each entry's rank within its expert from
``searchsorted``, entries at rank >= C dropped, (E, C, D) buffers.  The
port writes no buffer by a scatter-add: where JAX adds ``x[tok]`` into the
buffer and ``contrib`` into ``y`` by token (CUDA atomics in a literal
port, whose order changes run to run), the port

  1. repeats each token k times as a broadcast view (its backward is a
     sum over k, not an atomic add),
  2. fills every buffer row by ONE gather from those rows (a kept entry
     has one slot; an empty slot reads an appended zero row),
  3. gathers each entry's expert output back into (N, k, D), a dropped
     entry reading a zero row, and
  4. sums over k in a fixed order.

Every index a gather takes is distinct but the zero row's, so its backward
adds each gradient to zero once: two runs give the same bits.  The sum
over a token's k outputs runs in slot order where JAX's runs in expert
order: the two differ in the last bits only.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as COLL
from repro_torch.dist import sharding as shd
from repro_torch.perf.knobs import knobs


def moe_init(cfg, normal):
    """The MoE FFN's params with the reference's distributions.

    ``normal(shape, std)`` draws one weight (``models.model.init_model``'s
    seeded draw).  Router (D, E); expert banks ``w_gate``/``w_up`` (E, D, F)
    and ``w_down`` (E, F, D); shared experts of width ``F * n_shared``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    scale_in, scale_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": normal((d, e), scale_in),
         "experts": {"w_gate": normal((e, d, f), scale_in),
                     "w_up": normal((e, d, f), scale_in),
                     "w_down": normal((e, f, d), scale_out)}}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_gate": normal((d, fs), scale_in),
                       "w_up": normal((d, fs), scale_in),
                       "w_down": normal((fs, d), 1.0 / math.sqrt(fs))}
    return p


def _expert_ffn(bank, x):
    """SwiGLU over the banks; x: (E, C, D) -> (E, C, D)."""
    h = F.silu(torch.bmm(x, bank["w_gate"])) * torch.bmm(x, bank["w_up"])
    return torch.bmm(h, bank["w_down"])


def _route(cfg, router_w, x):
    """x: (..., D) -> (topk_w, topk_i, f_e, p_e).

    The router runs in f32; ``router_scale`` (deepseek) renormalizes the
    top-k weights.  f_e is the fraction of routed slots on expert e, p_e
    its mean router probability."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_i = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.router_scale:
        topk_w = topk_w / torch.sum(topk_w, dim=-1, keepdim=True)
    e = cfg.n_experts
    lead = tuple(range(topk_i.dim() - 1))
    f_e = torch.mean(
        torch.sum(F.one_hot(topk_i, e).float(), dim=-2), dim=lead) / cfg.top_k
    p_e = torch.mean(probs, dim=tuple(range(probs.dim() - 1)))
    return topk_w, topk_i, f_e, p_e


def _aux(cfg, f_e, p_e):
    """The load-balance loss E * sum_e f_e p_e (f32)."""
    return cfg.n_experts * torch.sum(f_e * p_e)


def capacity_for(cfg, n_tokens: int, factor: Optional[float] = None) -> int:
    """Slots per expert for ``n_tokens``: ceil(n k / E * factor) rounded up
    to a multiple of 8, at least 8.  ``factor`` defaults to the knob
    ``moe_capacity_factor`` when it is set (``perf.knobs``), else to
    ``cfg.moe_capacity_factor``, as in the reference."""
    if factor is None and knobs().moe_capacity_factor > 0:
        factor = knobs().moe_capacity_factor
    factor = factor if factor is not None else cfg.moe_capacity_factor
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * factor))
    return max(8, -(-c // 8) * 8)


class Plan(NamedTuple):
    """Where each entry goes.  Entries are the N * k (token, slot) pairs in
    token-major order; slots of the (E * C) buffer are expert-major.

    src: (E * C,) the entry that fills each slot, N * k for an empty one
    (the appended zero row); dst: (N * k,) the slot of each entry, E * C
    for a dropped one (the zero row appended to the outputs)."""
    src: torch.Tensor
    dst: torch.Tensor


def dispatch_plan(topk_i, n_experts: int, capacity: int) -> Plan:
    """The sort-based assignment of JAX's ``_dispatch_compute_combine``:
    entries sorted stably by expert, rank within the expert, kept at rank
    < C.  topk_i: (N, k)."""
    flat_e = topk_i.reshape(-1)
    nk, dev = flat_e.shape[0], flat_e.device
    se, order = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(nk, device=dev) - first
    # each entry's slot, in the entries' own order
    inv = torch.argsort(order)
    rank_e = rank[inv]
    dst = torch.where(rank_e < capacity, flat_e * capacity + rank_e,
                      torch.full_like(flat_e, n_experts * capacity))
    # each slot's entry: expert e's r-th sorted entry, if it has r + 1
    experts = torch.arange(n_experts, device=dev, dtype=se.dtype)
    start = torch.searchsorted(se, experts, side="left")
    end = torch.searchsorted(se, experts, side="right")
    pos = start[:, None] + torch.arange(capacity, device=dev)[None, :]
    filled = pos < end[:, None]
    src = torch.where(filled, order[pos.clamp(max=nk - 1)],
                      torch.full_like(pos, nk)).reshape(-1)
    return Plan(src=src, dst=dst)


def _dispatch_compute_combine(cfg, x_flat, topk_w, topk_i, bank,
                              capacity: int, ax=None):
    """x_flat: (N, D); topk_*: (N, k) -> y (N, D) in x's dtype.

    With ``ax`` (the model axis of ``train_sp``, T ranks) the bank holds
    this rank's E/T experts: the (E C, D) buffer, expert-major, is T
    blocks of E/T experts, block t going to rank t by one all-to-all;
    the rank runs its experts over the T ranks' slots and the inverse
    all-to-all brings each block's outputs home (the reference's
    ``lax.all_to_all`` pair)."""
    N, D = x_flat.shape
    k, e, C = cfg.top_k, cfg.n_experts, capacity
    plan = dispatch_plan(topk_i, e, C)
    zero = x_flat.new_zeros((1, D))
    rows = torch.cat([x_flat[:, None, :].expand(N, k, D).reshape(N * k, D),
                      zero])
    grouped = torch.index_select(rows, 0, plan.src)
    if ax is None:
        out = _expert_ffn(bank, grouped.reshape(e, C, D)).reshape(e * C, D)
    else:
        T, e_loc = ax.size, e // ax.size
        recv = COLL.all_to_all(grouped.reshape(T, e_loc * C, D))
        # (T, E/T, C, D) -> each of this rank's experts over T C slots
        mine = recv.reshape(T, e_loc, C, D).transpose(0, 1).reshape(
            e_loc, T * C, D)
        out = _expert_ffn(bank, mine).reshape(e_loc, T, C, D).transpose(
            0, 1).reshape(T, e_loc * C, D)
        out = COLL.all_to_all(out).reshape(e * C, D)
    back = torch.index_select(torch.cat([out, zero]), 0, plan.dst)
    contrib = back.reshape(N, k, D) * topk_w.to(x_flat.dtype)[..., None]
    return torch.sum(contrib, dim=1)


def moe_apply(cfg, params, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux f32), the shared experts added.
    The capacity is that of the B * S tokens of the call (a decode step:
    of B).

    Under ``train_sp`` x is this rank's columns and ``params["experts"]``
    its E/T experts (``blocks.block_forward`` passes the bank's ZeRO-3
    shard through ``dist.sharding.use_shard``: no gather).  Routing and
    the capacity are the rank's tokens' (B S/T of them); the router's
    f_e and p_e are averaged over the model axis before the aux product,
    as the reference's pmean does (a dp rank's tokens are other workers',
    each with its own aux in the psum step)."""
    B, S, D = x.shape
    topk_w, topk_i, f_e, p_e = _route(cfg, params["router"], x)
    ax = None
    if shd.seq_parallel():
        ax = COLL.model_axis()
        bank_e = params["experts"]["w_gate"].shape[0]
        if cfg.n_experts % ax.size or bank_e * ax.size != cfg.n_experts:
            raise ValueError(
                f"expert parallelism over {ax.size} ranks: {cfg.n_experts} "
                f"experts, a bank of {bank_e} on this rank (its ZeRO-3 "
                f"shard must be E/T experts on dim 0)")
        f_e, p_e = COLL.model_mean(f_e), COLL.model_mean(p_e)
    aux = _aux(cfg, f_e, p_e)
    C = capacity_for(cfg, B * S)
    y = _dispatch_compute_combine(
        cfg, x.reshape(-1, D), topk_w.reshape(-1, cfg.top_k),
        topk_i.reshape(-1, cfg.top_k), params["experts"], C, ax)
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        sp = params["shared"]
        h = F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])
        y = y + h @ sp["w_down"]
    return y, aux
