"""Plain version of ``mlstm_chunk``: the chunked stabilized linear recurrence.

Twin of the local path of ``repro.models.ssm`` (``linear_recurrence`` and
its chunk machinery).  The recurrence over chunk states

    S_t = exp(g_t) * S_{t-1} + exp(i_t) * k_t v_t^T

runs in chunkwise-parallel form: quadratic (attention-like) math inside a
chunk and a sequential scan over chunk states.  By default the outputs are
normalized and q k is scaled by 1/sqrt(dq), as the xLSTM block asks; the
Hymba Mamba sublayer asks for ``normalize=False, scale=1.0``, with q/k
``dq`` wide and v ``dv`` wide.  Unnormalized, the output is the numerator
relative to the running stabilizer m_t (the state's own running max, the
same whatever the chunking), exactly as JAX returns it.

One departure from JAX's f32 arithmetic: the cumulative log decay ``lg``
within a chunk is summed in f64.  The chunk form takes differences
``lg_t - lg_s`` of two sums of up to a chunk of log gates; with gates near
log(sigmoid(-10)) |lg| reaches hundreds, and in f32 each difference then
carries ~1e-4 of rounding into every exponent, which puts the output
outside 5e-4 of the sequential oracle (``ref.reference_mlstm``) where the
normalizer cancels.  In f64 the differences keep f32 precision.

Under the ``train_sp`` layout the sequence is split over the "model" axis
and ``linear_recurrence`` takes the JAX module's branch
(``src/repro/models/ssm.py:163-181``): each rank scans its own columns
from the zero state, the ranks' final states are gathered over the axis
(``shard_states``), the combine of ranks 0..s-1 in order is rank s's
exclusive prefix, which is combined into every local entering state, and
the global final state is returned on every rank.  ``local_recurrence``
is the one-rank function under every layout: what the ``mlstm_chunk``
wrapper runs on CPU tensors, what its autograd Function recomputes, and
what ``chip_smoke.py`` holds the kernel against.

It lives in the kernels layer for that reason; ``models.ssm`` takes
``ScanState`` and ``combine`` from here for its decode step.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.dist import sharding as shd

NEG = -1e30


class ScanState(NamedTuple):
    """Stabilized recurrence state: true_C = C * exp(m); loga = log of the
    total decay this state spans (identity: loga=0, m=NEG, C=n=0)."""
    loga: torch.Tensor  # (..., h)
    m: torch.Tensor     # (..., h)
    C: torch.Tensor     # (..., h, dq, dv)
    n: torch.Tensor     # (..., h, dq)


def _bc(s, x):
    return s.reshape(tuple(s.shape) + (1,) * (x.dim() - s.dim()))


def _map(fn, state: ScanState) -> ScanState:
    return ScanState(*(fn(t) for t in state))


def state_identity(shape_hint: ScanState) -> ScanState:
    return ScanState(
        loga=torch.zeros_like(shape_hint.loga),
        m=torch.full_like(shape_hint.m, NEG),
        C=torch.zeros_like(shape_hint.C),
        n=torch.zeros_like(shape_hint.n))


def combine(s1: ScanState, s2: ScanState) -> ScanState:
    """Associative combine: apply s1's span, then s2's."""
    loga = s1.loga + s2.loga
    m = torch.maximum(s1.m + s2.loga, s2.m)
    a1 = torch.exp(s1.m + s2.loga - m)
    a2 = torch.exp(s2.m - m)
    return ScanState(
        loga=loga, m=m,
        C=s1.C * _bc(a1, s1.C) + s2.C * _bc(a2, s2.C),
        n=s1.n * _bc(a1, s1.n) + s2.n * _bc(a2, s2.n))


# ---------------------------------------------------------------------------
# Chunk elements / outputs.
# ---------------------------------------------------------------------------


def _chunk_states(k, v, g, i) -> ScanState:
    """Per-chunk recurrence elements.

    k: (B, nc, c, h, dq); v: (B, nc, c, h, dv); g/i: (B, nc, c, h).
    """
    lg = torch.cumsum(g.double(), dim=2)      # f64: see the module note
    tot = lg[:, :, -1]                        # (B, nc, h)
    # carry-to-chunk-end log weight
    w = (tot[:, :, None] - lg).float() + i
    m_loc = torch.amax(w, dim=2)              # (B, nc, h)
    sc = torch.exp(w - m_loc[:, :, None])
    C = torch.einsum("bnchq,bnchv->bnhqv", sc[..., None] * k, v)
    n = torch.einsum("bnch,bnchq->bnhq", sc, k)
    return ScanState(loga=tot.float(), m=m_loc, C=C, n=n)


def _chunk_outputs(q, k, v, g, i, ent: ScanState, *, normalize: bool = True,
                   scale: Optional[float] = None):
    """Outputs for every position given the entering state of each chunk:
    normalized, or the numerator at the stabilizer m_out."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    lg = torch.cumsum(g.double(), dim=2)                 # (B,nc,c,h), f64
    # intra-chunk log decay matrix D[t,s] = lg_t - lg_s + i_s (s <= t)
    D = ((lg[:, :, :, None, :] - lg[:, :, None, :, :]).float()
         + i[:, :, None, :, :])                          # (B,nc,t,s,h)
    c = q.shape[2]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    D = torch.where(tri[None, None, :, :, None], D,
                    torch.full_like(D, NEG))
    m_intra = torch.amax(D, dim=3)                       # (B,nc,t,h)
    lg_e = lg + ent.m[:, :, None, :]                     # inter log scale
    m_out = torch.maximum(lg_e.float(), m_intra)
    W = torch.exp(D - m_out[:, :, :, None, :])           # (B,nc,t,s,h)
    qf = q.float()
    dot = torch.einsum("bnthq,bnshq->bntsh", qf, k.float()) * scale
    WS = W * dot
    num = torch.einsum("bntsh,bnshv->bnthv", WS, v.float())
    sc_e = torch.exp((lg_e - m_out).float())             # (B,nc,t,h)
    qC = torch.einsum("bnthq,bnhqv->bnthv", qf, ent.C) * scale
    num = num + sc_e[..., None] * qC
    if not normalize:
        return num
    qn = torch.einsum("bnthq,bnhq->bnth", qf, ent.n) * scale
    den = torch.sum(WS, dim=3) + sc_e * qn               # (B,nc,t,h)
    den = torch.maximum(torch.abs(den), torch.exp(-m_out))
    return num / den[..., None]


def _local_scan(elems: ScanState):
    """Sequential scan over the chunk dim; returns (entering, final)."""
    carry = state_identity(_map(lambda t: t[:, 0], elems))
    entering = []
    for ci in range(elems.loga.shape[1]):
        entering.append(carry)
        carry = combine(carry, _map(lambda t: t[:, ci], elems))
    stacked = ScanState(*(torch.stack(ts, dim=1) for ts in zip(*entering)))
    return stacked, carry


def _chain(parts):
    """The combine of ``parts`` in order, left to right (None when empty)."""
    out = None
    for part in parts:
        out = part if out is None else combine(out, part)
    return out


def shard_states(own: ScanState):
    """Under ``train_sp`` on T > 1 ranks: ``own``, this rank's final state
    over its columns from the zero state, gathered over the model axis
    (``dist.collectives.stack_gather``: one all-gather; backward, a
    reduce-scatter) -> (prefix, final, gathered).  ``prefix`` is the
    combine of ranks 0..s-1's states in order, the state entering this
    rank's columns (None on rank 0); ``final`` is the combine of all T, the
    sequence's final state, the same on every rank.  Only the last rank's
    ``final`` carries a gradient (the reference's ``psum`` of the last
    rank's final: every rank's loss reads the same replicated state, so
    its cotangent is counted once).  The combines start from rank 0's state
    itself, which is what ``combine`` of the identity with it gives, bit
    for bit.  ``gathered`` (the four stacked tensors) is for rank 0 to tie
    into its y (``collectives.depend``): every rank must join the gather's
    backward, rank 0 too, whose y reads no other rank's state."""
    from repro_torch.dist import collectives   # collectives imports this
    ax = collectives.model_axis()
    s, T = ax.index, ax.size
    gathered = collectives.stack_gather(tuple(own))
    parts = [ScanState(*(t[j] for t in gathered)) for j in range(T)]
    prefix = _chain(parts[:s])
    if s == T - 1:
        final = combine(prefix, parts[s])
    else:
        final = _chain([_map(torch.Tensor.detach, p) for p in parts])
    return prefix, final, gathered


def linear_recurrence(q, k, v, g, i, *, chunk: int = 128,
                      init_state: Optional[ScanState] = None,
                      normalize: bool = True, scale: Optional[float] = None):
    """Chunked linear recurrence over q/k (B, S, h, dq) and v (B, S, h, dv).

    Returns (y (B,S,h,dv) f32, final_state).  The chunk is ``chunk`` when it
    divides S and S is longer, else the whole of S, as in JAX.  ``scale``
    (None: 1/sqrt(dq)) multiplies q k; ``normalize=False`` returns JAX's
    unnormalized numerator.  Under ``train_sp`` on more than one rank, q..i
    are this rank's columns, which start from the exclusive prefix of the
    ranks before it; the final state is the whole sequence's, on every
    rank (the module note).
    """
    sharded = shd.seq_parallel() and shd.layout().n_shards > 1
    return _recurrence(q, k, v, g, i, chunk, init_state, normalize, scale,
                       sharded)


def local_recurrence(q, k, v, g, i, *, chunk: int = 128,
                     init_state: Optional[ScanState] = None,
                     normalize: bool = True, scale: Optional[float] = None):
    """``linear_recurrence`` on this rank's tensors as the whole sequence,
    whatever the layout."""
    return _recurrence(q, k, v, g, i, chunk, init_state, normalize, scale,
                       False)


def _recurrence(q, k, v, g, i, chunk, init_state, normalize, scale,
                sharded):
    B, S, h, dq = q.shape
    dv = v.shape[-1]
    c = chunk if S % chunk == 0 and S > chunk else S
    nc = S // c

    def rs(t, d):
        return t.reshape(B, nc, c, h, d)

    qc, kc, vc = rs(q, dq), rs(k, dq), rs(v, dv)
    gc = g.reshape(B, nc, c, h).float()
    ic = i.reshape(B, nc, c, h).float()
    elems = _chunk_states(kc.float(), vc.float(), gc, ic)
    entering, final = _local_scan(elems)
    tie = ()   # rank 0's y reads no other rank's state
    if sharded:
        prefix, final, gathered = shard_states(final)
        if prefix is None:
            tie = gathered
        else:
            entering = combine(_map(lambda t: t[:, None], prefix), entering)
    if init_state is not None:
        entering = combine(_map(lambda t: t[:, None], init_state), entering)
        final = combine(init_state, final)
    y = _chunk_outputs(qc, kc, vc, gc, ic, entering, normalize=normalize,
                       scale=scale)
    if tie:
        from repro_torch.dist import collectives
        y = collectives.depend(y, *tie)
    return y.reshape(B, S, h, dv), final
