"""Minimal batched serving engine: prefill + greedy/temperature decode.

Twin of ``repro.serving.engine`` for every family (dense LMs, MoE, xLSTM,
Hymba, whisper and qwen2-vl).  On the card, attention runs through the
Hopper flash-attention kernel in prefill and in every decode step (a
sliding-window layer's decode reads only the window's keys: the kernel's
``key_range``; whisper's cross-attention reads every frame's keys,
non-causally, from the cache its prefill wrote); the MoE layers route
and dispatch in plain PyTorch, as JAX computes them (a decode step at
the capacity of its B tokens, at least 8 slots an expert, so it reads
every expert bank); the xLSTM mLSTM blocks and Hymba's Mamba heads run
their prefill through the Hopper ``mlstm_chunk`` kernel and decode by a
plain recurrence step, as JAX computes it.

The reference compiles its decode step once and dispatches it once a
token (``jax.jit``).  The port's counterpart on the card is a CUDA graph
of the whole step, replayed once a token.  The step reads its position
from the device and writes the token, the position, the key and every
cache back into the graph's own buffers, so a replay launches nothing
from Python and waits for nothing; the ids come back in one fetch after
the loop.  Since attention reads the cache length from the device, one
graph a (batch, greedy or sampled) serves every request whose prompt and
new tokens fit its caches: they are padded to ``max_len`` slots (or to a
longer request's length, which replaces the graph), and prefill's caches
are copied into their first slots.  Prefill stays eager (its shape
changes with every prompt), and on the CPU the same step runs eagerly.
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import random as R
from repro_torch import resolve_device
from repro_torch import tree
from repro_torch.models import model as M


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _sample(logits, temperature, key):
    """Greedy argmax, or ``categorical`` at ``temperature`` (a 0-d f32
    tensor) from ``key``; the division is taken in f32 and rounded to the
    logits' dtype, as a Python float divides them."""
    if temperature is None:
        return torch.argmax(logits, dim=-1)
    scaled = (logits.float() / temperature).to(logits.dtype)
    return R.categorical(key, scaled, axis=-1)


class DecodeState:
    """The buffers one decode step reads and writes in place: the token
    (B, 1), ``pos`` (0-d int64), the step ``t`` (1,), the sampling key
    (2,) and temperature (0-d f32, sampled steps only), the ids (B, L) and
    the padded caches.  A CUDA graph of :meth:`step` owns one of these."""

    def __init__(self, cfg, params, caches, B: int, L: int, sampled: bool,
                 device):
        self.cfg, self.params = cfg, params
        self.caches = caches
        self.sampled = sampled
        self.tok = torch.zeros((B, 1), dtype=torch.int64, device=device)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.t = torch.zeros((1,), dtype=torch.int64, device=device)
        self.key = torch.zeros((2,), dtype=torch.int64, device=device)
        self.temperature = (torch.ones((), dtype=torch.float32,
                                       device=device) if sampled else None)
        self.ids = torch.zeros((B, L), dtype=torch.int64, device=device)
        self.capacity = L
        self.logits = None

    def load(self, caches, tok, pos: int, key, temperature: float):
        """A request's start: prefill's caches (its KV caches into their
        first ``pos`` slots; the slots after them are masked by the length
        and never read), its first token, the position S, the key after
        the first draw, the temperature."""
        for dst, src in zip(tree.leaves(self.caches), tree.leaves(caches)):
            if dst is src:
                continue
            if dst.shape != src.shape:   # a KV cache: (B, slots, KV, hd)
                dst = dst.narrow(dst.dim() - 3, 0, src.shape[-3])
            dst.copy_(src)
        self.tok.copy_(tok[:, None])
        self.pos.fill_(pos)
        self.t.zero_()
        self.key.copy_(key)
        if self.sampled:
            self.temperature.fill_(temperature)

    def clone(self) -> "DecodeState":
        """A copy of every buffer (the warm-up before a capture must not
        step the real state)."""
        other = object.__new__(DecodeState)
        other.__dict__.update(self.__dict__)
        for name in ("tok", "pos", "t", "key", "ids"):
            setattr(other, name, getattr(self, name).clone())
        if self.sampled:
            other.temperature = self.temperature.clone()
        other.caches = tree.map(torch.clone, self.caches)
        return other

    def step(self):
        """One token, written into this state's buffers: the token goes to
        column t of ``ids``, the model steps at ``pos``, its new SSM and
        conv leaves are copied over the old ones (the KV caches are written
        in place), the next token is sampled (the key split first, as JAX
        splits it once a token), then ``pos`` and ``t`` advance.  Nothing
        reads a value off the card.  Returns the step's logits."""
        self.ids.index_copy_(1, self.t, self.tok)
        logits, new = M.decode_step(self.cfg, self.params, self.tok,
                                    self.pos, self.caches)
        for dst, src in zip(tree.leaves(self.caches), tree.leaves(new)):
            if src is not dst:
                dst.copy_(src)
        sub = None
        if self.sampled:
            key, sub = R.split(self.key)
            self.key.copy_(key)
        self.tok.copy_(_sample(logits[:, 0], self.temperature, sub)[:, None])
        self.pos.add_(1)
        self.t.add_(1)
        self.logits = logits
        return logits


@dataclass
class DecodeGraph:
    """A CUDA graph of :meth:`DecodeState.step` over its own state."""
    state: DecodeState
    graph: object
    replays: int = 0

    @classmethod
    def capture(cls, state: DecodeState) -> "DecodeGraph":
        """Warm the step up on a side stream over a copy of the state (the
        libraries' lazy set-up must not happen inside the capture), then
        capture it.  The capture is thread-local: a call that waits for
        the card or copies to the host breaks it, and a failed capture
        raises."""
        side = torch.cuda.Stream(state.tok.device)
        side.wait_stream(torch.cuda.current_stream(state.tok.device))
        with torch.cuda.stream(side):
            state.clone().step()
        torch.cuda.current_stream(state.tok.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            state.step()
        return cls(state, graph)

    def replay(self):
        self.graph.replay()
        self.replays += 1


@dataclass
class ServeEngine:
    cfg: object
    params: dict
    # the decode caches' slots: at least S + n_new (JAX's caches grow to
    # exactly that and never read max_len; the ids are the same)
    max_len: int = 512
    device: Optional[str] = None  # None = the card; raises without one
    # optional repro_torch.obs.ObsRun: prefill/decode/fetch spans stamp
    # host perf_counter edges around the launches; they time the
    # launches and never add a synchronize
    obs: object = None
    # (B, sampled) -> DecodeGraph, on the card: one graph, its memory pool
    # and its caches a batch size and sampling mode, whatever the lengths
    graphs: dict = field(default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = _to_device(self.params, self.device)

    # reprolint: hot-path
    def generate(self, tokens: np.ndarray, n_new: int,
                 temperature: float = 0.0, seed: int = 0,
                 frames: Optional[np.ndarray] = None) -> np.ndarray:
        """tokens: (B, S) prompt -> (B, n_new) generated ids (int32).

        An encoder-decoder (whisper) takes ``frames`` (B, Se, D), zeros
        when none are given; an M-RoPE arch (qwen2-vl) gets (3, B, S)
        positions, three equal text streams, as the reference's engine
        gives them.  Greedy decoding is argmax.  Temperature decoding
        draws from the ``jax.random`` twin as JAX does: ``categorical``
        with ``PRNGKey(seed)`` for the first token, then with a key split
        off once a token, so the same seed gives JAX's ids.  On the card
        the decode loop is one graph replay a token (the graph of this
        batch size and sampling mode is captured at its first use).
        """
        B, S = tokens.shape
        dev = self.device
        sampled = temperature > 0.0
        key = R.PRNGKey(seed, device=dev)
        tracer = self.obs.trace if self.obs is not None else None

        def span(name, **attrs):
            return (tracer.span(name, track="serving", **attrs)
                    if tracer is not None else nullcontext())

        with torch.inference_mode():
            toks = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
            batch = {"tokens": toks,
                     "positions": torch.arange(S, device=dev).expand(B, S)}
            if self.cfg.mrope_sections:
                batch["positions"] = batch["positions"].expand(3, B, S)
            if self.cfg.is_encoder_decoder:
                batch["frames"] = (
                    torch.as_tensor(frames, device=dev) if frames is not None
                    else torch.zeros((B, self.cfg.encoder_seq_len,
                                      self.cfg.d_model), device=dev))
            with span("serve.prefill", batch=B, seq=S):
                last_logits, caches = M.prefill(self.cfg, self.params,
                                                batch)
            temp = (torch.tensor(temperature, dtype=torch.float32,
                                 device=dev) if sampled else None)
            nxt = _sample(last_logits, temp, key)
            state = self._state(B, S + n_new, sampled, caches)
            state.load(caches, nxt, S, key, temperature)
            with span("serve.decode", batch=B, n_new=n_new):
                run = (self.graphs[(B, sampled)].replay
                       if dev.type == "cuda" else state.step)
                for _ in range(n_new):
                    run()
            with span("serve.fetch", batch=B, n_new=n_new):
                # reprolint: disable=host-sync-in-hot-path -- the ONE fetch: all n_new tokens come back in a single copy after the loop has been fully enqueued
                ids = state.ids[:, :n_new].cpu().numpy().astype(np.int32)
        return ids

    def _state(self, B: int, L: int, sampled: bool, caches) -> DecodeState:
        """A decode state of at least ``L`` slots over ``caches``' tree:
        on the card the state its (B, sampled) graph owns (captured now,
        at max(max_len, L) slots, if there is none or it is shorter than
        ``L``), on the CPU a fresh one."""
        key = (B, sampled)
        g = self.graphs.get(key)
        if g is not None and g.state.capacity >= L:
            return g.state
        L = max(self.max_len, L)
        state = DecodeState(self.cfg, self.params, M.pad_caches(caches, L),
                            B, L, sampled, self.device)
        if self.device.type == "cuda":
            self.graphs[key] = DecodeGraph.capture(state)
        return state
