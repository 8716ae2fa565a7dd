"""Minimal batched serving engine: prefill + greedy/temperature decode.

Twin of ``repro.serving.engine`` for every family the port's model
covers (dense LMs, MoE and xLSTM).  On the card, attention runs through
the Hopper flash-attention kernel in prefill and in every decode step; the
MoE layers route and dispatch in plain PyTorch, as JAX computes them (a
decode step at the capacity of its B tokens, at least 8 slots an expert,
so it reads every expert bank); the xLSTM mLSTM blocks run their prefill
through the Hopper ``mlstm_chunk`` kernel and decode by a plain recurrence
step, as JAX computes it.
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import random as R
from repro_torch import resolve_device
from repro_torch.models import model as M


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


@dataclass
class ServeEngine:
    cfg: object
    params: dict
    max_len: int = 512          # unused, as in JAX: caches grow to S + n_new
    device: Optional[str] = None  # None = the card; raises without one
    # optional repro_torch.obs.ObsRun: prefill/decode/fetch spans stamp
    # host perf_counter edges around the launches; they time the
    # launches and never add a synchronize
    obs: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = _to_device(self.params, self.device)

    # reprolint: hot-path
    def generate(self, tokens: np.ndarray, n_new: int,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """tokens: (B, S) prompt -> (B, n_new) generated ids (int32).

        Greedy decoding is argmax.  Temperature decoding draws from the
        ``jax.random`` twin as JAX does: ``categorical`` with ``PRNGKey(seed)``
        for the first token, then with a key split off once a token, so the
        same seed gives JAX's ids.
        """
        B, S = tokens.shape
        dev = self.device
        key = R.PRNGKey(seed, device=dev)
        tracer = self.obs.trace if self.obs is not None else None

        def span(name, **attrs):
            return (tracer.span(name, track="serving", **attrs)
                    if tracer is not None else nullcontext())

        with torch.inference_mode():
            toks = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
            positions = torch.arange(S, device=dev).expand(B, S)
            with span("serve.prefill", batch=B, seq=S):
                last_logits, caches = M.prefill(
                    self.cfg, self.params,
                    {"tokens": toks, "positions": positions})
            caches = M.pad_caches(caches, S + n_new)
            out = []
            nxt = self._sample(last_logits, temperature, key)
            with span("serve.decode", batch=B, n_new=n_new):
                for t in range(n_new):
                    # keep the loop sync-free: collect DEVICE tensors;
                    # ``pos`` is a host int, so no launch waits on the card
                    out.append(nxt)
                    logits, caches = M.decode_step(self.cfg, self.params,
                                                   nxt[:, None], S + t,
                                                   caches)
                    # greedy ids never read a key: split only when sampling
                    key, sub = (R.split(key) if temperature > 0.0
                                else (key, None))
                    nxt = self._sample(logits[:, 0], temperature, sub)
            with span("serve.fetch", batch=B, n_new=n_new):
                # the ONE fetch: all n_new tokens come back in a single
                # copy after the loop has been fully enqueued
                ids = torch.stack(out, dim=1).cpu()
        return ids.numpy().astype(np.int32)

    @staticmethod
    def _sample(logits, temperature, key):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        return R.categorical(key, logits / temperature, axis=-1)
