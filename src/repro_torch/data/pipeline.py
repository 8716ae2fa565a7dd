"""Deterministic synthetic data (a copy of ``repro.data.pipeline``).

The port keeps its own copies of the numpy-only ``SyntheticTokens`` and
``SyntheticImages`` so that it never imports the JAX package; equal seeds
give equal batches.

The paper (§4.3) requires sampling mini-batches WITH REPLACEMENT rather than
pre-partitioning data onto workers: under cutoff SGD a persistently-slow
worker would otherwise never contribute its shard.  ``SyntheticTokens``
implements exactly that: every (step, worker) pair draws its sub-mini-batch
by seeded hash, so any worker's draw is reproducible regardless of which
workers were dropped — this is also what makes checkpoint/restart and
elastic resizing deterministic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass
class SyntheticTokens:
    """Markov-chain token stream → (tokens, labels) batches.

    A fixed random transition structure gives a learnable distribution
    (loss decreases materially from uniform), unlike iid-uniform tokens.
    """
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branch: int = 16  # successors per token

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.succ = rng.integers(0, self.vocab_size,
                                 size=(self.vocab_size, self.branch))

    def _gen(self, rng: np.random.Generator, n: int) -> np.ndarray:
        toks = np.empty((n, self.seq_len + 1), np.int64)
        cur = rng.integers(0, self.vocab_size, size=n)
        for t in range(self.seq_len + 1):
            toks[:, t] = cur
            pick = rng.integers(0, self.branch, size=n)
            cur = self.succ[cur, pick]
        return toks

    def batch(self, step: int, worker: Optional[int] = None,
              n_workers: int = 1) -> Dict[str, np.ndarray]:
        """Batch for (step, worker) — sampling with replacement by seed."""
        if worker is None:
            rng = np.random.default_rng((self.seed, step))
            n = self.global_batch
        else:
            if self.global_batch % n_workers != 0:
                raise ValueError(
                    f"global batch {self.global_batch} is not divisible by "
                    f"{n_workers} workers — per-worker draws would silently "
                    f"truncate and disagree with the worker=None full batch "
                    f"(pick a worker count that divides {self.global_batch},"
                    f" matching the Trainer's B % W check)")
            rng = np.random.default_rng((self.seed, step, worker))
            n = self.global_batch // n_workers
        toks = self._gen(rng, n)
        pos = np.broadcast_to(np.arange(self.seq_len), (n, self.seq_len))
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
                "positions": np.ascontiguousarray(pos.astype(np.int32))}

    def state(self) -> dict:
        return {"seed": self.seed}


@dataclass
class SyntheticImages:
    """Class-conditional Gaussian images (the MNIST stand-in: no dataset
    is downloaded).  10 classes, 28x28, fixed class templates."""
    n_classes: int = 10
    side: int = 28
    noise: float = 0.35
    seed: int = 0
    n_train: int = 60_000
    n_valid: int = 10_000

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.templates = rng.normal(size=(self.n_classes, self.side,
                                          self.side)).astype(np.float32)
        # smooth the templates to make the task non-trivial but learnable
        for _ in range(2):
            t = self.templates
            self.templates = (t + np.roll(t, 1, 1) + np.roll(t, -1, 1)
                              + np.roll(t, 1, 2) + np.roll(t, -1, 2)) / 5.0

    def _make(self, rng, n):
        y = rng.integers(0, self.n_classes, size=n)
        x = self.templates[y] + self.noise * rng.normal(
            size=(n, self.side, self.side)).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    def batch(self, step: int, batch_size: int,
              worker: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed, step, 2**31 - 1 if worker is None else worker))
        return self._make(rng, batch_size)

    def valid_set(self) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, 10**9))
        return self._make(rng, self.n_valid)
