"""Synthetic data: verbatim copies of ``repro.data.synthetic``'s
``SyntheticLM`` and ``SyntheticImages``.

Kept in numpy so both packages draw identical batches from the same
seeds: ``SyntheticLM`` gives order-2 Markov token streams with per-stream
structure, a next-token task a transformer can learn; ``SyntheticImages``
gives CIFAR-shaped class-template images plus noise, the stand-in for
CIFAR-10 in the ResNet-18 accuracy experiments.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seed: int = 0, order: int = 2):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        # sparse-ish transition structure: each (prev, prev2) context prefers
        # a handful of next tokens
        self.ctx_mod = 997
        self.table = rng.integers(0, vocab_size, size=(self.ctx_mod, 4))
        self.rng = rng

    def sample(self, batch: int, seq_len: int, rng=None):
        rng = rng or self.rng
        out = np.empty((batch, seq_len), dtype=np.int32)
        t1 = rng.integers(0, self.vocab, batch)
        t2 = rng.integers(0, self.vocab, batch)
        for i in range(seq_len):
            ctx = (t1 * 31 + t2 * 17) % self.ctx_mod
            choice = rng.integers(0, 4, batch)
            nxt = self.table[ctx, choice]
            noise = rng.random(batch) < 0.05
            nxt = np.where(noise, rng.integers(0, self.vocab, batch), nxt)
            out[:, i] = nxt
            t2, t1 = t1, nxt
        return out


class SyntheticImages:
    """(x [N,32,32,3] float32, y [N] int) with class-dependent templates."""

    def __init__(self, num_classes: int = 10, seed: int = 0, noise: float = 0.6):
        rng = np.random.default_rng(seed)
        self.templates = rng.normal(0, 1, (num_classes, 32, 32, 3)).astype(np.float32)
        self.num_classes = num_classes
        self.noise = noise
        self.rng = rng

    def sample(self, n: int, rng=None):
        rng = rng or self.rng
        y = rng.integers(0, self.num_classes, n)
        x = self.templates[y] + rng.normal(0, self.noise, (n, 32, 32, 3)).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)
