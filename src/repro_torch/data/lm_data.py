"""Deterministic synthetic LM token streams (the port's copy of
``repro.data.lm_data``, draw for draw).

A seeded Markov-ish stream: per-position tokens are drawn from a mixture of
(a) a repeated-ngram process (so the model has learnable structure and the
loss visibly decreases) and (b) uniform noise. Stateless — batch(step) is a
pure function of (seed, step), which makes the input pipeline
preemption-safe and host-replicable.
"""
from __future__ import annotations

import numpy as np


class LMStream:
    def __init__(self, vocab_size: int, *, seed: int = 0, ngram: int = 8,
                 n_patterns: int = 4096):
        self.vocab_size = vocab_size
        self.seed = seed
        self.ngram = ngram
        rng = np.random.default_rng(seed)
        self.patterns = rng.integers(
            2, vocab_size, size=(n_patterns, ngram), dtype=np.int64)

    def batch(self, step: int, batch: int, seq_len: int) -> dict:
        rng = np.random.default_rng(self.seed * 7_919 + step)
        n_chunks = -(-(seq_len + 1) // self.ngram)
        pat = self.patterns[
            rng.integers(0, len(self.patterns), size=(batch, n_chunks))]
        toks = pat.reshape(batch, n_chunks * self.ngram)[:, : seq_len + 1]
        noise = rng.random((batch, seq_len + 1)) < 0.05
        toks = np.where(
            noise, rng.integers(2, self.vocab_size, size=toks.shape), toks)
        return {"tokens": toks.astype(np.int32)}
