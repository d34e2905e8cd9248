"""Criteo-like CTR stream and sequential-rec batches (stateless, seeded);
the port's copy of ``repro.data.recsys_data``, draw for draw."""
from __future__ import annotations

from typing import Sequence

import numpy as np


class CTRStream:
    """Synthetic click stream with a planted logistic ground truth so models
    can actually fit it: label ~ sigmoid(w·dense + embedding interactions)."""

    def __init__(self, n_dense: int, table_sizes: Sequence[int], *,
                 seed: int = 0):
        self.n_dense = n_dense
        self.table_sizes = tuple(table_sizes)
        self.seed = seed
        rng = np.random.default_rng(seed)
        self.w_dense = rng.normal(0, 0.5, size=n_dense)
        # hash-based per-field latent preference (no giant tables needed)
        self.field_salt = rng.integers(1, 1 << 31, size=len(table_sizes))

    def batch(self, step: int, batch: int) -> dict:
        rng = np.random.default_rng(self.seed * 31_337 + step)
        dense = rng.lognormal(0, 1, size=(batch, self.n_dense)).astype(
            np.float32)
        sparse = np.stack(
            [rng.integers(0, v, size=batch) for v in self.table_sizes],
            axis=1)
        # planted signal: parity-ish hash of (field, id)
        h = (sparse * self.field_salt[None, :]) % 97
        logit = (np.log1p(dense) @ self.w_dense) * 0.1 \
            + (h.mean(axis=1) - 48.0) * 0.08
        label = (rng.random(batch) < 1 / (1 + np.exp(-logit)))
        return {
            "dense": dense,
            "sparse": sparse.astype(np.int32),
            "label": label.astype(np.float32),
        }


class SeqRecStream:
    """Item-sequence batches for BERT4Rec (masked) and MIND (next-item)."""

    def __init__(self, n_items: int, *, seed: int = 0, n_patterns: int = 512,
                 pat_len: int = 8):
        self.n_items = n_items
        self.seed = seed
        rng = np.random.default_rng(seed)
        # users follow latent "tastes": repeating item patterns
        self.patterns = rng.integers(1, n_items + 1,
                                     size=(n_patterns, pat_len))

    def _sequences(self, rng, batch: int, seq_len: int):
        n_chunks = -(-seq_len // self.patterns.shape[1])
        pat = self.patterns[
            rng.integers(0, len(self.patterns), size=(batch, n_chunks))]
        seq = pat.reshape(batch, -1)[:, :seq_len]
        return seq

    def bert4rec_batch(self, step: int, batch: int, seq_len: int,
                       mask_prob: float = 0.2, *, mask_token: int = None,
                       max_preds: int = 20) -> dict:
        rng = np.random.default_rng(self.seed * 65_537 + step)
        mask_token = mask_token or (self.n_items + 1)
        seq = self._sequences(rng, batch, seq_len)
        is_masked = rng.random((batch, seq_len)) < mask_prob
        is_masked[:, 0] |= ~is_masked.any(axis=1)     # at least one mask
        tgt = np.where(is_masked, seq, 0)
        seq_in = np.where(is_masked, mask_token, seq)
        # gather up to max_preds masked positions per row
        pos = np.zeros((batch, max_preds), np.int32)
        mtgt = np.zeros((batch, max_preds), np.int32)
        mmask = np.zeros((batch, max_preds), np.float32)
        for i in range(batch):
            idx = np.nonzero(is_masked[i])[0][:max_preds]
            pos[i, :len(idx)] = idx
            mtgt[i, :len(idx)] = tgt[i, idx]
            mmask[i, :len(idx)] = 1.0
        return {
            "seq": seq_in.astype(np.int32),
            "mask": np.ones((batch, seq_len), bool),
            "mlm_pos": pos, "mlm_tgt": mtgt, "mlm_mask": mmask,
        }

    def mind_batch(self, step: int, batch: int, hist_len: int) -> dict:
        rng = np.random.default_rng(self.seed * 104_729 + step)
        seq = self._sequences(rng, batch, hist_len + 1)
        return {
            "hist": seq[:, :hist_len].astype(np.int32),
            "hist_mask": np.ones((batch, hist_len), bool),
            "target": seq[:, hist_len].astype(np.int32),
        }
