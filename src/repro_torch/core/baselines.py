"""The TkQ baseline (reference: ``repro.core.baselines`` ``BM25``,
``tkq_scores``, ``tkq_topk``, paper Eq. 1): BM25 text relevance over token
ids mixed with linear spatial relevance. It feeds the hard negatives of
relevance training (``pipeline.mine_tkq_negatives``). k-means, IVF and
LSH wait with the other baselines (ROADMAP Queue A 10).

Scores are computed on a device in query blocks, with the reference's
dtypes: each BM25 term's contribution in float64 added into a float32
score in the reference's term order (ascending ids), the normalised text
score float32, the spatial part and the mix float64 (the corpus locations
are float64). Ties are ranked lowest object index first.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.index import topk_stable
from repro_torch.device import require_device


def document_frequency(docs: np.ndarray, vocab_size: int) -> np.ndarray:
    """``(V,)`` int64: the number of documents holding each token id (0 =
    pad not counted), each document counted once per distinct id."""
    srt = np.sort(docs, axis=1)
    first = np.ones(srt.shape, bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    first &= srt != 0
    return np.bincount(srt[first], minlength=vocab_size).astype(np.int64)


class BM25:
    """BM25 over token-id documents ``docs (N, L)`` (0 = pad), held on
    ``device``."""

    def __init__(self, docs: np.ndarray, *, k1=1.2, b=0.75,
                 vocab_size: Optional[int] = None, device="cuda"):
        self.device = require_device(device)
        self.k1, self.b = k1, b
        docs = np.asarray(docs)
        n, _ = docs.shape
        doc_len = (docs != 0).sum(1)
        self.avg_len = max(float(doc_len.mean()), 1.0)
        V = vocab_size or int(docs.max()) + 1
        df = document_frequency(docs, V)
        self.idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
        self.n, self.V = n, V
        norm = k1 * (1 - b + b * doc_len / self.avg_len)       # (N,) f64
        self.docs = torch.from_numpy(docs).to(self.device)
        self.norm = torch.from_numpy(norm).to(self.device)
        self._idf = torch.from_numpy(self.idf).to(self.device)

    def scores(self, q_tokens: np.ndarray) -> torch.Tensor:
        """``q_tokens (B, Lq)`` → ``(B, N)`` float32 BM25 scores on the
        device. A query's terms are its distinct ids above 1 (pad and CLS
        excluded), summed in ascending order."""
        q = np.asarray(q_tokens)
        terms = np.full(q.shape, -1, np.int64)
        for i in range(q.shape[0]):
            u = np.unique(q[i][q[i] > 1])
            terms[i, :u.size] = u
        out = torch.zeros((q.shape[0], self.n), dtype=torch.float32,
                          device=self.device)
        k1 = self.k1
        t_dev = torch.from_numpy(terms).to(self.device)
        for j in range(terms.shape[1]):
            t = t_dev[:, j:j + 1]                                # (B, 1)
            tf = (self.docs[None] == t[:, :, None]).sum(-1)     # (B, N)
            idf = torch.where(t >= 0, self._idf[t.clamp(min=0)],
                              torch.zeros((), dtype=torch.float64,
                                          device=self.device))
            contrib = idf * tf * (k1 + 1) / (tf + self.norm)
            out = (out.double() + contrib).float()
        return out


def tkq_scores(bm25: BM25, q_tokens, q_loc, obj_loc, *, alpha=0.4,
               dist_max=math.sqrt(2.0)) -> torch.Tensor:
    """Eq. 1: ``(1 − α)·SRel_linear + α·TRel_BM25`` normalised per query by
    its best BM25 score → ``(B, N)`` float64 on ``bm25``'s device."""
    dev = bm25.device
    t = bm25.scores(q_tokens)
    t_max = t.max(dim=1, keepdim=True).values
    t = t / torch.clamp(t_max, min=1e-9)
    ql = torch.as_tensor(np.asarray(q_loc, np.float64)).to(dev)
    ol = torch.as_tensor(np.asarray(obj_loc, np.float64)).to(dev)
    dx = ql[:, None, 0] - ol[None, :, 0]
    dy = ql[:, None, 1] - ol[None, :, 1]
    d = torch.sqrt(dx * dx + dy * dy)
    divisor = torch.tensor(dist_max, dtype=torch.float64, device=dev)
    srel = 1.0 - torch.clamp(d / divisor, 0.0, 1.0)
    return (1 - alpha) * srel + alpha * t


def tkq_topk(bm25: BM25, q_tokens, q_loc, obj_loc, k: int, *,
             batch: int = 256, **kw) -> np.ndarray:
    """The ``k`` best objects by :func:`tkq_scores` per query, ``(B, k)``
    int64 on the host, scored ``batch`` queries at a time."""
    out = []
    for s in range(0, len(q_tokens), batch):
        sc = tkq_scores(bm25, q_tokens[s:s + batch], q_loc[s:s + batch],
                        obj_loc, **kw)
        out.append(topk_stable(sc, k)[1].cpu().numpy())
    return np.concatenate(out, axis=0)
