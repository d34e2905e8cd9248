"""The paper's baselines (reference: ``repro.core.baselines``, paper §5.1).

* TkQ (``BM25``, ``tkq_scores``, ``tkq_topk``, Eq. 1): BM25 text relevance
  over token ids mixed with linear spatial relevance. It also feeds the
  hard negatives of relevance training (``pipeline.mine_tkq_negatives``).
  Scores are computed on a device in query blocks, with the reference's
  dtypes: each BM25 term's contribution in float64 added into a float32
  score in the reference's term order (ascending ids), the normalised
  text score float32, the spatial part and the mix float64 (the corpus
  locations are float64). Ties are ranked lowest object index first.
* IVF and IVF_S (``IVFIndex``): Lloyd's k-means (:func:`kmeans`) on the
  device over the text embeddings (IVF) or over ``[α·unit embedding,
  (1−α)·normalised location]`` (IVF_S); a query probes its ``cr``
  nearest centroids.
* LSH (``LSHIndex``): random-hyperplane signatures hashed on the device,
  multi-table bucket lookup on the host.
* ``rerank_candidates``: a candidate list per query scored with LIST-R
  (``ListRetriever.score_fn``) and cut to the top ``k``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.index import topk_stable
from repro_torch.device import full_f32_products, require_device


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


# ---------------------------------------------------------------------------
# k-means (Lloyd, on the device): the substrate of IVF / IVF_S
# ---------------------------------------------------------------------------


def kmeans_assign(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """The nearest centroid of each row (lowest index on a tie), squared
    distances by the expansion ``|x|² − 2·x·c + |c|²`` (the reference's)."""
    d = (torch.sum(x * x, 1)[:, None] - 2 * x @ cent.T
         + torch.sum(cent * cent, 1)[None])
    return torch.argmin(d, dim=1)


def kmeans_update(x: torch.Tensor, a: torch.Tensor, cent: torch.Tensor):
    """New centroids from the assignment ``a``: one-hot sums over counts;
    an empty cluster keeps its centroid."""
    oh = torch.nn.functional.one_hot(a, cent.shape[0]).to(x.dtype)  # (N, c)
    sums = oh.T @ x
    cnt = oh.sum(0)[:, None]
    return torch.where(cnt > 0, sums / torch.clamp(cnt, min=1), cent)


def kmeans_step(x: torch.Tensor, cent: torch.Tensor):
    """One Lloyd step (the reference's ``step``): :func:`kmeans_assign`
    then :func:`kmeans_update`. Returns ``(centroids (c, d), assign (N,)
    int64)``."""
    a = kmeans_assign(x, cent)
    return kmeans_update(x, a, cent), a


_U32 = np.uint32


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 block cipher (20 rounds) of ``jax.random``'s
    default generator, in numpy: ``key`` a pair of uint32, ``x1``/``x2``
    the two uint32 count words. Returns the two uint32 output words."""
    k1, k2 = _U32(key[0]), _U32(key[1])
    ks = (k1, k2, _U32(k1 ^ k2 ^ _U32(0x1BD11BDA)))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        a = np.asarray(x1, np.uint32) + ks[0]
        b = np.asarray(x2, np.uint32) + ks[1]
        for i in range(5):
            for r in rotations[i % 2]:
                a = a + b
                b = _rotl32(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def _threefry_bits(key, n: int):
    """``n`` words of ``jax.random``'s partitionable layout: the hash of
    the 64-bit counts ``0..n-1`` (high word 0, low word the count)."""
    return threefry2x32(key, np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))


def kmeans_init_rows(n: int, c: int, *, seed: int = 0) -> np.ndarray:
    """The ``c`` initial rows of :func:`kmeans` out of ``n``: what the
    reference's ``jax.random.choice(PRNGKey(seed), n, (c,),
    replace=False)`` draws, computed without jax.

    That call is ``permutation(key, n)[:c]``: ``ceil(3·ln n / ln(2³²−1))``
    rounds (one up to n = 1,625, two up to ~2.64M), each splitting the key
    and stably sorting the rows by 32 fresh bits (the two Threefry output
    words XORed). ``PRNGKey(seed)`` of a seed in the int32 range is the
    key ``(0, seed mod 2³²)``. → ``(c,)`` int64."""
    if not 0 < c <= n:
        raise ValueError(f"kmeans_init_rows: need 0 < c <= n, got c={c}, "
                         f"n={n}")
    key = (_U32(0), _U32(int(seed) & 0xFFFFFFFF))
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    rows = np.arange(n, dtype=np.int64)
    for _ in range(rounds):
        s1, s2 = _threefry_bits(key, 2)                  # split(key)
        key, sub = (s1[0], s2[0]), (s1[1], s2[1])
        h1, h2 = _threefry_bits(sub, n)
        rows = rows[np.argsort(h1 ^ h2, kind="stable")]
    return rows[:c]


def kmeans(x, n_clusters: int, *, iters: int = 25, seed: int = 0,
           device="cuda"):
    """``x (N, d)`` → ``(centroids (c, d), assign (N,))`` tensors on
    ``device``: ``iters`` steps of :func:`kmeans_step` with f32 products
    in full f32, from the initial rows :func:`kmeans_init_rows` (the
    reference's for one ``seed``)."""
    dev = require_device(device)
    full_f32_products(dev)
    x = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    init = kmeans_init_rows(x.shape[0], n_clusters, seed=seed)
    cent = x[torch.from_numpy(init).to(dev)]
    assign = None
    with torch.no_grad():
        for _ in range(iters):
            cent, assign = kmeans_step(x, cent)
    return cent, assign


class IVFIndex:
    """k-means inverted file over embeddings (+ optional spatial factor),
    clustered and probed on ``device``.

    ``alpha=1.0`` → plain IVF (text embedding only); ``alpha<1.0`` →
    IVF_S: k-means on ``[α·L2norm(emb), (1−α)·loc_hat]``, the features
    built on the host as the reference builds them."""

    def __init__(self, emb, loc=None, *, n_clusters: int, alpha: float = 1.0,
                 iters: int = 25, seed: int = 0, device="cuda"):
        self.device = require_device(device)
        emb = np.asarray(emb, np.float32)
        self.alpha = alpha
        if alpha >= 1.0 or loc is None:
            feats = emb
            self._loc_stats = None
        else:
            e = emb / np.maximum(
                np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
            lo, hi = loc.min(0), loc.max(0)
            lh = (loc - lo) / np.maximum(hi - lo, 1e-9)
            feats = np.concatenate([alpha * e, (1 - alpha) * lh], axis=1)
            self._loc_stats = (lo, hi)
        cent, assign = kmeans(feats, n_clusters, iters=iters, seed=seed,
                              device=self.device)
        self._cent = cent
        self.centroids = cent.cpu().numpy()
        self.assign = assign.cpu().numpy()
        self.n_clusters = n_clusters
        order = np.argsort(self.assign, kind="stable")
        bounds = np.searchsorted(self.assign[order], np.arange(n_clusters + 1))
        self.lists = [order[bounds[c]:bounds[c + 1]]
                      for c in range(n_clusters)]

    def _query_feats(self, q_emb, q_loc):
        q_emb = np.asarray(q_emb, np.float32)
        if self._loc_stats is None:
            return q_emb
        lo, hi = self._loc_stats
        e = q_emb / np.maximum(
            np.linalg.norm(q_emb, axis=1, keepdims=True), 1e-9)
        lh = (np.asarray(q_loc) - lo) / np.maximum(hi - lo, 1e-9)
        return np.concatenate([self.alpha * e, (1 - self.alpha) * lh], axis=1)

    def probe(self, q_emb, q_loc=None, *, cr: int = 1) -> np.ndarray:
        """``(B, cr)`` int64 nearest centroid ids (L2), ranked on the
        device (nearest first, lowest id on a tie)."""
        f = torch.from_numpy(np.asarray(self._query_feats(q_emb, q_loc),
                                        np.float32)).to(self.device)
        c = self._cent
        with torch.no_grad():
            d = (torch.sum(f * f, 1)[:, None] - 2 * f @ c.T
                 + torch.sum(c * c, 1)[None])
            order = torch.sort(d, dim=1, stable=True).indices[:, :cr]
        return order.cpu().numpy()

    def candidates(self, q_emb, q_loc=None, *, cr: int = 1):
        """A list of per-query candidate id arrays: the probed clusters'
        members, cluster by cluster."""
        probes = self.probe(q_emb, q_loc, cr=cr)
        return [np.concatenate([self.lists[c] for c in row]) if len(row)
                else np.empty(0, np.int64) for row in probes]


class LSHIndex:
    """Random-hyperplane LSH with ``n_tables`` tables of ``nbits``-bit
    signatures. The planes are the reference's numpy draw, so a seed gives
    the same planes; signatures are hashed on ``device`` (f32 products in
    full f32), the bucket tables live on the host."""

    def __init__(self, emb, *, nbits: int = 16, n_tables: int = 4,
                 seed: int = 0, device="cuda"):
        self.device = require_device(device)
        full_f32_products(self.device)
        emb = np.asarray(emb, np.float32)
        rng = np.random.default_rng(seed)
        d = emb.shape[1]
        self.planes = rng.normal(size=(n_tables, nbits, d)).astype(np.float32)
        self._planes = torch.from_numpy(self.planes).to(self.device)
        self.n_tables = n_tables
        self.nbits = nbits
        self.codes = self._hash(emb)                 # (T, N)
        self.tables = []
        for t in range(n_tables):
            order = np.argsort(self.codes[t], kind="stable")
            keys, starts = np.unique(self.codes[t][order], return_index=True)
            ends = np.append(starts[1:], order.size)
            self.tables.append({int(k): order[s:e].astype(np.int64)
                                for k, s, e in zip(keys, starts, ends)})

    def _hash(self, x) -> np.ndarray:
        """``x (N, d)`` → ``(T, N)`` int64 codes: bit ``b`` of table ``t``
        set where ``planes[t, b] · x > 0``."""
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
        weights = 1 << torch.arange(self.nbits, device=self.device)
        with torch.no_grad():
            sig = torch.einsum("tbd,nd->tnb", self._planes, xt) > 0
            return (sig.to(torch.int64) * weights).sum(-1).cpu().numpy()

    def candidates(self, q_emb):
        """A list of per-query candidate id arrays: the union of the
        query's buckets over the tables, ascending."""
        codes = self._hash(np.asarray(q_emb, np.float32))   # (T, B)
        outs = []
        for i in range(codes.shape[1]):
            cand = [self.tables[t].get(int(codes[t, i]), np.empty(0, np.int64))
                    for t in range(self.n_tables)]
            outs.append(np.unique(np.concatenate(cand))
                        if cand else np.empty(0, np.int64))
        return outs


# ---------------------------------------------------------------------------
# Shared rerank: score candidate lists with LIST-R, return top-k
# ---------------------------------------------------------------------------


def rerank_candidates(score_fn, cand_lists, k: int):
    """``score_fn(q_idx, cand_ids) -> scores``; returns the ``(B, k)``
    padded id matrix (-1 pad) and the mean candidate count (the
    efficiency proxy). Host code, the reference's own."""
    out = np.full((len(cand_lists), k), -1, np.int64)
    n_scored = 0
    for i, cand in enumerate(cand_lists):
        if len(cand) == 0:
            continue
        n_scored += len(cand)
        s = np.asarray(score_fn(i, cand))
        order = np.argsort(-s)[:k]
        out[i, :len(order)] = cand[order]
    return out, n_scored / max(len(cand_lists), 1)
