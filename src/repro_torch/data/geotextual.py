"""Synthetic geo-textual corpus + query-log generator with latent ground truth
(the port's copy of ``repro.data.geotextual``: numpy only, the same arrays
for the same seed, the training batches included).

The paper's datasets (Beijing/Shanghai/Geo-Glue click logs) are proprietary;
we generate a corpus with a *planted* relevance structure so every paper
claim is checkable:

- ``n_topics`` latent topics (e.g. "italian restaurant"). Each topic owns two
  DISJOINT synonym vocabularies: an *object* vocabulary (used in POI
  descriptions, e.g. "pasta house trattoria") and a *query* vocabulary
  ("italian restaurant"). A tunable ``mismatch`` fraction of queries draws
  keywords ONLY from the query vocabulary — those pairs have zero word
  overlap, reproducing the word-mismatch phenomenon of paper Fig. 1a that
  breaks BM25 but not embeddings.

- Object locations are drawn from a mixture of spatial hotspots (cities have
  dense centers); queries are issued near a *seed object* with displacement
  following a truncated exponential — the sharp near-distance CDF of paper
  Fig. 1b that motivates the step-function spatial model.

- Ground-truth positives of a query = objects sharing its topic within a
  relevance radius of the seed (click-through proxy).

Everything is produced by a stateless, seed-deterministic numpy generator so
data loading is preemption-safe (re-seed from step) and identical across
hosts.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class GeoCorpusConfig:
    n_objects: int = 20_000
    n_queries: int = 2_000
    n_topics: int = 50
    words_per_topic: int = 12      # per synonym side
    doc_len: int = 8               # words in an object description
    query_len: int = 3             # words in query keywords
    max_len: int = 16              # token budget (incl. CLS)
    vocab_size: int = 32_768       # hashing-tokenizer space
    n_hotspots: int = 8
    hotspot_sigma: float = 0.05    # spatial spread of a hotspot
    query_dist_scale: float = 0.02  # exp displacement of query from seed
    relevance_radius: float = 0.08  # ground-truth radius
    mismatch: float = 0.35         # fraction of queries with zero overlap
    noise_words: int = 2           # background words mixed into docs
    seed: int = 0

    @property
    def cls_token(self) -> int:
        return 1                    # 0 = pad, 1 = CLS


class GeoCorpus:
    """Holds the full synthetic corpus (objects, queries, ground truth)."""

    def __init__(self, cfg: GeoCorpusConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, T, W = cfg.vocab_size, cfg.n_topics, cfg.words_per_topic

        # --- topic vocabularies: object-side and query-side, disjoint ---
        # reserve [0, 2) for pad/CLS; hash words into the rest
        words = rng.choice(np.arange(2, V), size=(T, 2 * W), replace=False)
        self.obj_vocab = words[:, :W]          # (T, W)
        self.qry_vocab = words[:, W:]          # (T, W)
        self.bg_vocab = rng.choice(np.arange(2, V), size=4 * W, replace=False)

        # --- spatial hotspots ---
        self.hotspots = rng.uniform(0.1, 0.9, size=(cfg.n_hotspots, 2))

        # --- objects ---
        n = cfg.n_objects
        self.obj_topic = rng.integers(0, T, size=n)
        hs = rng.integers(0, cfg.n_hotspots, size=n)
        self.obj_loc = (self.hotspots[hs]
                        + rng.normal(0, cfg.hotspot_sigma, size=(n, 2)))
        self.obj_loc = np.clip(self.obj_loc, 0.0, 1.0)
        # description: mostly object-side topic words + a few query-side +
        # background noise (so embeddings must learn the topic structure)
        docs = np.zeros((n, cfg.doc_len), np.int64)
        for j in range(cfg.doc_len):
            r = rng.random(n)
            w_obj = self.obj_vocab[self.obj_topic,
                                   rng.integers(0, W, size=n)]
            w_qry = self.qry_vocab[self.obj_topic,
                                   rng.integers(0, W, size=n)]
            w_bg = self.bg_vocab[rng.integers(0, len(self.bg_vocab), size=n)]
            docs[:, j] = np.where(r < 0.55, w_obj,
                                  np.where(r < 0.75, w_qry, w_bg))
        self.obj_doc = docs

        # --- queries ---
        m = cfg.n_queries
        seed_obj = rng.integers(0, n, size=m)
        self.query_seed = seed_obj
        self.q_topic = self.obj_topic[seed_obj]
        disp = rng.exponential(cfg.query_dist_scale, size=m)
        disp = np.minimum(disp, 0.3)
        ang = rng.uniform(0, 2 * np.pi, size=m)
        self.q_loc = self.obj_loc[seed_obj] + \
            disp[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
        self.q_loc = np.clip(self.q_loc, 0.0, 1.0)
        mism = rng.random(m) < cfg.mismatch
        self.q_mismatch = mism
        qdocs = np.zeros((m, cfg.query_len), np.int64)
        for j in range(cfg.query_len):
            w_q = self.qry_vocab[self.q_topic, rng.integers(0, W, size=m)]
            w_o = self.obj_vocab[self.q_topic, rng.integers(0, W, size=m)]
            r = rng.random(m)
            # mismatched queries use ONLY query-side words; others mix
            qdocs[:, j] = np.where(mism | (r < 0.5), w_q, w_o)
        self.q_doc = qdocs

        # --- ground truth: same topic && within relevance radius of seed ---
        self.positives: List[np.ndarray] = []
        topic_objs = [np.nonzero(self.obj_topic == t)[0] for t in range(T)]
        for i in range(m):
            cand = topic_objs[self.q_topic[i]]
            d = np.linalg.norm(self.obj_loc[cand] - self.q_loc[i][None], axis=1)
            pos = cand[d < cfg.relevance_radius]
            if pos.size == 0:
                pos = np.array([seed_obj[i]])
            self.positives.append(pos.astype(np.int64))

        self.dist_max = float(np.sqrt(2.0))

    # --- tokenization into fixed (max_len) windows with CLS ---------------

    def _tokens(self, docs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        b, l = docs.shape
        L = self.cfg.max_len
        out = np.zeros((b, L), np.int32)
        out[:, 0] = self.cfg.cls_token
        take = min(l, L - 1)
        out[:, 1:1 + take] = docs[:, :take]
        mask = out != 0
        return out, mask

    def object_tokens(self, ids=None):
        docs = self.obj_doc if ids is None else self.obj_doc[ids]
        return self._tokens(docs)

    def query_tokens(self, ids=None):
        docs = self.q_doc if ids is None else self.q_doc[ids]
        return self._tokens(docs)

    # --- splits ------------------------------------------------------------

    def split(self, val_frac=0.1, test_frac=0.1):
        m = self.cfg.n_queries
        rng = np.random.default_rng(self.cfg.seed + 1)
        perm = rng.permutation(m)
        n_test = int(m * test_frac)
        n_val = int(m * val_frac)
        return (perm[n_test + n_val:], perm[n_test:n_test + n_val],
                perm[:n_test])

    # --- contrastive training batches (Eq. 8) ------------------------------

    def train_batch(self, step: int, batch: int, query_ids: np.ndarray,
                    hard_negs: Optional[np.ndarray] = None, b_neg: int = 4):
        """Stateless batch: seeded by step. hard_negs: (n_queries, H) pool of
        TkQ-mined negatives per query (see core/pipeline.mine_tkq_negatives);
        falls back to random negatives when absent."""
        rng = np.random.default_rng(self.cfg.seed * 1_000_003 + step)
        qi = query_ids[rng.integers(0, len(query_ids), size=batch)]
        pos = np.array([self.positives[i][rng.integers(0, len(self.positives[i]))]
                        for i in qi])
        if hard_negs is not None:
            hsel = hard_negs[qi]
            neg = hsel[np.arange(batch)[:, None],
                       rng.integers(0, hsel.shape[1], size=(batch, b_neg))]
        else:
            neg = rng.integers(0, self.cfg.n_objects, size=(batch, b_neg))
        qt, qm = self.query_tokens(qi)
        pt, pm = self.object_tokens(pos)
        nt, nm = self.object_tokens(neg.reshape(-1))
        L = self.cfg.max_len
        return {
            "q_tokens": qt, "q_mask": qm,
            "q_loc": self.q_loc[qi].astype(np.float32),
            "pos_tokens": pt, "pos_mask": pm,
            "pos_loc": self.obj_loc[pos].astype(np.float32),
            "neg_tokens": nt.reshape(batch, b_neg, L),
            "neg_mask": nm.reshape(batch, b_neg, L),
            "neg_loc": self.obj_loc[neg.reshape(-1)].reshape(
                batch, b_neg, 2).astype(np.float32),
            "dist_max": self.dist_max,
            "query_ids": qi,
        }

    def positives_mask(self, query_ids) -> np.ndarray:
        """(B, N) bool mask of ground-truth positives (Eq. 13 filter)."""
        out = np.zeros((len(query_ids), self.cfg.n_objects), bool)
        for r, qi in enumerate(query_ids):
            out[r, self.positives[qi]] = True
        return out


def scale_corpus(cfg: GeoCorpusConfig, n_objects: int) -> GeoCorpusConfig:
    """Scalability-study helper (paper Fig. 7): same generator, more POIs."""
    return dataclasses.replace(cfg, n_objects=n_objects)
