"""The LIST pipeline (reference: ``repro.core.pipeline``, paper Algorithm
1): train → index → query, on one device.

    r = ListRetriever(cfg, corpus, device="cuda")
    r.train_relevance(steps=...)     # Eq. 8 contrastive, TkQ hard negatives
    r.train_index(steps=...)         # Eq. 13 pseudo-labels + Eq. 14 MCL
    r.build()                        # indexing phase (cluster buffers)
    snap = r.snapshot()              # the artifact api.save writes
    ids, scores = r.query(q_ids, k=..., cr=...)

Models are initialised from ``torch.Generator(seed)`` (``seed + 7`` for the
classifier), which cannot equal ``jax.random``'s streams; every host-side
draw — the training batches, the classifier's batch rows, positives and
negatives, the TkQ top-up — is the reference's numpy draw, so the same
seed gives the same batches. Optimisation is the reference's: AdamW, the
global norm clipped to 1.0, linear warmup over ``steps // 20`` then
cosine. The corpus passes of the towers, the corpus scans of both
minings and the placement run on the device; the towers' passes build no
autograd graph.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.convert import grad_or_zeros
from repro_torch.core import engine as engine_lib
from repro_torch.core import index as index_lib
from repro_torch.core import pseudo_labels, relevance
from repro_torch.core import snapshot as snapshot_lib
from repro_torch.core import spatial as sp
from repro_torch.core.baselines import BM25, tkq_topk
from repro_torch.core.index import topk_stable
from repro_torch.core.relevance import RelevanceModel
from repro_torch.device import full_f32_products, require_device
from repro_torch.optim import (clip_by_global_norm, linear_warmup_cosine,
                               make_optimizer)


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


# ---------------------------------------------------------------------------
# Corpus embedding (offline, batched)
# ---------------------------------------------------------------------------


def embed_objects(rel: RelevanceModel, corpus, *, batch: int = 512
                  ) -> np.ndarray:
    """``(n_objects, d)`` f32 object embeddings of ``corpus``, on the device
    the relevance model lives on."""
    tokens, mask = corpus.object_tokens()
    with torch.no_grad():
        return engine_lib.run_batched(
            lambda t, m: relevance.encode_objects(rel, t, m), [tokens, mask],
            batch=batch, device=_device_of(rel))


def embed_queries(rel: RelevanceModel, corpus, query_ids=None, *,
                  batch: int = 512) -> np.ndarray:
    """``(n, d)`` f32 embeddings of ``corpus``'s queries ``query_ids``
    (all when None)."""
    tokens, mask = corpus.query_tokens(query_ids)
    with torch.no_grad():
        return engine_lib.run_batched(
            lambda t, m: relevance.encode_queries(rel, t, m), [tokens, mask],
            batch=batch, device=_device_of(rel))


# ---------------------------------------------------------------------------
# TkQ hard negatives for relevance training (paper §4.2 Training Strategy)
# ---------------------------------------------------------------------------


def mine_tkq_negatives(corpus, query_ids, *, pool: int = 50,
                       alpha: float = 0.4, device="cuda") -> np.ndarray:
    """``(len(query_ids), pool)`` int64: per query its best ``2·pool``
    objects by TkQ (scored on ``device``), positives dropped, the first
    ``pool`` kept; topped up from ``default_rng(qi)`` as the reference
    does when fewer remain."""
    bm = BM25(corpus.obj_doc, vocab_size=corpus.cfg.vocab_size,
              device=device)
    query_ids = np.asarray(query_ids)
    top = tkq_topk(bm, corpus.q_doc[query_ids], corpus.q_loc[query_ids],
                   corpus.obj_loc, pool * 2, dist_max=corpus.dist_max,
                   alpha=alpha)
    out = np.zeros((len(query_ids), pool), np.int64)
    for i, qi in enumerate(query_ids):
        pos = set(corpus.positives[qi].tolist())
        neg = [o for o in top[i] if o not in pos][:pool]
        while len(neg) < pool:  # top up with randoms
            cand = np.random.default_rng(qi).integers(
                0, corpus.cfg.n_objects, size=pool)
            neg.extend([o for o in cand if o not in pos])
        out[i] = np.array(neg[:pool])
    return out


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------


def batch_to(batch: dict, device) -> dict:
    """A ``GeoCorpus.train_batch`` dict as tensors on ``device``
    (``query_ids`` dropped; ``dist_max`` a float32 0-d tensor)."""
    out = {k: torch.from_numpy(np.asarray(v)).to(device)
           for k, v in batch.items() if k not in ("query_ids", "dist_max")}
    out["dist_max"] = torch.tensor(batch["dist_max"], dtype=torch.float32,
                                   device=device)
    return out


def _step(loss_fn, params, opt_state, opt_update, lr: float) -> dict:
    """One optimisation step: loss and gradients, the global norm clipped
    to 1.0, the optimizer's update; unused parameters get zero gradients.
    The gradients are dropped after the update. Returns the loss's metrics
    plus ``grad_norm`` (device tensors)."""
    loss, metrics = loss_fn()
    loss.backward()
    grads, gnorm = clip_by_global_norm([grad_or_zeros(p) for p in params],
                                       1.0)
    opt_update(grads, opt_state, params, lr)
    for p in params:
        p.grad = None
    return dict(metrics, grad_norm=gnorm)


def relevance_step(rel: RelevanceModel, params, opt_state, opt_update,
                   batch: dict, lr: float, *, spatial_mode: str = "step",
                   weight_mode: str = "mlp") -> dict:
    """One contrastive step (Eq. 8) on a device batch (:func:`batch_to`)."""
    return _step(lambda: relevance.contrastive_loss(
        rel, batch, spatial_mode=spatial_mode, weight_mode=weight_mode),
        params, opt_state, opt_update, lr)


def index_step(index: index_lib.ClusterIndex, params, opt_state, opt_update,
               batch: dict, lr: float) -> dict:
    """One MCL step (Eq. 14) on device features."""
    return _step(lambda: index_lib.mcl_loss(index, batch), params, opt_state,
                 opt_update, lr)


def _record(hist, metrics, step, what, verbose):
    rec = {k: float(v) for k, v in metrics.items()}
    rec["step"] = step
    hist.append(rec)
    if verbose:
        tail = (f"acc={rec['acc']:.3f}" if what == "relevance" else
                f"s_pos={rec['s_pos']:.3f} s_neg={rec['s_neg']:.3f}")
        print(f"  [{what}] step {step}: loss={rec['loss']:.4f} {tail}")


def train_relevance_model(corpus, cfg, *, steps: int = 200, batch: int = 64,
                          lr: float = 3e-4, seed: int = 0,
                          spatial_mode: str = "step",
                          weight_mode: str = "mlp",
                          hard_negatives: bool = True,
                          log_every: int = 50, verbose: bool = False,
                          device="cuda"):
    """Contrastive training (Eq. 8) on ``device``: ``b = cfg.hard_neg_b``
    negatives per query drawn from a pool of 16 TkQ-mined ones (random
    ones without ``hard_negatives``). Returns ``(rel, history)``, a record
    every ``log_every`` steps and at the last."""
    dev = require_device(device)
    rel = relevance.relevance_init(
        cfg, torch.Generator().manual_seed(seed), spatial_mode=spatial_mode,
        weight_mode=weight_mode).to(dev)
    params = list(rel.parameters())
    opt_init, opt_update = make_optimizer(cfg.optimizer)
    opt_state = opt_init(params)
    sched = linear_warmup_cosine(lr, max(steps // 20, 1), steps)
    train_q, _, _ = corpus.split()
    neg_lookup = None
    if hard_negatives:
        neg_lookup = np.zeros((corpus.cfg.n_queries, 16), np.int64)
        neg_lookup[train_q] = mine_tkq_negatives(corpus, train_q, pool=16,
                                                 device=dev)
    hist = []
    for step in range(steps):
        b = batch_to(corpus.train_batch(step, batch, train_q,
                                        hard_negs=neg_lookup,
                                        b_neg=cfg.hard_neg_b), dev)
        m = relevance_step(rel, params, opt_state, opt_update, b,
                           sched(step), spatial_mode=spatial_mode,
                           weight_mode=weight_mode)
        if step % log_every == 0 or step == steps - 1:
            _record(hist, m, step, "relevance", verbose)
    return rel, hist


def draw_index_batch(rng: np.random.Generator, corpus, train_q, *,
                     n_window: int, batch: int, m_negs: int):
    """The classifier's batch draws, in the reference's order: ``rows``
    (indices into ``train_q``), one positive object per row, and ``(batch,
    m_negs)`` columns into the pseudo-negative window."""
    rows = rng.integers(0, len(train_q), size=batch)
    pos_pick = np.array([
        corpus.positives[train_q[r]][
            rng.integers(0, len(corpus.positives[train_q[r]]))]
        for r in rows])
    cols = rng.integers(0, n_window, size=(batch, m_negs))
    return rows, pos_pick, cols


def train_cluster_index(rel: RelevanceModel, corpus, cfg, *, obj_emb=None,
                        steps: int = 300, batch: int = 64, lr: float = 1e-3,
                        seed: int = 0, neg_start: Optional[int] = None,
                        neg_end: Optional[int] = None,
                        m_negs: Optional[int] = None, log_every: int = 100,
                        verbose: bool = False, spatial_mode: str = "step",
                        weight_mode: str = "mlp"):
    """LIST-I training on ``rel``'s device: Eq. 13 pseudo-negatives from the
    window ``[neg_start, neg_end)`` of the relevance model's ranking, then
    Eq. 14 MCL over ``m_negs`` of them per query. Router features live on
    the device. Returns ``(index, norm, obj_emb (numpy), history)``."""
    neg_start = cfg.neg_start if neg_start is None else neg_start
    neg_end = cfg.neg_end if neg_end is None else neg_end
    m_negs = cfg.mcl_negatives if m_negs is None else m_negs
    dev = _device_of(rel)
    if obj_emb is None:
        obj_emb = embed_objects(rel, corpus)
    obj_emb_d = torch.from_numpy(np.asarray(obj_emb, np.float32)).to(dev)
    obj_loc_d = torch.from_numpy(corpus.obj_loc.astype(np.float32)).to(dev)
    norm = index_lib.loc_normalizer(obj_loc_d)

    train_q, _, _ = corpus.split()
    q_emb = torch.from_numpy(embed_queries(rel, corpus, train_q)).to(dev)
    q_loc = torch.from_numpy(corpus.q_loc[train_q].astype(np.float32)).to(dev)

    # --- Eq. 13: mine the pseudo-negative window with the relevance model --
    neg_ids = pseudo_labels.mine_negatives(
        rel, q_emb, q_loc, obj_emb_d, obj_loc_d,
        pos_mask=corpus.positives_mask(train_q), neg_start=neg_start,
        neg_end=neg_end, dist_max=corpus.dist_max, spatial_mode=spatial_mode,
        weight_mode=weight_mode)                          # (Bq, window)

    obj_feats = index_lib.build_features(obj_emb_d, obj_loc_d, norm)
    q_feats = index_lib.build_features(q_emb, q_loc, norm)
    del obj_emb_d

    index = index_lib.index_init(
        obj_emb.shape[1], cfg.n_clusters,
        torch.Generator().manual_seed(seed + 7),
        hidden=cfg.index_mlp_hidden).to(dev)
    params = list(index.parameters())
    opt_init, opt_update = make_optimizer("adamw")
    opt_state = opt_init(params)
    sched = linear_warmup_cosine(lr, max(steps // 20, 1), steps)

    rng = np.random.default_rng(seed)
    hist = []
    for step in range(steps):
        rows, pos_pick, cols = draw_index_batch(
            rng, corpus, train_q, n_window=neg_ids.shape[1], batch=batch,
            m_negs=m_negs)
        rows_d = torch.from_numpy(rows).to(dev)
        neg_pick = neg_ids[rows_d[:, None], torch.from_numpy(cols).to(dev)]
        fb = {"q_feat": q_feats[rows_d],
              "pos_feat": obj_feats[torch.from_numpy(pos_pick).to(dev)],
              "neg_feat": obj_feats[neg_pick.reshape(-1)].reshape(
                  batch, m_negs, -1)}
        m = index_step(index, params, opt_state, opt_update, fb, sched(step))
        if step % log_every == 0 or step == steps - 1:
            _record(hist, m, step, "index", verbose)
    return index, norm, obj_emb, hist


# ---------------------------------------------------------------------------
# The retriever façade
# ---------------------------------------------------------------------------


class ListRetriever:
    """LIST = LIST-R (relevance) + LIST-I (learned cluster index), trained
    and served on ``device`` (default ``"cuda"``; raises without one)."""

    def __init__(self, cfg, corpus, *, spatial_mode: str = "step",
                 weight_mode: str = "mlp", device="cuda"):
        self.cfg = cfg
        self.corpus = corpus
        self.spatial_mode = spatial_mode
        self.weight_mode = weight_mode
        self.device = require_device(device)
        self.rel = None
        self.index = None
        self.norm = None
        self.obj_emb = None
        self.buffers = None
        self.obj_assign = None
        self.history = {}
        self._snapshot = None
        self._snapshot_key = None
        self._snapshot_gen = -1
        self._engine = None

    # --- training phase ---------------------------------------------------

    def train_relevance(self, **kw):
        self.rel, h = train_relevance_model(
            self.corpus, self.cfg, spatial_mode=self.spatial_mode,
            weight_mode=self.weight_mode, device=self.device, **kw)
        self.history["relevance"] = h
        return h

    def train_index(self, **kw):
        if self.rel is None:
            raise RuntimeError("train_relevance first")
        self.index, self.norm, self.obj_emb, h = train_cluster_index(
            self.rel, self.corpus, self.cfg, obj_emb=self.obj_emb,
            spatial_mode=self.spatial_mode, weight_mode=self.weight_mode,
            **kw)
        self.history["index"] = h
        return h

    # --- indexing phase -----------------------------------------------------

    def build(self, *, capacity=None, spill: int = 3,
              precision: str = "f32", attrs=None):
        """Indexing phase on the device: route every object (top-``spill``
        clusters) and pack the padded cluster buffers at ``precision``
        (``index.build_cluster_buffers``); ``attrs (n_objects, 3)`` are the
        filter attributes (None → zeros)."""
        if self.index is None:
            raise RuntimeError("train_index first")
        dev = self.device
        if self.obj_emb is None:
            self.obj_emb = embed_objects(self.rel, self.corpus)
        emb = torch.from_numpy(np.asarray(self.obj_emb, np.float32)).to(dev)
        loc = torch.from_numpy(self.corpus.obj_loc.astype(np.float32)).to(dev)
        feats = index_lib.build_features(emb, loc, self.norm)
        top = index_lib.assign_clusters(self.index, feats, top=max(spill, 1))
        del feats
        if top.ndim == 1:
            top = top[:, None]
        top = top.cpu().numpy()
        if attrs is not None:
            attrs = torch.as_tensor(np.asarray(attrs)).to(dev)
        self.buffers = index_lib.build_cluster_buffers(
            top, emb, loc, n_clusters=self.cfg.n_clusters, capacity=capacity,
            spill=spill, precision=precision, attrs=attrs)
        self.obj_assign = top[:, 0]
        self._engine = None
        return self.buffers

    # --- query phase --------------------------------------------------------

    def snapshot(self) -> "snapshot_lib.IndexSnapshot":
        """The immutable, versioned artifact of the built state, re-derived
        (``meta.version`` bumped) whenever the retriever's models, norm or
        buffers are swapped. Its modules are frozen
        (``IndexSnapshot.from_parts``)."""
        if self.buffers is None:
            raise RuntimeError("build() first")
        key = (id(self.rel), id(self.index), id(self.norm), id(self.buffers))
        if self._snapshot is None or self._snapshot_key != key:
            self._snapshot_gen += 1
            self._snapshot = snapshot_lib.IndexSnapshot.from_parts(
                self.cfg, self.rel, self.index, self.norm, self.buffers,
                dist_max=float(self.corpus.dist_max),
                spatial_mode=self.spatial_mode, weight_mode=self.weight_mode,
                version=self._snapshot_gen)
            self._snapshot_key = key
        return self._snapshot

    def engine(self) -> engine_lib.QueryEngine:
        """An ``auto`` engine over :meth:`snapshot` on the retriever's
        device, rebuilt when the snapshot re-derives."""
        snap = self.snapshot()
        if self._engine is None or self._engine.snapshot is not snap:
            self._engine = engine_lib.QueryEngine(snap, device=self.device)
        return self._engine

    def query(self, query_ids, *, k: int = 20, cr: int = 1,
              backend: Optional[str] = None, batch: int = 256):
        eng = self.engine()
        tokens, mask = self.corpus.query_tokens(query_ids)
        q_loc = self.corpus.q_loc[query_ids].astype(np.float32)
        t0 = time.perf_counter()
        ids, sc = eng.query(tokens, mask, q_loc, k=k, cr=cr, batch=batch,
                            backend=backend)
        self.last_query_seconds = time.perf_counter() - t0
        return ids, sc

    # --- brute force (LIST-R over the whole corpus) -------------------------

    def brute_force(self, query_ids, *, k: int = 20, batch: int = 256):
        """Exhaustive LIST-R scoring of the corpus's objects (the
        retriever's own embeddings) for ``query_ids``, on the retriever's
        device with TF32 off; ties ranked lowest index first. Returns
        ``(ids (n, k) int32, scores (n, k) f32)`` numpy."""
        dev = self.device
        full_f32_products(dev)
        q_emb = embed_queries(self.rel, self.corpus, query_ids, batch=batch)
        q_loc = self.corpus.q_loc[query_ids].astype(np.float32)
        obj_emb = torch.from_numpy(
            np.asarray(self.ensure_embeddings(), np.float32)).to(dev)
        obj_loc = torch.from_numpy(
            self.corpus.obj_loc.astype(np.float32)).to(dev)

        def score_top(qe, ql):
            st = relevance.score_corpus(
                self.rel, qe, ql, obj_emb, obj_loc,
                dist_max=self.corpus.dist_max, spatial_mode=self.spatial_mode,
                weight_mode=self.weight_mode)
            sc, ids = topk_stable(st, k)
            return ids.to(torch.int32), sc

        t0 = time.perf_counter()
        with torch.no_grad():
            ids, sc = engine_lib.run_batched(score_top, [q_emb, q_loc],
                                             batch=batch, device=dev)
        self.last_query_seconds = time.perf_counter() - t0
        return ids, sc

    # --- embedding accessor for baselines -----------------------------------

    def ensure_embeddings(self) -> np.ndarray:
        """The ``(n_objects, d)`` f32 object embeddings, embedded on the
        retriever's device at first use."""
        if self.obj_emb is None:
            self.obj_emb = embed_objects(self.rel, self.corpus)
        return self.obj_emb

    def score_fn(self):
        """The baselines' rerank scorer: ``fn(q_emb_row (d,), q_loc_row
        (2,), cand (m,) object ids) -> (m,) f32 numpy``, through the
        engine's ``score_candidates`` (the serve path's ST: the step
        table's lookup, the query's own mixing weights) on the
        retriever's device with TF32 off."""
        dev = self.device
        full_f32_products(dev)
        obj_emb = torch.from_numpy(
            np.asarray(self.ensure_embeddings(), np.float32)).to(dev)
        obj_loc = torch.from_numpy(
            self.corpus.obj_loc.astype(np.float32)).to(dev)
        w_hat = (sp.extract_lookup(self.rel.spatial["w_s"].data)
                 if self.spatial_mode == "step"
                 else torch.linspace(0, 1, self.cfg.spatial_t, device=dev))
        dist_max = float(self.corpus.dist_max)

        @torch.no_grad()
        def fn(q_emb_row, q_loc_row, cand):
            qe = torch.as_tensor(np.asarray(q_emb_row, np.float32)).to(dev)
            ql = torch.as_tensor(np.asarray(q_loc_row, np.float32)).to(dev)
            ci = torch.as_tensor(np.asarray(cand, np.int64)).to(dev)
            w = relevance.st_weights(self.rel, qe[None],
                                     weight_mode=self.weight_mode)
            st = engine_lib.score_candidates(
                qe[None], ql[None], w, obj_emb[ci], obj_loc[ci],
                ci.to(torch.int32), w_hat, dist_max=dist_max)
            return st[0].cpu().numpy()
        return fn
