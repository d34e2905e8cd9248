"""Serve spatial-keyword requests through a trained LIST index on the
PyTorch/CUDA port (the twin of ``serve_queries.py``) — all three serving
layers, all fed by ONE immutable ``IndexSnapshot`` (``repro_torch.api``):

  * streaming server (core/server.py): async micro-batcher + result
    caches + warm-up over the engine — the long-lived path
  * engine path (one-shot): route → score → top-k
  * dispatch path: clusters-as-experts dispatch (core/serving.py; on the
    card the cluster-major CUDA kernel), compared with the engine path

    PYTHONPATH=src python examples/torch_serve_queries.py [--backend cuda]
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.core import cluster_metrics as cm
from repro_torch.core import server as server_lib
from repro_torch.core import serving
from repro_torch.core.engine import resolve_cli_backend
from repro_torch.data.geotextual import GeoCorpus, GeoCorpusConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--use-pallas", action="store_true",
                    help="DEPRECATED alias for --backend cuda "
                         "(warns and forwards)")
    ap.add_argument("--backend", default=None,
                    choices=["cuda", "cuda-cm", "dense", "dense-cm", "auto"],
                    help="engine backend: cuda = the routed CUDA kernel, "
                         "*-cm = cluster-major batched execution, dense = "
                         "the plain PyTorch version (CPU), auto = by device "
                         "+ per-batch dedup (core/engine.py)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--objects", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=400)
    ap.add_argument("--rel-steps", type=int, default=200)
    ap.add_argument("--idx-steps", type=int, default=400)
    args = ap.parse_args(argv)
    backend = resolve_cli_backend(args.backend, args.use_pallas)

    corpus = GeoCorpus(GeoCorpusConfig(
        n_objects=args.objects, n_queries=args.queries, n_topics=12,
        vocab_size=4096, seed=0))
    cfg = dataclasses.replace(
        get_config("list-dual-encoder"),
        n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=4096,
        max_len=16, spatial_t=100, n_clusters=8,
        neg_start=args.objects // 2, neg_end=args.objects // 2 + 200,
        index_mlp_hidden=(64,))
    print("training retriever ...")
    snap = api.build(cfg, corpus, rel_steps=args.rel_steps,
                     idx_steps=args.idx_steps, rel_lr=1.5e-3, idx_lr=3e-3,
                     log_every=10**9, device=args.device)
    searcher = api.Searcher(snap, device=args.device)

    tr, va, te = corpus.split()
    req = te[: args.requests]
    positives = [corpus.positives[q] for q in req]
    tok, msk = corpus.query_tokens(req)
    loc = corpus.q_loc[req].astype(np.float32)

    # streaming server: micro-batched requests over the engine, pre-warmed.
    # batch_size matches the direct engine call below: the bit-identity
    # guarantee holds per batch shape
    server = searcher.serve(server_lib.ServerConfig(
        batch_size=64, max_delay_ms=2.0, k=args.k, cr=1, backend=backend))
    server.warmup()
    t0 = time.time()
    ids_s, sc_s = server.serve_all(tok, msk, loc)
    ids_s, sc_s = server.serve_all(tok, msk, loc)   # replay: cache hits
    t_s = time.time() - t0
    m = server.metrics(wall_seconds=t_s)
    print(f"streaming server ({backend}): "
          f"recall@{args.k}={cm.recall_at_k(ids_s, positives, args.k):.3f} "
          f"{t_s:.2f}s for {m['requests']} requests "
          f"(hit_rate={m['hit_rate']:.1%}, "
          f"p95={m['latency_ms']['p95']:.1f}ms, "
          f"{m['engine_batches']} engine batches)")

    # engine path, one-shot
    t0 = time.time()
    ids_g, sc_g = searcher.query(tok, msk, loc, k=args.k, cr=1,
                                 backend=backend, batch=64)
    t_g = time.time() - t0
    print(f"engine path ({backend}): "
          f"recall@{args.k}={cm.recall_at_k(ids_g, positives, args.k):.3f} "
          f"{t_g:.2f}s for {len(req)} requests")
    assert (np.sort(ids_s, 1) == np.sort(ids_g, 1)).all(), \
        "streaming server and direct engine path disagree"
    print("streaming server and engine path agree")

    # dispatch path (the multi-chip serving layout, run on one device) —
    # same snapshot, same score_candidates scoring surface
    t0 = time.time()
    ids_d, sc_d, n_dropped = serving.cluster_dispatch_query(
        searcher.snapshot, tok, msk, loc, k=args.k, cr=1,
        return_dropped=True)
    ids_d = ids_d.cpu().numpy()
    t_d = time.time() - t0
    print(f"dispatch path (clusters-as-experts): "
          f"recall@{args.k}={cm.recall_at_k(ids_d, positives, args.k):.3f} "
          f"{t_d:.2f}s  dropped={int(n_dropped)} (query, route) pairs")

    agree = (ids_d == ids_g).mean()
    print(f"paths agree on {agree:.1%} of returned ids "
          f"({int(n_dropped)} capacity drops account for the rest)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
