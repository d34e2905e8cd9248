"""LIST serving driver over the ``repro_torch.api`` facade (reference:
``repro.launch.serve``, its flags, defaults and report): build (or load)
an immutable ``IndexSnapshot``, then run a long-lived streaming server
(core/server.py) and replay a skewed query workload against it —
open-loop (fixed arrival rate) or closed-loop (fixed concurrency) load
generation. Everything runs on the CUDA device unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --objects 4000 \
        --queries 600 --train-steps 200 --index-steps 400 --serve-batch 64 \
        --mode closed --concurrency 64 --requests 1200 --skew 1.05

``--snapshot-dir DIR`` makes the artifact durable: the first run trains,
builds, and ``api.save``s; later runs ``api.load`` the committed
snapshot and skip training entirely (bit-identical serving, per
tests/test_snapshot.py); the snapshot directory of either package's
command line loads in the other's (the model config, and so
``cfg_digest``, is the same). ``--precision {f32,bf16,int8}`` picks the
resident-buffer storage tier (DESIGN.md §9): int8 quantizes the scanned
embeddings ~4× smaller with in-kernel dequant; a loaded artifact must
already be at the requested tier. ``--backend`` takes the port's names
(``cuda``, ``cuda-cm``, ``dense``, ``dense-cm``, ``auto``);
``--use-pallas`` is the deprecated alias of ``cuda``. ``--mesh N``
shards the loaded or built snapshot's cluster buffers N ways
(``IndexSnapshot.with_mesh``): across the first N cards with ``--device
cuda`` (more than the host has raises), into N logical parts with
``--device cpu``.

Reports two layers of metrics:

* quality (one-shot, as before): Recall@k / NDCG@k vs brute force,
  candidates scanned (the 1/c search-space reduction), P(C) / IF(C);
* serving (streamed): p50/p95/p99 latency, achieved QPS, cache hit
  rates per tier, micro-batch fill, flush-reason counts, and per-shape
  warm-up compile seconds.

``--churn N`` additionally applies N insert+delete batches through the
server's O(batch) delta write path (DESIGN.md §11) before streaming;
``--delta-threshold`` / ``--max-imbalance`` control when the background
compaction folds the delta into the base (0 threshold = legacy eager
O(index) writes).
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.core import cluster_metrics as cm
from repro_torch.core import index as index_lib
from repro_torch.core import pipeline as pl
from repro_torch.core import server as server_lib
from repro_torch.core.engine import resolve_cli_backend
from repro_torch.core.snapshot import cfg_digest
from repro_torch.data.geotextual import GeoCorpus, GeoCorpusConfig
from repro_torch.device import require_device


# ---------------------------------------------------------------------------
# Workload construction (load-gen loops live next to the server:
# server_lib.open_loop / server_lib.closed_loop)
# ---------------------------------------------------------------------------


def build_workload(corpus, query_ids, n_requests: int, *, skew: float,
                   seed: int):
    """Zipf-skewed replay of the test split: (request list, query ids)."""
    rng = np.random.default_rng(seed + 13)
    picks = query_ids[server_lib.zipf_sample(rng, len(query_ids), n_requests,
                                             a=skew)]
    tok, msk = corpus.query_tokens(picks)
    loc = corpus.q_loc[picks].astype(np.float32)
    return [(tok[i], msk[i], loc[i]) for i in range(n_requests)], picks


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=4000)
    ap.add_argument("--queries", type=int, default=600)
    ap.add_argument("--topics", type=int, default=16)
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--index-steps", type=int, default=600)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--cr", type=int, default=1)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--use-pallas", action="store_true",
                    help="DEPRECATED alias for --backend cuda "
                         "(warns and forwards)")
    ap.add_argument("--backend", default=None,
                    choices=["cuda", "cuda-cm", "dense", "dense-cm",
                             "auto"],
                    help="engine backend: cuda / cuda-cm the CUDA kernels "
                         "(on --device cuda), dense / dense-cm their "
                         "plain versions (on --device cpu); *-cm forces "
                         "cluster-major batched execution (each distinct "
                         "routed cluster streamed once per micro-batch); "
                         "auto picks query- vs cluster-major per batch "
                         "from the measured route dedup factor")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where everything runs (the reference's "
                         "JAX_PLATFORMS); cuda raises without a card")
    ap.add_argument("--precision", default=None,
                    choices=list(index_lib.PRECISIONS),
                    help="resident-buffer storage tier (DESIGN.md §9): "
                         "int8 streams ~4x fewer HBM bytes in the scan "
                         "kernel; default f32 on build, the artifact's "
                         "own tier on --snapshot-dir load")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="shard the resident cluster buffers across N "
                         "devices (the first N cards; N logical parts "
                         "with --device cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snapshot-dir", default=None,
                    help="durable IndexSnapshot artifact dir: load it when "
                         "a committed snapshot exists, else train + save")
    # --- streaming-server knobs ---
    ap.add_argument("--serve-batch", type=int, default=64,
                    help="micro-batch size (the static jitted batch shape)")
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="deadline flush: max queueing delay per request")
    ap.add_argument("--cache-size", type=int, default=8192)
    ap.add_argument("--near-cells", type=int, default=0,
                    help="near-duplicate cache grid (0 = exact tier only)")
    ap.add_argument("--delta-threshold", type=int, default=1024,
                    help="LSM write path (DESIGN.md §11): compact the "
                         "delta segment into the base once it holds this "
                         "many rows+tombstones; 0 = eager O(index) writes")
    ap.add_argument("--max-imbalance", type=float, default=0.0,
                    help="also compact when the live cluster sizes' "
                         "imbalance factor exceeds this (0 = off)")
    ap.add_argument("--spill", type=int, default=3,
                    help="insert routing spill hops (paper §4.3)")
    ap.add_argument("--churn", type=int, default=0,
                    help="write batches applied through the server before "
                         "streaming: each inserts 32 synthetic objects "
                         "and deletes 16 live ones through the O(batch) "
                         "delta path (recall is then measured against "
                         "the surviving positives)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip pre-tracing (the first query run — here the "
                         "quality snapshot — then pays the compile)")
    # --- resilience knobs (DESIGN.md §14) ---
    ap.add_argument("--wal-dir", default=None,
                    help="write-ahead log directory: every insert/delete "
                         "batch is durably logged before its publish; on "
                         "startup intact records newer than the loaded "
                         "snapshot are replayed (crash recovery). Pair "
                         "with --snapshot-dir")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="admission bound: shed (Overloaded) submits "
                         "arriving with this many already queued; 0 = "
                         "unbounded")
    ap.add_argument("--timeout-ms", type=float, default=0.0,
                    help="per-request deadline: requests still queued past "
                         "it are shed (DeadlineExceeded) instead of riding "
                         "a late batch; 0 = no deadlines")
    # --- load generation ---
    ap.add_argument("--mode", default="closed", choices=["open", "closed"])
    ap.add_argument("--requests", type=int, default=1200,
                    help="total requests replayed against the server")
    ap.add_argument("--qps", type=float, default=500.0,
                    help="open-loop arrival rate")
    ap.add_argument("--concurrency", type=int, default=64,
                    help="closed-loop outstanding requests")
    ap.add_argument("--skew", type=float, default=1.05,
                    help="Zipf exponent of the query workload (0 = uniform)")
    args = ap.parse_args(argv)
    backend = resolve_cli_backend(args.backend, args.use_pallas)
    dev = require_device(args.device)

    cfg = dataclasses.replace(
        get_config("list-dual-encoder"),
        n_layers=4, d_model=64, n_heads=4, d_ff=128, vocab_size=4096,
        max_len=16, spatial_t=100, n_clusters=args.clusters,
        neg_start=args.objects // 2, neg_end=args.objects // 2 + 200,
        index_mlp_hidden=(128,))
    corpus = GeoCorpus(GeoCorpusConfig(
        n_objects=args.objects, n_queries=args.queries,
        n_topics=args.topics, vocab_size=4096, seed=args.seed))

    # --- the artifact: load a committed snapshot, or build + save one ----
    r = None
    if (args.snapshot_dir
            and ckpt_lib.latest_step(args.snapshot_dir) is not None):
        t0 = time.perf_counter()
        snap = api.load(args.snapshot_dir, device=dev)
        # the artifact must match what the CLI args describe, or every
        # quality number below (recall vs THIS corpus's ground truth)
        # would be silently meaningless
        if snap.meta.cfg_digest != cfg_digest(cfg):
            raise SystemExit(
                f"--snapshot-dir {args.snapshot_dir}: artifact was built "
                f"for a different model config (digest "
                f"{snap.meta.cfg_digest} != {cfg_digest(cfg)}); rerun "
                f"with the original --objects/--clusters/... flags or "
                f"point at a fresh directory to retrain")
        if args.precision and snap.meta.precision != args.precision:
            raise SystemExit(
                f"--snapshot-dir {args.snapshot_dir}: artifact is "
                f"precision={snap.meta.precision!r} but --precision "
                f"{args.precision} was requested; re-build, or requantize "
                f"an f32 artifact via IndexSnapshot.with_precision")
        print(f"== loaded snapshot v{snap.meta.version} "
              f"({snap.meta.n_objects} objects, {snap.meta.precision}) "
              f"from {args.snapshot_dir} "
              f"in {time.perf_counter() - t0:.2f}s — skipping training ==")
    else:
        print("== training (Eq. 8 relevance + Eq. 13/14 index) ==")
        snap, r = api.build(
            cfg, corpus, rel_steps=args.train_steps,
            idx_steps=args.index_steps, batch=64, rel_lr=1e-3, idx_lr=3e-3,
            precision=args.precision or "f32", seed=args.seed, verbose=True,
            log_every=max(args.train_steps // 3, 1), return_retriever=True,
            device=dev)
        if args.snapshot_dir:
            path = api.save(snap, args.snapshot_dir)
            print(f"== saved snapshot v{snap.meta.version} -> {path} ==")
    if args.mesh:
        snap = snap.with_mesh(args.mesh)
        per_dev = snap.shards.nbytes_per_device()
        print(f"== mesh: cluster buffers sharded across "
              f"{snap.meta.n_shards} devices, "
              f"{max(per_dev) / 1e6:.2f} MB/device resident ==")
    buf = snap.buffers
    counts = buf["counts"].cpu().numpy()
    print(f"== index: clusters={counts.tolist()} "
          f"spilled={buf['n_spilled']} precision={snap.meta.precision} ==")

    tr, va, te = corpus.split()
    positives = [corpus.positives[q] for q in te]

    # --- the streaming server (DESIGN.md §7) ------------------------------
    # built and warmed BEFORE any other query runs: the quality snapshot
    # below uses the same (k, cr, backend, batch) plan, so warming later
    # would measure a hot cache and report bogus compile seconds
    searcher = api.Searcher(snap, device=dev)
    server = searcher.serve(server_lib.ServerConfig(
        batch_size=args.serve_batch, max_delay_ms=args.max_delay_ms,
        k=args.k, cr=args.cr, backend=backend,
        cache_size=args.cache_size, near_cells=args.near_cells,
        delta_threshold=args.delta_threshold,
        max_imbalance=args.max_imbalance, spill=args.spill,
        wal_dir=args.wal_dir, max_queue=args.max_queue,
        request_timeout_ms=args.timeout_ms))
    if args.wal_dir and server.wal.n_records:
        # crash recovery (DESIGN.md §14): the log outlived a previous
        # process — re-apply every intact record the loaded snapshot
        # doesn't already contain, before serving a single request
        applied = server.replay_wal()
        print(f"== recovery: replayed {applied} WAL record(s) "
              f"(torn tail dropped: {server.wal.dropped_tail}) -> "
              f"serving v{server.engine.snapshot.meta.version} ==")
    if not args.no_warmup:
        compiles = server.warmup()
        print("== warm-up: pre-traced "
              + ", ".join(f"{k} in {v:.2f}s" for k, v in compiles.items())
              + " ==")

    # --- quality snapshot (one-shot, vs brute force) ----------------------
    t0 = time.perf_counter()
    bf_ids, _ = api.brute_force(snap, corpus, te, k=args.k,
                                batch=args.serve_batch)
    t_bf = time.perf_counter() - t0
    ids, _ = searcher.query_corpus(corpus, te, k=args.k, cr=args.cr,
                                   backend=backend, batch=args.serve_batch)
    cap = buf["capacity"]
    scanned = args.cr * cap
    print(f"\n== quality over {len(te)} held-out queries ==")
    print(f"brute force : recall@{args.k}="
          f"{cm.recall_at_k(bf_ids, positives, args.k):.4f} "
          f"ndcg@5={cm.ndcg_at_k(bf_ids, positives, 5):.4f} "
          f"({t_bf:.2f}s, scans {args.objects} objects/query)")
    print(f"LIST cr={args.cr}  : recall@{args.k}="
          f"{cm.recall_at_k(ids, positives, args.k):.4f} "
          f"ndcg@5={cm.ndcg_at_k(ids, positives, 5):.4f} "
          f"(scans ≤{scanned} objects/query = "
          f"{scanned / args.objects:.1%} of corpus)")

    if r is not None:       # obj_assign is training-time state, not artifact
        q_emb = pl.embed_queries(snap.rel, corpus, te)
        qf = index_lib.build_features(
            torch.from_numpy(q_emb).to(dev),
            torch.from_numpy(corpus.q_loc[te].astype(np.float32)).to(dev),
            snap.norm)
        qa = index_lib.assign_clusters(snap.index, qf).cpu().numpy()
        pc, _ = cm.cluster_precision(qa, positives, r.obj_assign,
                                     cfg.n_clusters)
        print(f"cluster quality: P(C)={pc:.4f} "
              f"IF(C)={cm.imbalance_factor(r.obj_assign, cfg.n_clusters):.3f}")

    # --- churn: exercise the O(batch) write path before streaming ---------
    deleted: set = set()
    if args.churn:
        wrng = np.random.default_rng(args.seed + 99)
        next_id = 10_000_000
        t0 = time.perf_counter()
        for _ in range(args.churn):
            ne = wrng.normal(size=(32, cfg.d_model)).astype(np.float32)
            nl = wrng.uniform(size=(32, 2)).astype(np.float32)
            server.insert_objects(ne, nl, np.arange(next_id, next_id + 32))
            next_id += 32
            victims = [int(v) for v in wrng.choice(args.objects, size=16,
                                                   replace=False)
                       if v not in deleted]
            server.delete_objects(np.asarray(victims, np.int64))
            deleted.update(victims)
        t_w = time.perf_counter() - t0
        wm = server.metrics()
        print(f"== churn: {args.churn} write rounds in {t_w:.2f}s "
              f"(delta_rows={wm['delta_rows']} "
              f"tombstones={wm['tombstones']} "
              f"compactions={wm['compactions']}) ==")

    # --- streamed load against the pre-built server -----------------------
    requests, picks = build_workload(corpus, te, args.requests,
                                     skew=args.skew, seed=args.seed)
    print(f"== streaming {args.requests} requests "
          f"({len(set(picks.tolist()))} unique, zipf a={args.skew}) "
          f"mode={args.mode} ==")
    shedding = args.max_queue > 0 or args.timeout_ms > 0
    t0 = time.perf_counter()
    if args.mode == "open":
        results = asyncio.run(
            server_lib.open_loop(server, requests, qps=args.qps,
                                 shed_ok=shedding))
    else:
        results = asyncio.run(
            server_lib.closed_loop(server, requests,
                                   concurrency=args.concurrency))
    wall = time.perf_counter() - t0

    m = server.metrics(wall_seconds=wall)
    lat = m["latency_ms"]
    served = [(res, q) for res, q in zip(results, picks) if res is not None]
    served_ids = (np.stack([res[0] for res, _ in served])
                  if served else np.zeros((0, args.k), np.int64))
    served_pos = [np.asarray([p for p in corpus.positives[q]
                              if int(p) not in deleted])
                  for _, q in served]
    print(f"served QPS  : {m['qps']:.1f} ({wall:.2f}s wall)")
    print(f"latency ms  : p50={lat['p50']:.2f} p95={lat['p95']:.2f} "
          f"p99={lat['p99']:.2f} mean={lat['mean']:.2f}")
    print(f"cache       : hit_rate={m['hit_rate']:.1%} "
          f"(exact={m['exact_hit_rate']:.1%} near={m['near_hit_rate']:.1%} "
          f"coalesced={m['coalesced']})")
    print(f"cache hits  : exact={m['exact_hits']} near={m['near_hits']} "
          f"of {m['requests']} requests")
    print(f"micro-batch : {m['engine_batches']} engine batches, "
          f"fill={m['batch_fill']:.1%}, flushes={m['flushes']}")
    if m["writes"]:
        print(f"write path  : writes={m['writes']} "
              f"delta_rows={m['delta_rows']} "
              f"tombstones={m['tombstones']} "
              f"compactions={m['compactions']} "
              f"triggers={m['compaction_triggers']}")
    if m.get("dedup_factor"):
        print(f"route dedup : {m['dedup_factor']:.1f}x "
              f"(B*cr / distinct clusters — the cluster-major win)")
    # resilience summary (DESIGN.md §14)
    shed_total = sum(m["shed"].values())
    if shed_total or shedding:
        print(f"shed        : {shed_total} of {len(requests)} offered "
              f"({m['shed']}) — served {len(served)}")
    if m["flush_retries"] or m["poisoned_requests"]:
        print(f"degradation : flush_retries={m['flush_retries']} "
              f"poisoned_requests={m['poisoned_requests']}")
    if m["breaker"]["trips"]:
        print(f"breaker     : trips={m['breaker']['trips']} "
              f"fallback_flushes={m['breaker']['fallback_flushes']} "
              f"open={m['breaker']['open']}")
    if m["slow_flushes"]:
        print(f"slow flushes: {m['slow_flushes']} "
              f"(last at {m['last_slow_flush_at']:.0f} unix s)")
    if m["wal"]["enabled"]:
        print(f"wal         : {m['wal']['records']} record(s), "
              f"{m['wal']['bytes'] / 1e3:.1f} kB "
              f"(appends={m['wal']['appends']} "
              f"recovered={m['recovered_writes']})")
    if len(served):
        print(f"recall@{args.k} under serving: "
              f"{cm.recall_at_k(served_ids, served_pos, args.k):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
