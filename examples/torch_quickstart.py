"""Quickstart on the PyTorch/CUDA port (the twin of ``quickstart.py``):
train LIST end to end on a small synthetic city, freeze the built index
into a durable ``IndexSnapshot`` artifact, reload it, and answer spatial
keyword queries. Runs on the CUDA device; ``--device cpu`` runs it on
the CPU.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.core import cluster_metrics as cm
from repro_torch.data.geotextual import GeoCorpus, GeoCorpusConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--objects", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=400)
    ap.add_argument("--rel-steps", type=int, default=200)
    ap.add_argument("--idx-steps", type=int, default=400)
    args = ap.parse_args(argv)

    # 1. a city: POIs with latent topics + spatial hotspots, and a click
    #    log of queries (the paper's Beijing/Shanghai analogue)
    corpus = GeoCorpus(GeoCorpusConfig(
        n_objects=args.objects, n_queries=args.queries, n_topics=12,
        vocab_size=4096, seed=0))

    # 2. LIST = dual-encoder relevance model + learned cluster index;
    #    api.build runs Eq. 8 contrastive training, Eq. 13/14 index
    #    training, and packs the cluster buffers on the device
    cfg = dataclasses.replace(
        get_config("list-dual-encoder"),
        n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=4096,
        max_len=16, spatial_t=100, n_clusters=8,
        neg_start=args.objects // 2, neg_end=args.objects // 2 + 200,
        index_mlp_hidden=(64,))
    snap = api.build(cfg, corpus, rel_steps=args.rel_steps,
                     idx_steps=args.idx_steps, rel_lr=1.5e-3, idx_lr=3e-3,
                     verbose=True, log_every=100, device=args.device)
    print("cluster sizes:", snap.buffers["counts"].tolist())

    # 3. the built index is an immutable artifact: save → load round-trips
    #    to bit-identical results (the reference loads it too)
    art_dir = tempfile.mkdtemp(prefix="list_snapshot_")
    path = api.save(snap, art_dir)
    snap = api.load(art_dir, device=args.device)
    print(f"snapshot v{snap.meta.version} ({snap.meta.n_objects} objects, "
          f"cfg digest {snap.meta.cfg_digest}) round-tripped via {path}")

    # 4. answer the held-out queries from the LOADED artifact
    searcher = api.Searcher(snap, device=args.device)
    tr, va, te = corpus.split()
    positives = [corpus.positives[q] for q in te]
    ids, scores = searcher.query_corpus(corpus, te, k=10, cr=1)
    bf_ids, _ = api.brute_force(snap, corpus, te, k=10)
    cap = snap.buffers["capacity"]
    print(f"\nLIST        recall@10 = {cm.recall_at_k(ids, positives, 10):.3f}"
          f"  (scans ≤{cap} of {corpus.cfg.n_objects} objects)")
    print(f"brute force recall@10 = "
          f"{cm.recall_at_k(bf_ids, positives, 10):.3f}"
          f"  (scans all {corpus.cfg.n_objects})")

    # 5. one concrete query, end to end
    q = te[0]
    print(f"\nquery {q}: keywords={corpus.q_doc[q].tolist()} "
          f"loc={np.round(corpus.q_loc[q], 3).tolist()}")
    print(f"  top-5 objects: {ids[0][:5].tolist()}")
    print(f"  ground truth : {corpus.positives[q][:5].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
