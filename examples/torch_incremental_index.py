"""Insertion and deletion through the delta write path on the
PyTorch/CUDA port (the twin of ``incremental_index.py``; paper §4.3
"Insertion and Deletion Policy"): new POIs stream in and become visible
to queries the instant the successor ``IndexSnapshot`` is published to
the live server — in O(batch), because writes append to the snapshot's
small delta segment instead of rebuilding the (c, cap) cluster buffers.
Deletes tombstone. Compaction later folds the delta into its §4.3
clusters (here forced via ``compact_now``). Each write derives version
N+1 and swaps it atomically, so traffic is never served a torn index.

    PYTHONPATH=src python examples/torch_incremental_index.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.core import pipeline as pl
from repro_torch.core import server as server_lib
from repro_torch.data.geotextual import GeoCorpus, GeoCorpusConfig

NEW_ID_BASE = 10_000


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--objects", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=400)
    ap.add_argument("--rel-steps", type=int, default=200)
    ap.add_argument("--idx-steps", type=int, default=400)
    args = ap.parse_args(argv)

    corpus = GeoCorpus(GeoCorpusConfig(
        n_objects=args.objects, n_queries=args.queries, n_topics=12,
        vocab_size=4096, seed=0))
    cfg = dataclasses.replace(
        get_config("list-dual-encoder"),
        n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=4096,
        max_len=16, spatial_t=100, n_clusters=8,
        neg_start=args.objects // 2, neg_end=args.objects // 2 + 200,
        index_mlp_hidden=(64,))
    snap = api.build(cfg, corpus, rel_steps=args.rel_steps,
                     idx_steps=args.idx_steps, rel_lr=1.5e-3, idx_lr=3e-3,
                     log_every=10**9, device=args.device)
    print(f"snapshot v{snap.meta.version}: cluster sizes "
          f"{snap.buffers['counts'].tolist()}")

    # a live server over the snapshot (micro-batcher + result caches);
    # the high delta_threshold keeps compaction manual for this demo
    server = api.Searcher(snap, device=args.device).serve(
        server_lib.ServerConfig(batch_size=32, max_delay_ms=2.0, k=20,
                                cr=cfg.n_clusters, delta_threshold=4096))

    # probe workload: the held-out queries of a NEW downtown district
    new_city = GeoCorpus(GeoCorpusConfig(
        n_objects=200, n_queries=40, n_topics=12, vocab_size=4096, seed=9))
    probe_ids = np.arange(new_city.cfg.n_queries)
    tok, msk = new_city.query_tokens(probe_ids)
    loc = new_city.q_loc[probe_ids].astype(np.float32)

    ids_before, _ = server.serve_all(tok, msk, loc)
    assert not (ids_before >= NEW_ID_BASE).any()     # nothing to see yet

    # --- the new district's POIs open: embed, append, PUBLISH -------------
    new_emb = pl.embed_objects(snap.rel, new_city)
    new_loc = new_city.obj_loc.astype(np.float32)
    new_ids = np.arange(NEW_ID_BASE, NEW_ID_BASE + new_city.cfg.n_objects)
    snap2 = server.insert_objects(new_emb, new_loc, new_ids)
    assert snap2.meta.version == snap.meta.version + 1
    assert server.engine.snapshot is snap2           # atomically published
    assert snap2.meta.delta_rows == new_city.cfg.n_objects
    print(f"published v{snap2.meta.version}: {snap2.meta.delta_rows} rows "
          f"pending in the delta segment (base untouched: "
          f"{snap2.buffers['counts'].tolist()}; O(batch) "
          f"write, no routing, no retraining)")

    # --- post-insert queries MUST see the new objects ----------------------
    ids_after, _ = server.serve_all(tok, msk, loc)
    n_new_hits = int((ids_after >= NEW_ID_BASE).sum())
    assert n_new_hits > 0, "published objects not visible to queries"
    print(f"post-publish: {n_new_hits} of the new district's POIs surface "
          f"in the probe queries' top-20 (cache invalidated: "
          f"{server.stats.invalidations} publishes)")
    # the original snapshot object is untouched — immutable artifacts
    assert not (snap.buffers["ids"].cpu().numpy() >= NEW_ID_BASE).any()
    assert snap.delta is None

    # --- some POIs close: delete, same publish protocol --------------------
    victims = [int(i) for i in np.unique(ids_after[ids_after >= NEW_ID_BASE])
               ][:50]
    snap3 = server.delete_objects(victims)
    ids_del, _ = server.serve_all(tok, msk, loc)
    assert not np.isin(ids_del, victims).any()       # victims gone
    print(f"published v{snap3.meta.version}: {len(victims)} deletions "
          f"(delta-resident rows dropped; {snap3.meta.n_tombstones} "
          f"tombstones)")

    # --- compaction: fold the delta into its §4.3 clusters -----------------
    snap4 = server.compact_now()
    assert snap4.delta is None and snap4.meta.delta_rows == 0
    base_ids = snap4.buffers["ids"].cpu().numpy()
    assert (base_ids >= NEW_ID_BASE).sum() == len(new_ids) - len(victims)
    ids_comp, _ = server.serve_all(tok, msk, loc)
    assert np.array_equal(ids_comp, ids_del)         # queries unchanged
    print(f"compacted -> v{snap4.meta.version}: cluster sizes "
          f"{snap4.buffers['counts'].tolist()} "
          f"(results bit-identical across the fold)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
