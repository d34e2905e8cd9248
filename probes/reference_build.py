#!/usr/bin/env python3
"""The JAX reference's ``repro.api.build`` at the configuration of
``chip_smoke.py``'s phase 6, on a GPU through jax: the comparison for the
port's build. A measurement aid, not part of the port (which imports no
jax).

    PYTHONPATH=src python3 probes/reference_build.py

``list-dual-encoder`` at full width with ``n_clusters`` 300, the
reference's ``api.build`` defaults (relevance 200 steps, batch 64, lr
1.5e-3; index 400 steps, lr 3e-3; spill 3, f32), on
``scale_corpus(GeoCorpusConfig(seed=0), 131_072)``. Prints the first and
last history records of both trainers, the top-1 cluster balance, the
spilled objects, recall@10 of the reference's ``dense`` query at cr 2
and 20 against its ``brute_force``, the build's wall time and the card's
name and power limit, as one JSON line. Exits 2 without a jax GPU
device: on the CPU the full-width build would take hours.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

N_OBJECTS = 131_072
N_CLUSTERS = 300


def main() -> int:
    import jax
    import numpy as np
    if jax.devices()[0].platform != "gpu":
        print(f"reference_build: no jax GPU device ({jax.devices()})",
              file=sys.stderr)
        return 2
    from repro import api
    from repro.configs import get_config
    from repro.core import cluster_metrics as cm
    from repro.data import GeoCorpus, GeoCorpusConfig
    from repro.data.geotextual import scale_corpus
    cfg = dataclasses.replace(get_config("list-dual-encoder"),
                              n_clusters=N_CLUSTERS)
    corpus = GeoCorpus(scale_corpus(GeoCorpusConfig(seed=0), N_OBJECTS))
    t0 = time.perf_counter()
    snap, r = api.build(cfg, corpus, seed=0, log_every=20,
                        return_retriever=True)
    t_build = time.perf_counter() - t0
    rh, ih = r.history["relevance"], r.history["index"]
    assign = np.bincount(np.asarray(r.obj_assign), minlength=N_CLUSTERS)
    _, va, te = corpus.split()
    held = np.concatenate([te, va])[:256]
    bf, _ = r.brute_force(held, k=20, batch=256)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rec = dict(device=str(jax.devices()[0]), card=card, build_s=t_build,
               relevance_first=rh[0], relevance_last=rh[-1],
               index_first=ih[0], index_last=ih[-1],
               top1_largest_over_mean=float(assign.max() / assign.mean()),
               top1_empty=int((assign == 0).sum()),
               n_spilled=int(r.buffers["n_spilled"]), recall_vs_bf={},
               gt_recall_bf=cm.recall_at_k(
                   bf[:len(te)], [corpus.positives[q] for q in te], 10))
    for cr in (2, 20):
        ids, _ = r.query(held, k=20, cr=cr, batch=256)
        rec["recall_vs_bf"][f"cr{cr}"] = float(np.mean(
            [len(set(a[:10]) & set(b[:10])) / 10 for a, b in zip(ids, bf)]))
    print(json.dumps({"reference_build": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
