#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``). Phases:

0. Print the card's name and power limit; build the scan kernels from
   ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a) and print the build time.
1. Hold each kernel (routed, cluster-major) against its plain PyTorch
   version on the card: f32 / bf16 / int8 × unfiltered / filtered × cr 1, 2,
   at a small shape and at d = 768, at k = 20 and k > 32.
2. Serve a small snapshot built in memory from a seed through
   ``repro_torch.api.Searcher`` on the ``cuda``, ``cuda-cm`` and ``auto``
   backends (one snapshot with a delta segment), against the ``dense``
   backend on a CPU copy.
3. Full width: ``list-dual-encoder`` (12L / 768 / 12H / 3072, bf16 compute)
   with seeded random weights, 2,849,754 objects in c = 300 buffers at f32
   and int8, 4,096 queries through ``Searcher.query`` (batch 256, k 20,
   cr 2). The kernels' launch counters are read around this run; the first
   queries are checked against the plain versions; each kernel is timed
   against its plain version and its bound.

Prints one JSON line of per-kernel numbers, then as its last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0

# published H100 SXM peaks (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # CUDA cores: the kernels run f32 FMAs

# kernel vs plain: f32 sums in another order over d ≤ 768 terms
ATOL, RTOL = 1e-4, 1e-5


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def topk_match(ids, scores, want_ids, want_scores):
    """→ max |score error|; raises unless ids agree up to ties (a swap of
    near-equal scores, or another pick among entries tied with the k-th)."""
    import numpy as np
    ids, want_ids = np.asarray(ids), np.asarray(want_ids)
    scores = np.asarray(scores, np.float64)
    want_scores = np.asarray(want_scores, np.float64)
    err = np.abs(scores - want_scores)
    tol = ATOL + RTOL * np.abs(want_scores)
    if (err > tol).any():
        i = np.unravel_index(np.argmax(err - tol), err.shape)
        raise AssertionError(f"score error {err[i]} > tol {tol[i]} at {i}")
    for q in range(ids.shape[0]):
        for p in np.flatnonzero(ids[q] != want_ids[q]):
            same = np.flatnonzero(want_ids[q] == ids[q, p])
            tied = np.abs(want_scores[q] - want_scores[q, p]) <= 2 * tol[q, p]
            edge = abs(scores[q, p] - want_scores[q, -1]) <= 2 * tol[q, -1]
            if not ((same.size and tied[same].any()) or edge):
                raise AssertionError(
                    f"row {q} pos {p}: id {ids[q, p]} vs {want_ids[q, p]} "
                    f"(scores {scores[q, p]} / {want_scores[q, p]}) no tie")
    return float(err.max()) if err.size else 0.0


def time_ms(fn, reps=5, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------


def random_case(g, dev, *, c, cap, d, b, cr, precision, t=1000, pad=0.3):
    """Random buffers (with padding rows), queries and routes on ``dev``."""
    import torch
    from repro_torch.core import index as index_lib
    emb = torch.randn(c, cap, d, generator=g, device=dev)
    emb = torch.nn.functional.normalize(emb, dim=-1)
    ids = torch.randperm(c * cap, generator=g, device=dev).reshape(c, cap)
    ids = torch.where(torch.rand(c, cap, generator=g, device=dev) < pad,
                      torch.full_like(ids, -1), ids).to(torch.int32)
    emb = torch.where(ids[..., None] >= 0, emb, torch.zeros((), device=dev))
    st, scale = index_lib.quantize_rows(emb, precision)
    attrs = torch.stack([
        torch.randint(0, 3, (c, cap), generator=g, device=dev),
        torch.randint(0, 16, (c, cap), generator=g, device=dev),
        torch.randint(0, 1000, (c, cap), generator=g, device=dev)],
        dim=-1).to(torch.int32)
    q = torch.randn(b, d, generator=g, device=dev) * 0.5
    q_loc = torch.rand(b, 2, generator=g, device=dev)
    w = torch.rand(b, 2, generator=g, device=dev) + 0.2
    top_c = torch.stack([torch.randperm(c, generator=g, device=dev)[:cr]
                         for _ in range(b)]).to(torch.int32)
    w_hat = torch.cumsum(torch.rand(t, generator=g, device=dev) * 0.2, 0)
    f = torch.tensor([[-1, 0, -2 ** 31, 2 ** 31 - 1], [1, 0, -2 ** 31, 2 ** 31 - 1],
                      [-1, 0b0101, -2 ** 31, 2 ** 31 - 1], [-1, 0, 200, 700],
                      [0, 0b0011, 100, 2 ** 31 - 1]], dtype=torch.int32,
                     device=dev)
    q_filt = f[torch.arange(b, device=dev) % f.shape[0]].contiguous()
    return dict(q=q, q_loc=q_loc, w=w, top_c=top_c, emb=st, loc=torch.rand(
        c, cap, 2, generator=g, device=dev), ids=ids,
        scale=scale if precision == "int8" else None, attrs=attrs,
        q_filt=q_filt, w_hat=w_hat)


def check_kernels(case, *, k, filtered, dist_max=1.4142):
    """Both kernels vs their plain versions on one case → max errors."""
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import serving as serving_lib
    from repro_torch.kernels import fused_topk_score as fts
    kw = dict(k=k, dist_max=dist_max, buf_scale=case["scale"],
              buf_attrs=case["attrs"] if filtered else None,
              q_filt=case["q_filt"] if filtered else None)
    args = (case["q"], case["q_loc"], case["w"], case["top_c"], case["emb"],
            case["loc"], case["ids"], case["w_hat"])
    want = fts.routed_topk_plain(*args, **kw)
    got = fts.fused_topk_score_routed(*args, **kw)
    e_r = topk_match(got[1].cpu(), got[0].cpu(), want[1].cpu(),
                     want[0].cpu())
    b, cr = case["top_c"].shape
    u, roster, _ = serving_lib.cluster_major_plan(
        case["top_c"], n_clusters=case["emb"].shape[0])
    cm_args = (case["q"], case["q_loc"], case["w"], u, roster, case["emb"],
               case["loc"], case["ids"], case["w_hat"])
    want_p = fts.cluster_major_partials_plain(*cm_args, cr=cr, **kw)
    got_p = fts.fused_topk_score_cluster_major(*cm_args, cr=cr, **kw)
    e_p = topk_match(got_p[1].cpu(), got_p[0].cpu(), want_p[1].cpu(),
                     want_p[0].cpu())
    got_m = engine_lib.merge_cluster_major(*got_p, b=b, cr=cr, k=k)
    e_m = topk_match(got_m[1].cpu(), got_m[0].cpu(), want[1].cpu(),
                     want[0].cpu())
    return e_r, max(e_p, e_m)


def phase1(dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    err = {"routed": 0.0, "cluster_major": 0.0}
    cases = []
    for precision in ("f32", "bf16", "int8"):
        for filtered in (False, True):
            for cr in (1, 2):
                cases.append(dict(precision=precision, filtered=filtered,
                                  cr=cr, c=16, cap=640, d=128, b=64, k=20))
    for precision in ("f32", "bf16", "int8"):
        cases.append(dict(precision=precision, filtered=precision == "int8",
                          cr=2, c=8, cap=256, d=768, b=16, k=20))
    cases += [dict(precision="f32", filtered=False, cr=2, c=16, cap=640,
                   d=128, b=64, k=52),
              dict(precision="int8", filtered=True, cr=2, c=8, cap=256,
                   d=768, b=16, k=84),
              dict(precision="bf16", filtered=True, cr=1, c=4, cap=64, d=32,
                   b=8, k=60)]
    for cs in cases:
        case = random_case(g, dev, c=cs["c"], cap=cs["cap"], d=cs["d"],
                           b=cs["b"], cr=cs["cr"], precision=cs["precision"])
        e_r, e_c = check_kernels(case, k=cs["k"], filtered=cs["filtered"])
        torch.cuda.synchronize()
        err["routed"] = max(err["routed"], e_r)
        err["cluster_major"] = max(err["cluster_major"], e_c)
        log(f"phase 1 ok: {cs} max|err| routed {e_r:.3g} cm {e_c:.3g}")
    log(f"phase 1 ok: max |kernel - plain| {err} (tol {ATOL} + {RTOL}·|s|)")
    return err


# ---------------------------------------------------------------------------
# Phase 2: Searcher on a small in-memory snapshot
# ---------------------------------------------------------------------------


def small_snapshot(dev, precision, *, with_delta=False):
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import delta as delta_lib
    from repro_torch.core import index as index_lib
    from repro_torch.core.snapshot import IndexSnapshot
    cfg = dataclasses.replace(
        get_config("list-dual-encoder"), n_layers=2, d_model=128, n_heads=4,
        d_ff=256, vocab_size=4096, max_len=16, spatial_t=100, n_clusters=12,
        index_mlp_hidden=(64,), compute_dtype="float32")
    g = torch.Generator().manual_seed(SEED + 2)
    rel_p, idx_p = convert.random_params(cfg, n_clusters=12, generator=g,
                                         with_o_enc=False)
    rel, index = convert.params_from_numpy(rel_p, idx_p, cfg)
    n = 3000
    emb = torch.nn.functional.normalize(torch.randn(n, 128, generator=g), dim=-1)
    loc = torch.rand(n, 2, generator=g)
    attrs = torch.stack([torch.randint(0, 3, (n,), generator=g),
                         torch.randint(0, 16, (n,), generator=g),
                         torch.randint(0, 1000, (n,), generator=g)], -1)
    norm = index_lib.loc_normalizer(loc)
    top = index_lib.topk_stable(index(index_lib.build_features(emb, loc, norm)),
                                3)[1]
    buf = index_lib.build_cluster_buffers(top.numpy(), emb, loc, n_clusters=12,
                                          precision=precision,
                                          attrs=attrs.to(torch.int32))
    delta = None
    if with_delta:
        m = 40
        raw = torch.nn.functional.normalize(torch.randn(m, 128, generator=g), dim=-1)
        stored, scale = index_lib.quantize_rows(raw, precision)
        delta = delta_lib.DeltaSegment.from_leaves(128, precision, {
            "emb": stored, "scale": scale, "loc": torch.rand(m, 2, generator=g),
            "ids": torch.arange(n, n + m, dtype=torch.int32), "raw": raw,
            "attrs": torch.zeros(m, 3, dtype=torch.int32),
            "tombstones": torch.arange(0, 3 * 25, 3)})
    snap = IndexSnapshot.from_parts(cfg, rel, index, norm, buf,
                                    dist_max=1.4142, delta=delta)
    return snap


def phase2(dev):
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import filters as filters_lib
    from repro_torch.core import index as index_lib
    rng = np.random.default_rng(SEED + 3)
    n_q, k, cr = 200, 20, 2
    tok = rng.integers(1, 4096, (n_q, 16)).astype(np.int32)
    msk = np.ones((n_q, 16), bool)
    msk[:, 10:] = rng.uniform(size=(n_q, 6)) < 0.5
    tok[~msk] = 0
    loc = rng.uniform(size=(n_q, 2)).astype(np.float32)
    specs = [None, filters_lib.FilterSpec(tenant=1),
             filters_lib.FilterSpec(category_mask=0b0101)]
    filters = [specs[i % 3] for i in range(n_q)]
    picks = {}
    for name, precision, with_delta in (("f32", "f32", False),
                                        ("bf16", "bf16", False),
                                        ("int8", "int8", False),
                                        ("int8-delta", "int8", True)):
        snap = small_snapshot(dev, precision, with_delta=with_delta)
        cpu = api.Searcher(snap, backend="dense", device="cpu")
        s_gpu = {b: api.Searcher(snap, backend=b, device=dev)
                 for b in ("cuda", "cuda-cm", "auto")}
        # rows whose routes agree on both devices (f32 compute: all but
        # near-ties of the router's softmax)
        r_cpu = cpu.engine.route(tok, msk, loc, cr=cr).numpy()
        r_gpu = s_gpu["cuda"].engine.route(tok, msk, loc, cr=cr).cpu().numpy()
        same = (r_cpu == r_gpu).all(axis=1)
        if same.mean() < 0.95:
            raise AssertionError(f"phase 2 {name}: routes agree on only "
                                 f"{same.mean():.3f} of rows")
        for filt in (None, filters):
            want = cpu.query(tok, msk, loc, k=k, cr=cr, batch=64,
                             filters=filt)
            for b, s in s_gpu.items():
                got = s.query(tok, msk, loc, k=k, cr=cr, batch=64,
                              filters=filt)
                topk_match(got[0][same], got[1][same], want[0][same],
                           want[1][same])
                pick = s.engine.pick_backend(tok, msk, loc, cr=cr,
                                             batch=64) if b == "auto" else b
                picks[(name, b)] = pick
                log(f"phase 2 ok: {name} {b} -> {pick} "
                    f"filtered={filt is not None} rows={int(same.sum())}")
        del snap, cpu, s_gpu
    torch.cuda.empty_cache()
    return picks


# ---------------------------------------------------------------------------
# Phase 3: full width
# ---------------------------------------------------------------------------


def int8_from_f32(buf, chunk=16):
    """The int8 tier of f32 buffers (ids, loc, attrs shared)."""
    import torch
    from repro_torch.core import index as index_lib
    c, cap, d = buf["emb"].shape
    emb = torch.empty((c, cap, d), dtype=torch.int8, device=buf["emb"].device)
    scale = torch.empty((c, cap), dtype=torch.float32, device=emb.device)
    for s in range(0, c, chunk):
        emb[s:s + chunk], scale[s:s + chunk] = index_lib.quantize_rows(
            buf["emb"][s:s + chunk], "int8")
    return dict(buf, emb=emb, scale=scale, precision="int8")


def bound(ids_buf, top_c, u, *, d, elem_bytes, k, b, dequant):
    """Least time for the scan on this run's routes: every input byte read
    once (queries; ids of the distinct routed clusters; emb, loc and
    scales of their live rows), outputs written once; 2·d flops per (query,
    live row) pair, plus d per live row for the int8 dequant (once per
    row, not per pair), at the f32 peak."""
    import torch
    live = (ids_buf[u.long()] >= 0).sum(dim=1)                 # per cluster
    live_rows = int(live.sum())
    pairs = int((ids_buf[top_c.long()] >= 0).sum())
    row_bytes = d * elem_bytes + 8 + (4 if dequant else 0)
    nbytes = (b * (d * 4 + 16) + int(u.numel()) * ids_buf.shape[1] * 4
              + live_rows * row_bytes + b * k * 8)
    flops = pairs * d * 2 + (live_rows * d if dequant else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, live_rows=live_rows,
                pairs_scored=pairs)


def phase3(dev):
    import numpy as np
    import torch
    from repro_torch import api, convert
    from repro_torch.configs import SERVE_QUERIES, get_config
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import index as index_lib
    from repro_torch.core import serving as serving_lib
    from repro_torch.core.snapshot import IndexSnapshot
    from repro_torch.kernels import fused_topk_score as fts

    n, c = SERVE_QUERIES["n_objects"], SERVE_QUERIES["n_clusters"]
    n_q, k, cr, batch = SERVE_QUERIES["query_batch"], SERVE_QUERIES["topk"], 2, 256
    cfg = dataclasses.replace(get_config("list-dual-encoder"), n_clusters=c)
    d = cfg.d_model
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED + 4)
    rel_p, idx_p = convert.random_params(cfg, n_clusters=c, generator=g,
                                         with_o_enc=False)
    rel, index = convert.params_from_numpy(rel_p, idx_p, cfg)
    rel, index = rel.to(dev), index.to(dev)
    del rel_p, idx_p
    log(f"phase 3: list-dual-encoder weights ({cfg.n_layers}L/{d}/"
        f"{cfg.n_heads}H/{cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.compute_dtype} compute) from seed {SEED + 4} in "
        f"{time.perf_counter() - t0:.1f} s")
    log("phase 3: object embeddings are seeded random unit rows, not "
        "encoded (corpus encoding is the build path, a later slice)")
    t0 = time.perf_counter()
    gd = torch.Generator(device=dev).manual_seed(SEED + 5)
    emb = torch.empty((n, d), device=dev)
    step = 1 << 18
    for s in range(0, n, step):
        e = min(s + step, n)
        emb[s:e] = torch.nn.functional.normalize(
            torch.randn(e - s, d, generator=gd, device=dev), dim=-1)
    loc = torch.rand(n, 2, generator=gd, device=dev)
    norm = index_lib.loc_normalizer(loc)
    assign = torch.empty((n, 3), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for s in range(0, n, step):
            e = min(s + step, n)
            feats = index_lib.build_features(emb[s:e], loc[s:e], norm)
            assign[s:e] = index_lib.topk_stable(
                index_lib.cluster_logits(index, feats), 3)[1].to(torch.int32)
    torch.cuda.synchronize()
    t_route = time.perf_counter() - t0
    t0 = time.perf_counter()
    buf32 = index_lib.build_cluster_buffers(assign.cpu().numpy(), emb, loc,
                                            n_clusters=c, spill=3)
    del emb, assign
    buf8 = int8_from_f32(buf32)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    cap = buf32["capacity"]
    gb = lambda x: x.numel() * x.element_size() / 1e9  # noqa: E731
    log(f"phase 3: {n} objects in ({c}, {cap}) buffers, f32 "
        f"{gb(buf32['emb']):.2f} GB + int8 {gb(buf8['emb']):.2f} GB; routed "
        f"on the card in {t_route:.1f} s, placed (spill 3, "
        f"{buf32['n_spilled']} spilled) in {t_build:.1f} s")
    snaps = {p: IndexSnapshot.from_parts(cfg, rel, index, norm, b,
                                         dist_max=1.4142)
             for p, b in (("f32", buf32), ("int8", buf8))}

    rng = np.random.default_rng(SEED + 6)
    tok = rng.integers(1, cfg.vocab_size, (n_q, cfg.max_len)).astype(np.int32)
    msk = np.ones((n_q, cfg.max_len), bool)
    lens = rng.integers(8, cfg.max_len + 1, n_q)
    msk[np.arange(cfg.max_len)[None, :] >= lens[:, None]] = False
    tok[~msk] = 0
    q_loc = rng.uniform(size=(n_q, 2)).astype(np.float32)

    # ---- the main path: Searcher.query, counters read around it ----------
    searchers = {(p, b): api.Searcher(s, backend=b, device=dev)
                 for p, s in snaps.items() for b in ("cuda", "auto")}
    for s in searchers.values():                       # warm the allocator
        s.query(tok[:batch], msk[:batch], q_loc[:batch], k=k, cr=cr,
                batch=batch)
    torch.cuda.synchronize()
    fts.reset_launch_counts()
    results, walls = {}, {}
    for key, s in searchers.items():
        t0 = time.perf_counter()
        results[key] = s.query(tok, msk, q_loc, k=k, cr=cr, batch=batch)
        walls[key] = time.perf_counter() - t0
    main_launches = dict(fts.launches)
    picks = {f"{p}/{b}": (s.engine.pick_backend(tok, msk, q_loc, cr=cr,
                                                batch=batch)
                          if b == "auto" else b)
             for (p, b), s in searchers.items()}
    log(f"phase 3 main path: {n_q} queries × {len(searchers)} searchers; "
        f"launches {main_launches}; picks {picks}")
    for key, (ids, sc) in results.items():
        if ids.shape != (n_q, k) or not np.isfinite(sc).all():
            raise AssertionError(f"phase 3 {key}: bad output {ids.shape}")
        if not (ids >= 0).all():
            raise AssertionError(f"phase 3 {key}: fewer than k results")
        log(f"phase 3 {key[0]} {key[1]}: {n_q} queries in "
            f"{walls[key] * 1e3:.1f} ms ({n_q / walls[key]:.0f} q/s), "
            f"backend {picks['/'.join(key)]}")
    for name in ("routed", "cluster_major"):
        if main_launches[name] == 0:
            raise AssertionError(f"kernel {name} not launched on the main path")

    # ---- per-kernel checks and timings on the first chunk ----------------
    prefix = engine_lib.make_prefix_fn(cr=cr)
    chunk = [torch.from_numpy(a[:batch]).to(dev) for a in (tok, msk, q_loc)]
    t_prefix = time_ms(lambda: prefix(rel, index, norm, *chunk))
    q_emb, w, top_c = prefix(rel, index, norm, *chunk)
    ql = chunk[2]
    u, roster, n_distinct = serving_lib.cluster_major_plan(top_c,
                                                            n_clusters=c)
    n_distinct = int(n_distinct)
    loads = torch.bincount(top_c.reshape(-1).long(), minlength=c)
    loads = sorted(loads[loads > 0].tolist(), reverse=True)
    log(f"phase 3 routing (first chunk): {batch * cr} (query, route) pairs "
        f"over U={n_distinct} distinct clusters; pairs per cluster {loads}")
    report = {}
    n_check = 32
    for p, buf in (("f32", buf32), ("int8", buf8)):
        snap = snaps[p]
        w_hat = snap.w_hat
        scale = buf["scale"] if p == "int8" else None
        args = (q_emb, ql, w, top_c, buf["emb"], buf["loc"], buf["ids"], w_hat)
        kw = dict(k=k, dist_max=1.4142, buf_scale=scale)
        # the searchers' answers for the first queries vs the plain version
        want = fts.routed_topk_plain(*(a[:n_check] if i < 4 else a
                                       for i, a in enumerate(args)), **kw)
        err = 0.0
        for b_name in ("cuda", "auto"):
            ids, sc = results[(p, b_name)]
            err = max(err, topk_match(ids[:n_check], sc[:n_check],
                                      want[1].cpu(), want[0].cpu()))
        log(f"phase 3 {p}: first {n_check} queries match the plain "
            f"version (max |err| {err:.3g})")
        r_ms = time_ms(lambda: fts.fused_topk_score_routed(*args, **kw))
        cm_ms = time_ms(lambda: fts.fused_topk_score_cluster_major(
            q_emb, ql, w, u, roster, buf["emb"], buf["loc"], buf["ids"],
            w_hat, cr=cr, **kw))
        cm_path_ms = time_ms(lambda: engine_lib._routed_topk(
            q_emb, ql, w, top_c, buf, w_hat, k=k, backend="cuda-cm",
            dist_max=1.4142, precision=p))
        sub = 32

        def plain_routed():
            for s in range(0, batch, sub):
                fts.routed_topk_plain(*(a[s:s + sub] if i < 4 else a
                                        for i, a in enumerate(args)), **kw)

        def plain_cm():
            for s in range(0, batch, sub):
                u_s, r_s, _ = serving_lib.cluster_major_plan(
                    top_c[s:s + sub], n_clusters=c)
                fts.cluster_major_partials_plain(
                    q_emb[s:s + sub], ql[s:s + sub], w[s:s + sub], u_s, r_s,
                    buf["emb"], buf["loc"], buf["ids"], w_hat, cr=cr, **kw)

        r_plain = time_ms(plain_routed, reps=1, warmup=1)
        cm_plain = time_ms(plain_cm, reps=1, warmup=1)
        # full-chunk parity of both kernels against the plain routed scan
        got_r = fts.fused_topk_score_routed(*args, **kw)
        ps, pi = fts.fused_topk_score_cluster_major(
            q_emb, ql, w, u, roster, buf["emb"], buf["loc"], buf["ids"],
            w_hat, cr=cr, **kw)
        got_c = engine_lib.merge_cluster_major(ps, pi, b=batch, cr=cr, k=k)
        want_all = [], []
        for s in range(0, batch, sub):
            ws, wi = fts.routed_topk_plain(*(a[s:s + sub] if i < 4 else a
                                             for i, a in enumerate(args)), **kw)
            want_all[0].append(ws)
            want_all[1].append(wi)
        ws, wi = torch.cat(want_all[0]).cpu(), torch.cat(want_all[1]).cpu()
        e_r = topk_match(got_r[1].cpu(), got_r[0].cpu(), wi, ws)
        e_c = topk_match(got_c[1].cpu(), got_c[0].cpu(), wi, ws)
        bd = bound(buf["ids"], top_c, u[:n_distinct], d=d,
                   elem_bytes=buf["emb"].element_size(), k=k, b=batch,
                   dequant=p == "int8")
        streamed = int((buf["ids"][top_c.long()] >= 0).sum()) * (
            d * buf["emb"].element_size())
        log(f"phase 3 {p} routed: {r_ms:.3f} ms (B={batch}, cr={cr}, "
            f"U={n_distinct}) vs plain {r_plain:.3f} ms (chunks of {sub}); "
            f"bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}: "
            f"{bd['bytes'] / 1e9:.3f} GB, {bd['flops'] / 1e9:.2f} GFLOP); "
            f"rows streamed {streamed / 1e9:.2f} GB; prefix {t_prefix:.3f} ms")
        log(f"phase 3 {p} cluster_major: {cm_ms:.3f} ms (+ plan and fold: "
            f"{cm_path_ms:.3f} ms) vs plain {cm_plain:.3f} ms (chunks of "
            f"{sub}); bound {bd['bound_ms']:.3f} ms; full-chunk max|err| "
            f"routed {e_r:.3g} cm {e_c:.3g}")
        report[p] = dict(routed=dict(ms=r_ms, plain_ms=r_plain, err=max(err, e_r)),
                         cluster_major=dict(ms=cm_ms, plain_ms=cm_plain,
                                            path_ms=cm_path_ms,
                                            err=max(err, e_c)),
                         bound=bd, prefix_ms=t_prefix, walls=walls)
    return dict(report=report, launches=main_launches,
                distinct_clusters=n_distinct, route_loads=loads,
                picks=picks, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                queries=n_q, batch=batch, k=k, cr=cr,
                qps={f"{p}/{b}": n_q / wall for (p, b), wall in walls.items()})


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from repro_torch.kernels import fused_topk_score as fts
    t0 = time.perf_counter()
    info = fts.build_info()
    log(f"phase 0: kernels built in {info['seconds']:.1f} s "
        f"({time.perf_counter() - t0:.1f} s with loading) -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    t0 = time.perf_counter()
    err1 = phase1(dev)
    log(f"phase 1 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase2(dev)
    log(f"phase 2 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    p3 = phase3(dev)
    log(f"phase 3 took {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{p3['peak_gb']:.1f} GB")

    src = "src/repro_torch/kernels/csrc/fused_topk_score.cu"
    replaces = {"routed": "src/repro/kernels/fused_topk_score.py:314",
                "cluster_major": "src/repro/kernels/fused_topk_score.py:509"}
    kernels = []
    for name in ("routed", "cluster_major"):
        f32, i8 = p3["report"]["f32"], p3["report"]["int8"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": p3["launches"][name],
            "max_abs_err": max(err1[name], f32[name]["err"], i8[name]["err"]),
            "ms": f32[name]["ms"], "plain_ms": f32[name]["plain_ms"],
            "bound_ms": f32["bound"]["bound_ms"],
            "bound_by": f32["bound"]["bound_by"], "library_ms": None,
            "shape": {"queries": p3["batch"], "cr": p3["cr"], "k": p3["k"],
                      "precision": "f32",
                      "distinct_clusters": p3["distinct_clusters"]},
            "int8": {"ms": i8[name]["ms"], "plain_ms": i8[name]["plain_ms"],
                     "bound_ms": i8["bound"]["bound_ms"],
                     "bound_by": i8["bound"]["bound_by"]},
        })
    rep = p3["report"]
    log(json.dumps({
        "card": card, "route_loads": p3["route_loads"], "qps": p3["qps"],
        "picks": p3["picks"], "prefix_ms": rep["f32"]["prefix_ms"],
        "cm_with_plan_and_fold_ms": {p: rep[p]["cluster_major"]["path_ms"]
                                     for p in ("f32", "int8")},
        "bound_detail": {p: rep[p]["bound"] for p in ("f32", "int8")},
        "peak_device_gb": p3["peak_gb"]}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
