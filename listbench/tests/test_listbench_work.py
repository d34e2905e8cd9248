"""The benchmark's work counts against hand arithmetic at the cells'
shapes, and the scan count the same whichever scan the engine ran."""
import dataclasses

import numpy as np
import pytest
import torch

from listbench import inputs, manifest, system, work
from listbench.tests.tiny import TINY_CFG


def _cfg(cell):
    man = manifest.load()
    return manifest.config(man, manifest.cell(man, cell))


def test_encoder_and_head_flops_by_hand():
    cfg = _cfg("bf16-route2")
    d, f, L = 768, 3072, 12
    n = 36
    per_layer = 4 * (2 * n * d * d) + 2 * (2 * n * d * f) + 2 * (2 * n * n * d)
    assert work.encoder_flops(n, cfg) == L * per_layer + 2 * d * d
    assert work.encoder_flops(n, cfg) == 6_164_250_624
    router = 2 * (770 * 512 + 512 * 512 + 512 * 300)
    assert work.head_flops(cfg) == 2 * (768 * 64 + 64 * 2) + router
    assert work.queries_flops([36, 36], cfg) == 2 * (
        work.encoder_flops(36, cfg) + work.head_flops(cfg))


def test_row_bytes_by_tier():
    assert work.row_bytes(_cfg("bf16-route2")) == 768 * 2 + 8 + 4
    assert work.row_bytes(_cfg("int8-exhaustive")) == 768 + 8 + 4 + 4


def test_exhaustive_chunk_is_bound_by_its_products():
    cfg = _cfg("int8-exhaustive")
    n, b, c = 2_849_754, 256, 300
    flops = 2 * 768 * b * n
    nbytes = n * 784 + b * (768 * 4 + 16 + 20 * 8) + b * c * 4 + 1000 * 4
    assert work.scan_flops(b * n, cfg) == flops
    assert work.scan_bytes(b, b * c, n, 20, cfg) == nbytes
    bound = work.scan_bound_s(b, b * c, b * n, n, 20, cfg)
    assert bound == pytest.approx(flops / 989e12)
    assert bound == pytest.approx(1.1330e-3, rel=1e-3)


def test_routed_chunk_is_bound_by_its_bytes():
    cfg = _cfg("bf16-route2")
    # 256 queries on 37 distinct clusters of 19,072 live rows each
    rows = 37 * 19_072
    bound = work.scan_bound_s(256, 512, 512 * 19_072, rows, 20, cfg)
    assert bound == pytest.approx(
        work.scan_bytes(256, 512, rows, 20, cfg) / 3.35e12)
    assert bound == pytest.approx(rows * 1548 / 3.35e12, rel=0.01)


def test_scan_count_is_the_same_for_both_scans():
    """The routed and cluster-major scans (their plain versions on the
    CPU, the twins of ``cuda`` and ``cuda-cm``) give one count."""
    cfg = dict(_cfg("bf16-route2"), **TINY_CFG)
    searcher = system.build_searcher(cfg, 77, "cpu")
    tok, msk, loc, _ = inputs.queries(cfg, {"len_min": 4, "len_max": 16}, 77,
                                      inputs.STREAM_QUERIES, 0, 512)
    got = {}
    for backend in ("dense", "dense-cm"):
        rec = system.RouteRecorder()
        with rec.recording():
            searcher.query(tok, msk, loc, k=20, cr=2, batch=256,
                           backend=backend)
        got[backend] = rec.scans()
    assert got["dense"] == got["dense-cm"]
    assert len(got["dense"]) == 2
    bounds = {b: [work.scan_bound_s(p // 2, p, r, u, 20, cfg)
                  for p, r, u in s] for b, s in got.items()}
    assert bounds["dense"] == bounds["dense-cm"]
