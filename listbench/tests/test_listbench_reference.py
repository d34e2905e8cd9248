"""The plain reference against the port run on the CPU at a small size:
the tower, the mixing weights, the router, ŵ_s, the placement and its
stored rows, the score and the top-k."""
import dataclasses

import numpy as np
import pytest
import torch

from listbench import inputs, judge, system
from listbench.reference import index as ref_index
from listbench.reference import model, score
from listbench.tests.tiny import TINY_CFG

SEED = 2_147_483_659          # above 2**31: seeds are any whole number


def _cfg(precision="bf16"):
    base = dict(system_cfg())
    base.update(TINY_CFG, precision=precision)
    return base


def system_cfg():
    from listbench import manifest
    man = manifest.load()
    return manifest.config(man, manifest.cell(man, "bf16-route2"))


def _port(cfg):
    from repro_torch import convert
    tree = inputs.weights(cfg, SEED, "cpu")
    pcfg = dataclasses.replace(system.port_config(cfg),
                               compute_dtype="float32")
    rel, index = convert.params_from_numpy(tree["rel"], tree["index"], pcfg)
    return tree, rel, index


def _queries(cfg, n=64):
    tok, msk, loc, _ = inputs.queries(
        cfg, {"len_min": 4, "len_max": 16}, SEED, inputs.STREAM_QUERIES, 0, n)
    return torch.from_numpy(tok), torch.from_numpy(msk), torch.from_numpy(loc)


def test_tower_weights_and_router_match_the_port_in_f32():
    from repro_torch.core import index as index_lib
    from repro_torch.core import relevance
    cfg = _cfg()
    tree, rel, index = _port(cfg)
    tok, msk, loc = _queries(cfg)
    with torch.no_grad():
        want = relevance.encode_queries(rel, tok, msk)
        got = model.encode(tree["rel"]["q_enc"], tok, msk,
                           n_heads=cfg["num_attention_heads"],
                           eps=cfg["layer_norm_eps"])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(model.mixing_weights(tree["rel"], got),
                                   relevance.st_weights(rel, want),
                                   rtol=1e-5, atol=1e-5)
        emb, oloc = inputs.objects(cfg, SEED, "cpu")
        norm = index_lib.loc_normalizer(oloc)
        rnorm = model.normalizer(oloc)
        torch.testing.assert_close(rnorm[0], norm["lo"])
        torch.testing.assert_close(rnorm[1], norm["span"])
        feats = index_lib.build_features(want, loc, norm)
        torch.testing.assert_close(model.features(want, loc, rnorm), feats)
        torch.testing.assert_close(
            model.router_logits(tree["index"], feats),
            index_lib.cluster_logits(index, feats), rtol=1e-5, atol=1e-5)


def test_spatial_table_matches_the_port():
    from repro_torch.core import spatial
    cfg = _cfg()
    tree, rel, _ = _port(cfg)
    torch.testing.assert_close(model.spatial_table(tree["rel"]),
                               spatial.extract_lookup(rel.spatial["w_s"]))


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_placement_and_rows_match_the_port(precision):
    cfg = _cfg(precision)
    searcher = system.build_searcher(cfg, SEED, "cpu")
    ref = judge.Reference(cfg, SEED, "cpu")
    buf = searcher.snapshot.buffers
    np.testing.assert_array_equal(buf["ids"].numpy(), ref.ids)
    assert ref.placement_mismatch(buf) == 0
    # a moved row is seen
    bad = dict(buf, emb=buf["emb"].clone())
    bad["emb"][0, 0] = bad["emb"][1, 0]
    assert ref.placement_mismatch(bad) == 1


def test_place_spills_to_the_least_loaded_cluster():
    routes = np.array([[0, 1], [0, 1], [0, 1], [0, 1], [1, 0]])
    ids = ref_index.place(routes, n_clusters=3, capacity=2)
    assert ids.tolist() == [[0, 1], [2, 3], [4, -1]]


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_score_and_topk_match_the_port(precision):
    from repro_torch.kernels import fused_topk_score as fts
    cfg = _cfg(precision)
    searcher = system.build_searcher(cfg, SEED, "cpu")
    snap = searcher.snapshot
    ref = judge.Reference(cfg, SEED, "cpu")
    g = torch.Generator().manual_seed(3)
    q = torch.nn.functional.normalize(torch.randn(16, cfg["hidden_size"],
                                                  generator=g), dim=-1) * 4
    qloc = torch.rand(16, 2, generator=g)
    w = torch.rand(16, 2, generator=g) + 0.1
    top_c = torch.stack([torch.randperm(cfg["n_clusters"], generator=g)[:2]
                         for _ in range(16)]).to(torch.int32)
    buf = snap.buffers
    scale = buf["scale"] if precision == "int8" else None
    want_s, want_i = fts.routed_topk_plain(
        q, qloc, w, top_c, buf["emb"], buf["loc"], buf["ids"], snap.w_hat,
        k=10, dist_max=cfg["dist_max"], buf_scale=scale)
    got_s, got_i = score.topk_over_clusters(
        top_c.tolist(), ref.members, lambda x: ref.rows(x, precision), q,
        qloc, w, ref.w_hat, k=10, dist_max=cfg["dist_max"])
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-5)
    assert (got_i == want_i.long()).float().mean() > 0.99


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_port_placement_keeps_the_walks_rule(precision):
    cfg = _cfg(precision)
    searcher = system.build_searcher(cfg, SEED, "cpu")
    ids = searcher.snapshot.buffers["ids"]
    ref = judge.Reference(cfg, SEED, "cpu", placement=ids)
    assert ref.violations == 0
    walked = judge.Reference(cfg, SEED, "cpu")
    np.testing.assert_array_equal(ref.ids, walked.ids)
    routes = ref_index.object_routes(ref.tree["index"], ref.emb, ref.loc,
                                     ref.norm, cfg["spill"])
    swapped = ids.clone()
    swapped[0, 0], swapped[1, 0] = ids[1, 0], ids[0, 0]
    assert ref_index.placement_violations(
        routes, swapped, capacity=cfg["capacity"]) >= 2
    dropped = ids.clone()
    dropped[0, int((ids[0] >= 0).sum()) - 1] = -1
    assert ref_index.placement_violations(
        routes, dropped, capacity=cfg["capacity"]) >= 1


def test_walk_is_the_ports_under_skewed_routes():
    from repro_torch.core import index as index_lib
    rng = np.random.default_rng(5)
    for n, c, cap in [(5000, 12, 640), (20000, 40, 768)]:
        p = 1.0 / np.arange(1, c + 1) ** 1.5
        routes = np.stack([rng.choice(c, 3, replace=False, p=p / p.sum())
                           for _ in range(n)])
        want, _, _ = index_lib.place_objects(routes, n_clusters=c,
                                             capacity=cap, spill=3)
        np.testing.assert_array_equal(
            ref_index.place(routes, n_clusters=c, capacity=cap), want)


def test_seeds_order_one_model():
    """Two seeds give the same tower (up to the vocabulary's order) and
    the same router up to its cluster labels."""
    cfg = _cfg()
    a, b = inputs.weights(cfg, 1, "cpu"), inputs.weights(cfg, 2, "cpu")
    assert not torch.equal(a["index"]["mlp"][2]["w"],
                           b["index"]["mlp"][2]["w"])
    tok, msk, loc = _queries(cfg)
    b["rel"]["q_enc"]["embed"] = a["rel"]["q_enc"]["embed"]
    kw = dict(n_heads=cfg["num_attention_heads"], eps=cfg["layer_norm_eps"])
    qa = model.encode(a["rel"]["q_enc"], tok, msk, **kw)
    qb = model.encode(b["rel"]["q_enc"], tok, msk, **kw)
    torch.testing.assert_close(qa, qb, rtol=1e-5, atol=1e-5)
    feats = model.features(qa, loc, (torch.zeros(2), torch.ones(2)))
    la = model.router_logits(a["index"], feats).sort(-1).values
    lb = model.router_logits(b["index"], feats).sort(-1).values
    torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-5)
