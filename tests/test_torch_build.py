"""The port's build path against the reference, on the CPU at small sizes
(2 layers, d 32–48, ``spatial_t`` 50, c 4–8):

* the build's buffers from the reference's trained params, array-equal;
* the mirror of ``tests/test_pipeline_e2e.py``'s recall criterion (its
  widths, corpus and steps, bf16 compute);
* ``api.build``'s snapshot saved by the port and served by the reference;
* the serve path on modules that still require grad, and the snapshot's
  own modules frozen;
* on the card: the port-built snapshot on every GPU backend against the
  CPU's ``dense``.

Tolerances: buffers exactly; ids equal up to ties, scores within 1e-5 on
the CPU (``assert_topk_match``), 1e-4 between the card and the CPU. The
reference runs under ``jax.default_device(cpu)``.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import cluster_metrics as ref_cm
from repro.core import pipeline as ref_pipeline
from repro_torch import api, convert
from repro_torch.configs import get_config
from repro_torch.core import pipeline as port_pipeline
from repro_torch.data import geotextual as port_geo

from test_torch_common import (assert_topk_match, corpora, np_tree,
                               ref_on_cpu, tiny_cfg)


@pytest.fixture(scope="module")
def train_corpora():
    return corpora()


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ref_trained(train_corpora):
    """A reference retriever briefly trained at the tiny widths."""
    ref_corpus, _ = train_corpora
    cfg = tiny_cfg(compute_dtype="float32", neg_start=100, neg_end=150)
    with ref_on_cpu():
        r = ref_pipeline.ListRetriever(cfg, ref_corpus)
        r.train_relevance(steps=4, batch=8, log_every=100)
        r.train_index(steps=6, batch=8, log_every=100)
    return r


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_build_buffers_match_reference(train_corpora, ref_trained, precision):
    """The reference's trained params and object embeddings through the
    port's ``ListRetriever.build``: buffers array-equal."""
    r = ref_trained
    with ref_on_cpu():
        want = r.build(precision=precision)
    p = port_pipeline.ListRetriever(r.cfg, train_corpora[1], device="cpu")
    p.rel, p.index = convert.params_from_numpy(
        np_tree(r.rel_params), np_tree(r.index_params), r.cfg)
    p.norm = {k: torch.from_numpy(np.array(v)) for k, v in r.norm.items()}
    p.obj_emb = np.asarray(r.obj_emb)
    got = p.build(precision=precision)
    for k in ("emb", "loc", "ids", "counts", "scale", "attrs"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
    for k in ("capacity", "n_spilled"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(p.obj_assign, np.asarray(r.obj_assign))


@pytest.fixture(scope="module")
def e2e_trained():
    """The port at ``tests/test_pipeline_e2e.py``'s fixture: its widths,
    corpus and steps (bf16 compute, the config's default)."""
    cfg = dataclasses.replace(
        get_config("list-dual-encoder"),
        n_layers=2, d_model=48, n_heads=2, d_ff=96, vocab_size=2048,
        max_len=16, spatial_t=50, n_clusters=8, neg_start=600, neg_end=750,
        index_mlp_hidden=(64,))
    corpus = port_geo.GeoCorpus(port_geo.GeoCorpusConfig(
        n_objects=1200, n_queries=240, n_topics=8, vocab_size=2048, seed=1))
    r = port_pipeline.ListRetriever(cfg, corpus, device="cpu")
    r.train_relevance(steps=150, batch=48, lr=1.5e-3, log_every=1000)
    r.train_index(steps=600, batch=48, lr=3e-3, log_every=1000)
    r.build()
    return r


def test_list_recall_close_to_brute_force(e2e_trained):
    """The reference's criterion (``tests/test_pipeline_e2e.py``): the
    relevance model learns (brute-force recall@10 > 0.15) and LIST at cr 2
    keeps at least 0.7 of it."""
    r = e2e_trained
    te = r.corpus.split()[2]
    positives = [r.corpus.positives[q] for q in te]
    bf_ids, _ = api.brute_force(r.snapshot(), r.corpus, te, k=10, batch=64)
    ids, _ = r.query(te, k=10, cr=2, batch=64)
    rb = ref_cm.recall_at_k(bf_ids, positives, 10)
    rl = ref_cm.recall_at_k(ids, positives, 10)
    assert rb > 0.15, f"relevance model too weak (brute recall {rb})"
    assert rl >= 0.7 * rb, f"LIST recall {rl} lost too much vs brute {rb}"
    for name in ("relevance", "index"):
        hist = r.history[name]
        assert [h["step"] for h in hist][-1] == (149 if name == "relevance"
                                                 else 599)
        assert all(np.isfinite(h["loss"]) for h in hist)


@pytest.fixture(scope="module")
def port_built(train_corpora):
    """``api.build`` on the CPU at the tiny widths, float32 compute."""
    cfg = tiny_cfg(compute_dtype="float32", neg_start=100, neg_end=150)
    snap, r = api.build(cfg, train_corpora[1], rel_steps=20, idx_steps=30,
                        batch=16, seed=3, return_retriever=True,
                        device="cpu")
    return snap, r


def test_port_build_served_by_reference(port_built, tmp_path):
    """``api.save`` of the port's build → ``repro.api.load`` → the
    reference's ``dense`` query: ids equal to the port's up to ties."""
    snap, r = port_built
    assert snap.meta.version == 0 and snap.meta.n_objects == 600
    d = str(tmp_path / "built")
    api.save(snap, d)
    te = r.corpus.split()[2]
    tok, msk = r.corpus.query_tokens(te)
    loc = r.corpus.q_loc[te].astype(np.float32)
    got = api.Searcher(snap, backend="dense", device="cpu").query(
        tok, msk, loc, k=10, cr=2, batch=8)
    with ref_on_cpu():
        want = ref_api.Searcher(ref_api.load(d), backend="dense").query(
            tok, msk, loc, k=10, cr=2, batch=8)
    assert_topk_match(got[0], got[1], want[0], want[1])


def test_serve_path_on_trainable_modules(port_built):
    """Modules that still require grad serve the same as the snapshot's
    frozen ones: ``embed_objects``, ``Searcher.query``, ``brute_force``;
    the snapshot's own modules are frozen."""
    snap, r = port_built
    assert not any(p.requires_grad for p in snap.rel.parameters())
    assert not any(p.requires_grad for p in snap.index.parameters())
    live = dataclasses.replace(
        snap, rel=copy.deepcopy(snap.rel).requires_grad_(True),
        index=copy.deepcopy(snap.index).requires_grad_(True))
    np.testing.assert_array_equal(
        port_pipeline.embed_objects(live.rel, r.corpus),
        port_pipeline.embed_objects(snap.rel, r.corpus))
    te = r.corpus.split()[2]
    tok, msk = r.corpus.query_tokens(te)
    loc = r.corpus.q_loc[te].astype(np.float32)
    for backend in ("dense", "dense-cm"):
        got = api.Searcher(live, backend=backend, device="cpu").query(
            tok, msk, loc, k=10, cr=2, batch=8)
        want = api.Searcher(snap, backend=backend, device="cpu").query(
            tok, msk, loc, k=10, cr=2, batch=8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(api.brute_force(live, r.corpus, te, k=10, batch=8),
                    api.brute_force(snap, r.corpus, te, k=10, batch=8)):
        np.testing.assert_array_equal(g, w)
    assert all(p.requires_grad for p in live.rel.parameters())


def test_build_needs_a_device_unless_told(train_corpora):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.build(tiny_cfg(), train_corpora[1], rel_steps=1, idx_steps=1)



@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_cuda_serves_port_build(cuda_device, port_built, precision):
    """The port-built snapshot on cuda / cuda-cm / auto at cr 2 and c
    against the dense backend on the CPU, on rows whose routes agree."""
    snap, r = port_built
    snap = snap.with_precision(precision)
    te = r.corpus.split()[2]
    tok, msk = r.corpus.query_tokens(te)
    loc = r.corpus.q_loc[te].astype(np.float32)
    cpu = api.Searcher(snap, backend="dense", device="cpu")
    for cr in (2, snap.cfg.n_clusters):
        same = (cpu.engine.route(tok, msk, loc, cr=cr).numpy()
                == api.Searcher(snap, device=cuda_device).engine.route(
                    tok, msk, loc, cr=cr).cpu().numpy()).all(axis=1)
        assert same.mean() >= 0.9
        want = cpu.query(tok, msk, loc, k=10, cr=cr, batch=8)
        for backend in ("cuda", "cuda-cm", "auto"):
            got = api.Searcher(snap, backend=backend,
                               device=cuda_device).query(
                tok, msk, loc, k=10, cr=cr, batch=8)
            assert_topk_match(got[0][same], got[1][same], want[0][same],
                              want[1][same], atol=1e-4)
