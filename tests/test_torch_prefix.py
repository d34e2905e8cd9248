"""The port's query prefix (encode → mixing weights → route) against the
reference's ``engine.make_prefix_fn`` on the same snapshot directory.

With float32 compute the port must match to 1e-5 and pick the same
routes. With the model's bf16 compute the two frameworks round at other
places (the reference's own eager and jit encodes differ, DESIGN.md §11),
so q_emb is held to a looser bound and routes to an agreement rate.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import api as ref_api
from repro.core import index as ref_index
from repro.core import relevance as ref_relevance
from repro.core import spatial as ref_spatial
from repro_torch import api
from repro_torch.core import engine as port_engine
from repro_torch.core import index as port_index
from repro_torch.core import relevance as port_relevance

from test_torch_common import (make_ref_snapshot, make_requests, ref_prefix,
                               tiny_cfg, to_torch)

N_Q, CR = 64, 2

# bf16 compute: bounds measured with margin on the tiny geometry
BF16_Q_ATOL = 0.08
BF16_W_ATOL = 0.03
BF16_ROUTE_AGREEMENT = 0.85


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request, tmp_path_factory):
    snap = make_ref_snapshot(tiny_cfg(compute_dtype=request.param))
    d = str(tmp_path_factory.mktemp(request.param))
    ref_api.save(snap, d)
    return request.param, snap, api.load(d, device="cpu")


def _port_prefix(psnap, tok, msk, loc):
    fn = port_engine.make_prefix_fn(cr=CR)
    return tuple(x.numpy() for x in fn(
        psnap.rel, psnap.index, psnap.norm, torch.from_numpy(tok),
        torch.from_numpy(msk), torch.from_numpy(loc)))


def test_prefix_matches_reference(pair):
    compute, snap, psnap = pair
    tok, msk, loc = make_requests(np.random.default_rng(1), N_Q, snap.cfg)
    q_emb, w, top_c = ref_prefix(snap, tok, msk, loc, cr=CR)
    pq, pw, ptc = _port_prefix(psnap, tok, msk, loc)
    assert pq.shape == q_emb.shape and pq.dtype == np.float32
    assert ptc.shape == top_c.shape and ptc.dtype == np.int32
    agree = float((ptc == top_c).all(axis=1).mean())
    if compute == "float32":
        np.testing.assert_allclose(pq, q_emb, atol=1e-5, rtol=0)
        np.testing.assert_allclose(pw, w, atol=1e-5, rtol=0)
        assert agree == 1.0
    else:
        np.testing.assert_allclose(pq, q_emb, atol=BF16_Q_ATOL, rtol=0)
        np.testing.assert_allclose(pw, w, atol=BF16_W_ATOL, rtol=0)
        assert agree >= BF16_ROUTE_AGREEMENT, agree


def test_router_and_weights_on_reference_embeddings(pair):
    """Given the reference's own q_emb, features, routes and weights agree
    exactly up to float rounding, whatever the encoder's compute dtype."""
    _, snap, psnap = pair
    tok, msk, loc = make_requests(np.random.default_rng(2), N_Q, snap.cfg)
    q_emb, w, top_c = ref_prefix(snap, tok, msk, loc, cr=CR)
    feats = ref_index.build_features(jnp.asarray(q_emb), jnp.asarray(loc),
                                     snap.norm)
    pfeats = port_index.build_features(to_torch(q_emb), to_torch(loc),
                                       psnap.norm)
    np.testing.assert_allclose(pfeats.numpy(), np.asarray(feats), atol=1e-6)
    logits = ref_index.cluster_logits(snap.index_params, feats)
    plogits = port_index.cluster_logits(psnap.index, pfeats)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(logits), atol=1e-5)
    ptc, _ = port_index.route_queries(psnap.index, pfeats, cr=CR)
    np.testing.assert_array_equal(ptc.numpy(), top_c)
    pw = port_relevance.st_weights(psnap.rel, to_torch(q_emb))
    np.testing.assert_allclose(pw.numpy(), w, atol=1e-6)
    np.testing.assert_allclose(
        psnap.w_hat.numpy(),
        np.asarray(ref_spatial.extract_lookup(snap.rel_params["spatial"])),
        rtol=1e-6)


def test_fixed_weight_mode(pair):
    _, snap, psnap = pair
    q = np.random.default_rng(3).normal(size=(5, snap.cfg.d_model))
    want = ref_relevance.st_weights(snap.rel_params, jnp.asarray(q),
                                    weight_mode="fixed")
    got = port_relevance.st_weights(psnap.rel, torch.from_numpy(q).float(),
                                    weight_mode="fixed")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
