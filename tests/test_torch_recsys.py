"""The port's recsys models and streams against the reference, on the CPU.

DLRM, xDeepFM, BERT4Rec and MIND (``repro_torch.models.recsys``) run
reduced (``configs.reduced``, f32) on the reference's own parameters,
carried across by ``convert.recsys_from_numpy``, and the same numpy
batches: forwards, losses and serving outputs within 1e-5. The embedding
bag runs in every mode (offsets, segment ids, ``sum``, ``mean``,
weights). ``CTRStream`` and ``SeqRecStream`` draw the reference's
batches. ``cuda``-marked cases hold the dot-interaction and embedding-bag
launches of the DLRM path against their plain versions on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.data import CTRStream as RefCTR
from repro.data import SeqRecStream as RefSeq
from repro.models import recsys as ref_rs
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.data.recsys_data import CTRStream, SeqRecStream
from repro_torch.models import recsys as rs

from test_torch_common import np_tree, ref_on_cpu

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)
RECSYS = ["dlrm-mlperf", "xdeepfm", "bert4rec", "mind"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfg(arch):
    return (ref_configs.reduced(ref_configs.get_config(arch)),
            port_configs.reduced(port_configs.get_config(arch)))


_INIT = {"dlrm-mlperf": "dlrm_init", "xdeepfm": "xdeepfm_init",
         "bert4rec": "bert4rec_init", "mind": "mind_init"}


def _params(arch):
    """``(reference cfg, port cfg, reference params, port params)``."""
    rcfg, pcfg = _cfg(arch)
    with ref_on_cpu():
        params = getattr(ref_rs, _INIT[arch])(KEY, rcfg)
    return rcfg, pcfg, params, convert.recsys_from_numpy(np_tree(params))


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# embedding primitives
# ---------------------------------------------------------------------------


def test_pad_rows():
    for v in (1, 511, 512, 513, 40_000_000, 3_067_956):
        assert rs.pad_rows(v) == ref_rs.pad_rows(v)
        assert rs.pad_rows(v, 64) == ref_rs.pad_rows(v, 64)


_BAG_CASES = {
    "offsets-sum": dict(offsets=[0, 2, 5, 5, 9], n_bags=5),
    "offsets-mean": dict(offsets=[0, 2, 5, 5, 9], n_bags=5, mode="mean"),
    "segments-sum": dict(segment_ids=[2, 0, 2, 1, 0, 4, 4, 2, 1, 0, 3, 2],
                         n_bags=6),
    "segments-mean": dict(segment_ids=[2, 0, 2, 1, 0, 4, 4, 2, 1, 0, 3, 2],
                          n_bags=6, mode="mean"),
    "weights-sum": dict(offsets=[0, 3, 4, 8], n_bags=4, weights=True),
    "weights-mean": dict(segment_ids=[1, 1, 0, 3, 3, 3, 0, 1, 2, 2, 0, 1],
                         n_bags=5, mode="mean", weights=True),
}


@pytest.mark.parametrize("case", list(_BAG_CASES))
def test_embedding_bag(case):
    """Every mode against the reference's gather + segment sum; an empty
    bag is zero (mean: divided by the floored count)."""
    kw = dict(_BAG_CASES[case])
    rng = np.random.default_rng(7)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    n_idx = 12
    idx = rng.integers(0, 50, n_idx).astype(np.int32)
    w = rng.normal(size=n_idx).astype(np.float32) if kw.pop("weights",
                                                            False) else None
    ref_kw = {k: (jnp.asarray(np.asarray(v, np.int32)) if isinstance(v, list)
                  else v) for k, v in kw.items()}
    port_kw = {k: (torch.tensor(v) if isinstance(v, list) else v)
               for k, v in kw.items()}
    with ref_on_cpu():
        want = ref_rs.embedding_bag(
            jnp.asarray(table), jnp.asarray(idx), **ref_kw,
            weights=None if w is None else jnp.asarray(w))
    got = rs.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                           **port_kw,
                           weights=None if w is None else torch.from_numpy(w))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_embedding_bag_modes():
    """tests/test_arch_smoke.py's bag test on the port."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    idx = torch.tensor([0, 1, 2, 3, 4, 5], dtype=torch.int32)
    offsets = torch.tensor([0, 2, 5], dtype=torch.int32)
    out = rs.embedding_bag(table, idx, offsets=offsets, n_bags=3)
    np.testing.assert_allclose(_np(out[0]), _np(table[0] + table[1]),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(out[2]), _np(table[5]), rtol=1e-6)
    out_m = rs.embedding_bag(table, idx, offsets=offsets, n_bags=3,
                             mode="mean")
    np.testing.assert_allclose(_np(out_m[0]), _np(table[0] + table[1]) / 2,
                               rtol=1e-6)


def test_bag_matrix_keeps_each_bags_order():
    """The kernel's (B, P) ids: bag b's entries in their order in idx, −1
    past the bag's end; ids outside every bag are left out."""
    seg = torch.tensor([1, 0, 1, 3, 0, 1, -1, 9])
    idx = torch.tensor([10, 11, 12, 13, 14, 15, 16, 17])
    got = rs.bag_matrix(seg, 4, idx)
    assert got.dtype == torch.int32
    assert got.tolist() == [[11, 14, -1], [10, 12, 15], [-1, -1, -1],
                            [13, -1, -1]]


def test_embedding_bag_bf16_table_keeps_dtype():
    """A bf16 table's bags come back in bf16, as the reference's segment
    sum; the kernel's f32 sum is rounded once."""
    rng = np.random.default_rng(8)
    table = torch.from_numpy(rng.normal(size=(30, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 30, 10))
    off = torch.tensor([0, 4, 7])
    got = rs.embedding_bag(table.bfloat16(), idx, offsets=off, n_bags=3)
    want = rs.embedding_bag(table.bfloat16().float(), idx, offsets=off,
                            n_bags=3)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want.bfloat16()))


def test_embedding_lookup():
    rng = np.random.default_rng(9)
    table = rng.normal(size=(40, 6)).astype(np.float32)
    idx = rng.integers(0, 40, (3, 5)).astype(np.int32)
    want = ref_rs.embedding_lookup(jnp.asarray(table), jnp.asarray(idx))
    got = rs.embedding_lookup(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_bce():
    rng = np.random.default_rng(10)
    logit = (rng.normal(size=64) * 30).astype(np.float32)
    label = (rng.random(64) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        _np(rs._bce(torch.from_numpy(logit), torch.from_numpy(label))),
        _np(ref_rs._bce(jnp.asarray(logit), jnp.asarray(label))), **TOL)


# ---------------------------------------------------------------------------
# the four models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RECSYS)
def test_init_layout(arch):
    """The port's own init draws the reference's pytree: the same tree,
    shapes and dtypes (the values come from another generator)."""
    rcfg, pcfg, params, _ = _params(arch)
    mine = getattr(rs, _INIT[arch])(pcfg, seed=1, device="cpu")
    want = np_tree(params)
    got = convert.recsys_to_numpy(mine)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("arch", RECSYS)
def test_params_round_trip(arch):
    _, _, params, port = _params(arch)
    back = convert.recsys_to_numpy(port)
    want = np_tree(params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def _ctr(cfg, b=16, step=0):
    return RefCTR(cfg.n_dense, cfg.table_sizes, seed=0).batch(step, b)


def test_dlrm_dot_interaction():
    x = np.random.default_rng(11).normal(size=(5, 27, 16)).astype(np.float32)
    want = ref_rs.dlrm_dot_interaction(jnp.asarray(x))
    got = rs.dlrm_dot_interaction(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_dlrm_forward_and_loss():
    rcfg, pcfg, params, port = _params("dlrm-mlperf")
    b = _ctr(rcfg)
    with ref_on_cpu():
        want = ref_rs.dlrm_forward(params, jnp.asarray(b["dense"]),
                                   jnp.asarray(b["sparse"]), rcfg)
        wloss, _ = ref_rs.dlrm_loss(params, _jnp(b), rcfg)
    got = rs.dlrm_forward(port, torch.from_numpy(b["dense"]),
                          torch.from_numpy(b["sparse"]), pcfg)
    gloss, metrics = rs.dlrm_loss(port, b, pcfg)
    assert got.shape == (16,)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(gloss), float(wloss), **TOL)
    assert float(metrics["loss"]) == float(gloss)


def test_xdeepfm_forward_and_loss():
    rcfg, pcfg, params, port = _params("xdeepfm")
    b = RefCTR(1, [rcfg.vocab_per_field] * rcfg.n_sparse, seed=0).batch(0, 16)
    with ref_on_cpu():
        want = ref_rs.xdeepfm_forward(params, jnp.asarray(b["sparse"]), rcfg)
        wloss, _ = ref_rs.xdeepfm_loss(params, _jnp(b), rcfg)
    got = rs.xdeepfm_forward(port, torch.from_numpy(b["sparse"]), pcfg)
    gloss, _ = rs.xdeepfm_loss(port, b, pcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(gloss), float(wloss), **TOL)


def _b4r_batch(cfg, b=8):
    return RefSeq(cfg.n_items, seed=0).bert4rec_batch(
        0, b, cfg.seq_len, cfg.mask_prob, mask_token=cfg.n_items + 1)


def test_bert4rec_encode_and_loss():
    rcfg, pcfg, params, port = _params("bert4rec")
    b = _b4r_batch(rcfg)
    b["mask"][:, -3:] = False            # padded tails mask keys out
    with ref_on_cpu():
        want = ref_rs.bert4rec_encode(params, jnp.asarray(b["seq"]),
                                      jnp.asarray(b["mask"]), rcfg)
        wloss, _ = ref_rs.bert4rec_loss(params, _jnp(b), rcfg)
    got = rs.bert4rec_encode(port, b["seq"], b["mask"], pcfg)
    gloss, _ = rs.bert4rec_loss(port, b, pcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(gloss), float(wloss), **TOL)


def test_bert4rec_serving():
    rcfg, pcfg, params, port = _params("bert4rec")
    b = _b4r_batch(rcfg)
    mask = b["mask"].copy()
    mask[1, 10:] = False
    mask[2, :] = False                   # no valid position: slot 0
    with ref_on_cpu():
        wu = ref_rs.bert4rec_user_embedding(
            params, jnp.asarray(b["seq"]), jnp.asarray(mask), rcfg)
        ws = ref_rs.bert4rec_score_all(params, jnp.asarray(b["seq"]),
                                       jnp.asarray(mask), rcfg)
    gu = rs.bert4rec_user_embedding(port, b["seq"], mask, pcfg)
    gs = rs.bert4rec_score_all(port, b["seq"], mask, pcfg)
    assert gu.shape == (8, pcfg.embed_dim)
    assert gs.shape == (8, rs.pad_rows(pcfg.n_items + 2))
    np.testing.assert_allclose(_np(gu), _np(wu), **TOL)
    np.testing.assert_allclose(_np(gs), _np(ws), **TOL)


def test_mind_interests_and_loss():
    rcfg, pcfg, params, port = _params("mind")
    b = RefSeq(rcfg.n_items, seed=0).mind_batch(0, 8, rcfg.hist_len)
    b["hist_mask"][:, -2:] = False
    with ref_on_cpu():
        wi = ref_rs.mind_interests(params, jnp.asarray(b["hist"]),
                                   jnp.asarray(b["hist_mask"]), rcfg)
        wloss, _ = ref_rs.mind_loss(params, _jnp(b), rcfg)
    gi = rs.mind_interests(port, b["hist"], b["hist_mask"], pcfg)
    gloss, _ = rs.mind_loss(port, b, pcfg)
    np.testing.assert_allclose(_np(gi), _np(wi), **TOL)
    np.testing.assert_allclose(float(gloss), float(wloss), **TOL)


def test_mind_score_candidates():
    rcfg, pcfg, params, port = _params("mind")
    b = RefSeq(rcfg.n_items, seed=1).mind_batch(0, 8, rcfg.hist_len)
    cand = np.arange(50, dtype=np.int32)
    with ref_on_cpu():
        want = ref_rs.mind_score_candidates(
            params, jnp.asarray(b["hist"]), jnp.asarray(b["hist_mask"]),
            jnp.asarray(cand), rcfg)
    got = rs.mind_score_candidates(port, b["hist"], b["hist_mask"], cand,
                                   pcfg)
    assert got.shape == (8, 50)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_squash():
    x = np.random.default_rng(12).normal(size=(4, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(_np(rs._squash(torch.from_numpy(x))),
                               _np(ref_rs._squash(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_smoke(arch):
    """tests/test_arch_smoke.py's recsys smoke on the port alone: its own
    init and streams, finite losses, the serving shapes."""
    cfg = port_configs.reduced(port_configs.get_config(arch))
    if arch == "dlrm-mlperf":
        b = CTRStream(cfg.n_dense, cfg.table_sizes, seed=0).batch(0, 16)
        params = rs.dlrm_init(cfg, device="cpu")
        loss, _ = rs.dlrm_loss(params, b, cfg)
        assert rs.dlrm_forward(params, b["dense"], b["sparse"],
                               cfg).shape == (16,)
    elif arch == "xdeepfm":
        b = CTRStream(1, [cfg.vocab_per_field] * cfg.n_sparse,
                      seed=0).batch(0, 16)
        params = rs.xdeepfm_init(cfg, device="cpu")
        loss, _ = rs.xdeepfm_loss(params, b, cfg)
    elif arch == "bert4rec":
        b = SeqRecStream(cfg.n_items, seed=0).bert4rec_batch(
            0, 8, cfg.seq_len, cfg.mask_prob, mask_token=cfg.n_items + 1)
        params = rs.bert4rec_init(cfg, device="cpu")
        loss, _ = rs.bert4rec_loss(params, b, cfg)
        emb = rs.bert4rec_user_embedding(params, b["seq"], b["mask"], cfg)
        assert emb.shape == (8, cfg.embed_dim)
    else:
        b = SeqRecStream(cfg.n_items, seed=0).mind_batch(0, 8, cfg.hist_len)
        params = rs.mind_init(cfg, device="cpu")
        loss, _ = rs.mind_loss(params, b, cfg)
        s = rs.mind_score_candidates(params, b["hist"], b["hist_mask"],
                                     torch.arange(50), cfg)
        assert s.shape == (8, 50)
    assert np.isfinite(float(loss))


def test_recsys_inits_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    cfg = port_configs.reduced(port_configs.get_config("mind"))
    with pytest.raises(RuntimeError, match="cuda"):
        rs.mind_init(cfg)


# ---------------------------------------------------------------------------
# the streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 5)])
def test_ctr_stream(seed, step):
    want = RefCTR(13, [100, 7, 40_000_000, 3], seed=seed).batch(step, 32)
    got = CTRStream(13, [100, 7, 40_000_000, 3], seed=seed).batch(step, 32)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed", [0, 3])
def test_seqrec_stream(seed):
    ref, port = RefSeq(200, seed=seed), SeqRecStream(200, seed=seed)
    for want, got in [
            (ref.bert4rec_batch(2, 8, 16, 0.2, mask_token=201),
             port.bert4rec_batch(2, 8, 16, 0.2, mask_token=201)),
            (ref.mind_batch(4, 8, 8), port.mind_batch(4, 8, 8))]:
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# On the card: the DLRM path's kernel launches
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_dlrm_launches_dot_interaction(cuda_device):
    """One dot-interaction launch per forward; the launch equals the plain
    version on its inputs exactly, and the logits the CPU forward's."""
    from repro_torch.kernels import dot_interaction as di
    cfg = port_configs.reduced(port_configs.get_config("dlrm-mlperf"))
    params = rs.dlrm_init(cfg, seed=2, device="cpu")
    b = CTRStream(cfg.n_dense, cfg.table_sizes, seed=1).batch(0, 300)
    want = rs.dlrm_forward(params, b["dense"], b["sparse"], cfg)
    on_card = jax.tree.map(lambda t: t.to(cuda_device), params)
    calls = []
    real = di.dot_interaction

    def record(feats):
        out = real(feats)
        calls.append((feats, out))
        return out
    di.dot_interaction = record
    try:
        before = di.launches["dot_interaction"]
        got = rs.dlrm_forward(on_card, b["dense"], b["sparse"], cfg)
        torch.cuda.synchronize()
    finally:
        di.dot_interaction = real
    assert di.launches["dot_interaction"] - before == 1 and len(calls) == 1
    feats, out = calls[0]
    torch.testing.assert_close(out, di.dot_interaction_plain(feats),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_cuda_embedding_bag_launches_kernel(cuda_device, mode):
    from repro_torch.kernels import embedding_bag as eb
    rng = np.random.default_rng(13)
    table = torch.from_numpy(rng.normal(size=(5000, 128)).astype(np.float32))
    sizes = rng.integers(0, 17, 1000)
    idx = torch.from_numpy(rng.integers(0, 5000, sizes.sum()))
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)[:-1]]))
    want = rs.embedding_bag(table, idx, offsets=off, n_bags=1000, mode=mode)
    before = eb.launches["embedding_bag"]
    got = rs.embedding_bag(table.to(cuda_device), idx.to(cuda_device),
                           offsets=off.to(cuda_device), n_bags=1000,
                           mode=mode)
    torch.cuda.synchronize()
    assert eb.launches["embedding_bag"] - before == 1
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
