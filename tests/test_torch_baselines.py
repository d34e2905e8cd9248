"""The port's ANN baselines (k-means, IVF, IVF_S, LSH, the LIST-R rerank)
against the reference's, on the CPU.

k-means: the port's initial rows (``kmeans_init_rows``, numpy) are
``jax.random.choice``'s for the same seed, in one and two shuffle rounds;
both packages run from their own draw and are held step by step (atol
1e-5). IVF and IVF_S: each package clusters with its own ``kmeans``, so
probes and candidates must be equal. LSH: the planes are one numpy draw, so the codes must be equal
except for a projection within 1e-5 of zero (either bit is right).
Rerank: ``ListRetriever.score_fn`` of both packages over the same params
and embeddings, through ``rerank_candidates``. Last, the baseline cases of
``tests/test_pipeline_e2e.py`` on the port.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import baselines as ref_bl
from repro.core import pipeline as ref_pl
from repro_torch import convert
from repro_torch.core import baselines as port_bl
from repro_torch.core import pipeline as port_pl

from test_torch_common import corpora, ref_on_cpu, tiny_cfg


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: these sizes gain nothing from
    more, and beside the suite's other workers a team of threads waits on
    every barrier for a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _blobs(seed, n=240, d=8, k=4):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 3, (k, d))
    x = centres[rng.integers(0, k, n)] + rng.normal(0, 1, (n, d))
    return x.astype(np.float32)


def _ref_kmeans(x, c, iters, seed=0):
    with ref_on_cpu():
        cent, assign = ref_bl.kmeans(jnp.asarray(x), c, iters=iters,
                                     seed=seed)
        return np.asarray(cent), np.asarray(assign)


@pytest.mark.parametrize("n,c", [(10, 3), (240, 6), (1625, 40),
                                 (1626, 40), (20_000, 64), (50_000, 300)])
def test_kmeans_init_rows_match_jax_choice(n, c):
    """``kmeans_init_rows`` draws ``jax.random.choice(PRNGKey(seed), n,
    (c,), replace=False)``'s rows: one shuffle round up to n = 1,625, two
    above, over several seeds (a negative one included)."""
    rounds = int(np.ceil(3 * np.log(n) / np.log(2.0 ** 32 - 1)))
    assert rounds == (1 if n <= 1625 else 2)
    for seed in (0, 1, 7, 2024, -3):
        want = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                            (c,), replace=False))
        np.testing.assert_array_equal(
            port_bl.kmeans_init_rows(n, c, seed=seed), want)


@pytest.mark.parametrize("seed", range(3))
def test_kmeans_step_matches_reference(seed):
    """Each Lloyd step of the port (``kmeans_step``) equals the
    reference's from the same centroids: the reference's seed-0 rows."""
    x = _blobs(seed)
    c = 6
    init = port_bl.kmeans_init_rows(len(x), c, seed=0)
    xt = torch.from_numpy(x)
    cent = xt[torch.from_numpy(init)]
    for iters in range(1, 6):
        cent, assign = port_bl.kmeans_step(xt, cent)
        want_c, want_a = _ref_kmeans(x, c, iters)
        np.testing.assert_array_equal(assign.numpy(), want_a)
        np.testing.assert_allclose(cent.numpy(), want_c, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", range(2))
def test_kmeans_matches_reference(seed):
    """``kmeans`` (25 steps) equals the reference's for one seed, each
    drawing its own initial rows; an empty cluster keeps its centroid
    (more clusters than blobs)."""
    x = _blobs(seed + 10)
    c = 9
    cent, assign = port_bl.kmeans(x, c, seed=seed, device="cpu")
    want_c, want_a = _ref_kmeans(x, c, 25, seed=seed)
    np.testing.assert_array_equal(assign.numpy(), want_a)
    np.testing.assert_allclose(cent.numpy(), want_c, atol=1e-5, rtol=0)


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("cr", [1, 2])
def test_ivf_probe_and_candidates_match(alpha, cr):
    """IVF (α 1) and IVF_S (α 0.5), each package clustering from its own
    k-means (the same initial rows): the features, probes and candidate
    lists of both packages agree."""
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(300, 16)).astype(np.float32)
    loc = rng.uniform(size=(300, 2)).astype(np.float32)
    q = rng.normal(size=(20, 16)).astype(np.float32)
    ql = rng.uniform(size=(20, 2)).astype(np.float32)
    with ref_on_cpu():
        ref = ref_bl.IVFIndex(emb, loc, n_clusters=5, alpha=alpha)
    port = port_bl.IVFIndex(emb, loc, n_clusters=5, alpha=alpha,
                            device="cpu")
    for a, b in zip(port.lists, ref.lists):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.probe(q, ql, cr=cr),
                                  ref.probe(q, ql, cr=cr))
    for a, b in zip(port.candidates(q, ql, cr=cr),
                    ref.candidates(q, ql, cr=cr)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nbits,n_tables,seed", [(8, 3, 0), (16, 4, 1)])
def test_lsh_codes_and_candidates_match(nbits, n_tables, seed):
    rng = np.random.default_rng(seed + 20)
    emb = rng.normal(size=(400, 24)).astype(np.float32)
    q = np.concatenate([emb[:10], rng.normal(size=(10, 24))]).astype(
        np.float32)
    ref = ref_bl.LSHIndex(emb, nbits=nbits, n_tables=n_tables, seed=seed)
    port = port_bl.LSHIndex(emb, nbits=nbits, n_tables=n_tables, seed=seed,
                            device="cpu")
    np.testing.assert_array_equal(port.planes, ref.planes)
    proj = np.einsum("tbd,nd->tnb", ref.planes.astype(np.float64),
                     emb.astype(np.float64))
    near = (np.abs(proj) < 1e-5).any(-1)                  # (T, N)
    assert ((port.codes == ref.codes) | near).all()
    q_proj = np.einsum("tbd,nd->tnb", ref.planes.astype(np.float64),
                       q.astype(np.float64))
    clear = ~(np.abs(q_proj) < 1e-5).any(-1).any(0)       # (B,)
    either = np.flatnonzero(near.any(0))          # objects of either bucket
    for i, (a, b) in enumerate(zip(port.candidates(q), ref.candidates(q))):
        if clear[i]:
            np.testing.assert_array_equal(np.setdiff1d(a, either),
                                          np.setdiff1d(b, either))
    assert clear.sum() >= len(q) - 1


@pytest.fixture(scope="module")
def retrievers():
    """Both packages' retrievers over one corpus with the same random
    relevance params and object embeddings (nothing trained)."""
    from repro.core import relevance as ref_rel
    cfg = tiny_cfg(compute_dtype="float32")
    rc, pc = corpora(n_objects=300, n_queries=60)
    with ref_on_cpu():
        ref = ref_pl.ListRetriever(cfg, rc)
        ref.rel_params = ref_rel.relevance_init(jax.random.PRNGKey(3), cfg)
        ref.obj_emb = np.asarray(ref_pl.embed_objects(ref.rel_params, rc, cfg))
    port = port_pl.ListRetriever(cfg, pc, device="cpu")
    port.rel = convert.relevance_from_numpy(
        jax.tree_util.tree_map(np.array, ref.rel_params), cfg)
    port.obj_emb = ref.obj_emb.copy()
    return ref, port


def test_score_fn_and_rerank_match(retrievers):
    """``score_fn`` scores within 1e-5 of the reference's, and the
    reranked IVF candidates and their mean count are equal."""
    ref, port = retrievers
    te = ref.corpus.split()[2]
    with ref_on_cpu():
        q_emb = np.asarray(ref_pl.embed_queries(ref.rel_params, ref.corpus,
                                                ref.cfg, te))
        ivf = ref_bl.IVFIndex(ref.obj_emb, n_clusters=4)
        cands = ivf.candidates(q_emb, cr=2)
        ref_fn = ref.score_fn()
    port_fn = port.score_fn()
    q_loc = ref.corpus.q_loc[te].astype(np.float32)
    for i in range(3):
        with ref_on_cpu():
            want = np.asarray(ref_fn(jnp.asarray(q_emb[i]),
                                     jnp.asarray(q_loc[i]), cands[i]))
        got = port_fn(q_emb[i], q_loc[i], cands[i])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    with ref_on_cpu():
        want_ids, want_n = ref_bl.rerank_candidates(
            lambda i, c: ref_fn(jnp.asarray(q_emb[i]), jnp.asarray(q_loc[i]),
                                c), cands, 10)
    got_ids, got_n = port_bl.rerank_candidates(
        lambda i, c: port_fn(q_emb[i], q_loc[i], c), cands, 10)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert got_n == want_n


def test_brute_force_matches_reference(retrievers):
    """``ListRetriever.brute_force`` over the retrievers' own embeddings:
    ids equal, scores within 1e-5."""
    ref, port = retrievers
    te = ref.corpus.split()[2]
    with ref_on_cpu():
        want = ref.brute_force(te, k=10, batch=8)
    got = port.brute_force(te, k=10, batch=8)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5)


# --- the baseline cases of tests/test_pipeline_e2e.py, on the port ---------


def test_kmeans_partitions(rng):
    x = np.concatenate([rng.normal(-5, 0.3, (50, 4)),
                        rng.normal(5, 0.3, (50, 4))]).astype(np.float32)
    cent, assign = port_bl.kmeans(x, 2, iters=10, device="cpu")
    a = assign.numpy()
    assert len(set(a[:50].tolist())) == 1
    assert len(set(a[50:].tolist())) == 1
    assert a[0] != a[-1]


def test_ivf_candidates_contain_near_neighbors(rng):
    emb = rng.normal(size=(400, 16)).astype(np.float32)
    ivf = port_bl.IVFIndex(emb, n_clusters=4, device="cpu")
    cands = ivf.candidates(emb[:10], cr=1)
    for i, c in enumerate(cands):
        assert i in c


def test_ivf_s_uses_spatial(rng):
    emb = rng.normal(size=(300, 8)).astype(np.float32)
    loc = np.concatenate([rng.uniform(0, 0.1, (150, 2)),
                          rng.uniform(0.9, 1.0, (150, 2))]).astype(np.float32)
    ivf = port_bl.IVFIndex(emb, loc, n_clusters=2, alpha=0.01, device="cpu")
    a = ivf.assign
    assert (a[:150] == a[0]).mean() > 0.9
    assert (a[150:] == a[150]).mean() > 0.9
    assert a[0] != a[150]


def test_lsh_self_retrieval(rng):
    emb = rng.normal(size=(200, 16)).astype(np.float32)
    lsh = port_bl.LSHIndex(emb, nbits=8, n_tables=3, device="cpu")
    cands = lsh.candidates(emb[:20])
    assert all(i in c for i, c in enumerate(cands))


def test_baselines_refuse_a_missing_card():
    """The entry points default to the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_bl.kmeans(np.zeros((4, 2), np.float32), 2)
    with pytest.raises(RuntimeError, match="cuda"):
        port_bl.LSHIndex(np.zeros((4, 2), np.float32))
