"""The port's trainers against the reference, on the CPU at small sizes
(2 layers, d 32, ``spatial_t`` 50, float32 compute unless stated); the
build and its artifacts are ``test_torch_build.py``'s.

* the straight-through step, the contrastive loss (Eq. 8) in every
  spatial × weight mode and the MCL loss (Eq. 14): values and every
  gradient leaf at the reference's own params, converted;
* AdamW, Adafactor, global-norm clipping and the four schedules;
* the training batches and the draws of the classifier's batches;
* both minings (TkQ hard negatives, Eq. 13 pseudo-negatives);
* on the card: the losses and gradients against the CPU's.

Tolerances (stated per test): losses within 1e-5·max(1, |loss|); a
gradient leaf within 1e-4·max|g_ref| + 1e-7 (f32 sums in another order
through the towers); at bf16 compute the loss within 0.05 and each leaf's
cosine ≥ 0.99 (ROADMAP C 4's class); the optimizer rtol 1e-6, atol 1e-7.
The reference runs under ``jax.default_device(cpu)``.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro.core import index as ref_index
from repro.core import pipeline as ref_pipeline
from repro.core import pseudo_labels as ref_pl
from repro.core import relevance as ref_relevance
from repro.core import spatial as ref_spatial
from repro.optim import optimizers as ref_opt
from repro.optim import schedules as ref_sched
from repro_torch import convert
from repro_torch import optim as port_optim
from repro_torch.core import baselines as port_baselines
from repro_torch.core import index as port_index
from repro_torch.core import pipeline as port_pipeline
from repro_torch.core import pseudo_labels as port_pl
from repro_torch.core import relevance as port_relevance
from repro_torch.core import spatial as port_spatial
from repro_torch.device import full_f32_products

from test_torch_common import corpora, np_tree, ref_on_cpu, tiny_cfg

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
BF16_LOSS_ATOL, BF16_COSINE, BF16_ZERO = 0.05, 0.99, 1e-3
def port_rel(rel_params, cfg):
    return convert.relevance_from_numpy(np_tree(rel_params), cfg)


def leaves(tree):
    out, treedef = jax.tree_util.tree_flatten(tree)
    return [np.asarray(x, np.float32) for x in out], treedef


def key_bias_leaves(tree):
    """Positions of the key projections' biases (``attn/wk/b``), whose
    gradient is zero in exact arithmetic: the softmax cancels them."""
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {i for i, (path, _) in enumerate(paths)
            if [getattr(k, "key", None) for k in path[-3:]]
            == ["attn", "wk", "b"]}


def assert_grads_match(got_tree, want_tree):
    """Every leaf (matched by position in the reference's layout) within
    ``GRAD_RTOL·max|g_ref| + GRAD_ATOL``; a key bias's (zero in exact
    arithmetic) below ``GRAD_RTOL`` of the largest gradient on both
    sides."""
    got, gdef = leaves(got_tree)
    want, wdef = leaves(want_tree)
    assert gdef == wdef
    zero = key_bias_leaves(want_tree)
    g_max = max(float(np.abs(w).max(initial=0.0)) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        if i in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) <= GRAD_RTOL * g_max
            continue
        tol = GRAD_RTOL * float(np.abs(w).max(initial=0.0)) + GRAD_ATOL
        err = float(np.abs(g - w).max(initial=0.0))
        assert err <= tol, f"leaf {i} {w.shape}: |Δ| {err} > {tol}"


def hard_pool(corpus, seed=9):
    return np.random.default_rng(seed).integers(
        0, corpus.cfg.n_objects, (corpus.cfg.n_queries, 16))


# ---------------------------------------------------------------------------
# The straight-through step (Eq. 4)
# ---------------------------------------------------------------------------


def test_step_indicator_matches_reference():
    t = 50
    rng = np.random.default_rng(0)
    w_s = rng.normal(-1.0, 0.5, t).astype(np.float32)
    s_in = rng.uniform(size=(6, 7)).astype(np.float32)
    s_in[0, :5] = np.arange(5) / t                       # on a threshold
    g_out = rng.normal(size=s_in.shape).astype(np.float32)
    with ref_on_cpu():
        def f(w, s):
            out = ref_spatial.spatial_relevance_train({"w_s": w}, s, t=t)
            return jnp.sum(out * g_out), out
        (_, want), (gw, gs) = jax.value_and_grad(f, argnums=(0, 1),
                                                 has_aux=True)(
            jnp.asarray(w_s), jnp.asarray(s_in))
        want_ind = ref_spatial._step_indicator(
            jnp.asarray(s_in), ref_spatial.thresholds(t), 0.05)
    w_t = torch.tensor(w_s, requires_grad=True)
    s_t = torch.tensor(s_in, requires_grad=True)
    got = port_spatial.spatial_relevance_train(w_t, s_t)
    (got * torch.from_numpy(g_out)).sum().backward()
    ind = port_spatial.StepIndicator.apply(
        torch.from_numpy(s_in), port_spatial.thresholds(t), 0.05)
    np.testing.assert_array_equal(ind.numpy(), np.asarray(want_ind))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(gs), rtol=1e-5,
                               atol=1e-7)


def test_step_indicator_backward_is_the_sigmoid_surrogate():
    """In float64, the backward is the exact gradient of the relaxation
    ``σ((s − T)/tau)``: gradcheck a function whose value is the relaxation
    and whose gradient is the indicator's backward."""
    t, tau = 20, 0.05
    thr = port_spatial.thresholds(t).double()

    def surrogate(s):
        step = port_spatial.StepIndicator.apply(s, thr, tau)
        relaxed = torch.sigmoid((s[..., None] - thr) / tau)
        return step - step.detach() + relaxed.detach()

    s = torch.rand(3, 4, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(1))
    s.requires_grad_(True)
    assert torch.autograd.gradcheck(surrogate, (s,), eps=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The contrastive loss (Eq. 8) and the MCL loss (Eq. 14)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_corpora():
    return corpora()


def _contrastive(cfg, corpora_, spatial_mode, weight_mode, *, seed=3):
    ref_corpus, port_corpus = corpora_
    train_q = ref_corpus.split()[0]
    pool = hard_pool(ref_corpus)
    batch = ref_corpus.train_batch(4, 8, train_q, hard_negs=pool)
    assert port_corpus.train_batch(4, 8, train_q, hard_negs=pool)[
        "query_ids"].tolist() == batch["query_ids"].tolist()
    with ref_on_cpu():
        params = ref_relevance.relevance_init(
            jax.random.PRNGKey(seed), cfg, spatial_mode=spatial_mode,
            weight_mode=weight_mode)
        if spatial_mode == "exp":
            params["spatial"] = {"alpha": jnp.float32(0.3),
                                 "beta": jnp.float32(-0.2)}
        jb = {k: jnp.asarray(v) for k, v in batch.items()
              if k != "query_ids"}
        (loss, m), grads = jax.jit(jax.value_and_grad(
            lambda p, jb: ref_relevance.contrastive_loss(
                p, jb, cfg, spatial_mode=spatial_mode,
                weight_mode=weight_mode), has_aux=True))(params, jb)
    rel = port_rel(params, cfg)
    got, gm = port_relevance.contrastive_loss(
        rel, port_pipeline.batch_to(batch, "cpu"), spatial_mode=spatial_mode,
        weight_mode=weight_mode)
    got.backward()
    return (float(loss), float(m["acc"]), np_tree(grads), float(got),
            float(gm["acc"]), convert.to_numpy(convert.relevance_to_tree(
                rel, convert.grad_or_zeros)), shared_positives(batch))


def shared_positives(batch) -> int:
    """Rows whose positive is also another row's: its in-batch score ties
    the positive's exactly in the port (one arithmetic, the positive ranks
    first), while the reference's two arithmetics round either way."""
    key = np.concatenate([batch["pos_tokens"],
                          batch["pos_loc"].view(np.int32)], axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                               return_counts=True)
    return int((counts[inv.reshape(-1)] > 1).sum())


@pytest.mark.parametrize("weight_mode", ["mlp", "fixed"])
@pytest.mark.parametrize("spatial_mode", ["step", "linear", "exp"])
def test_contrastive_loss_matches_reference(train_corpora, spatial_mode,
                                            weight_mode):
    cfg = tiny_cfg(compute_dtype="float32")
    loss, acc, grads, got, got_acc, got_grads, shared = _contrastive(
        cfg, train_corpora, spatial_mode, weight_mode)
    assert abs(got - loss) <= LOSS_RTOL * max(1.0, abs(loss)), (got, loss)
    # acc equal, but for rows whose positive another row shares (an exact
    # tie in the port, won by the positive)
    assert 0 <= round((got_acc - acc) * 8) <= shared, (got_acc, acc, shared)
    assert_grads_match(got_grads, grads)


def test_contrastive_loss_bf16_compute(train_corpora):
    cfg = tiny_cfg(compute_dtype="bfloat16")
    loss, _, grads, got, _, got_grads, _ = _contrastive(
        cfg, train_corpora, "step", "mlp")
    assert abs(got - loss) <= BF16_LOSS_ATOL, (got, loss)
    got_l, _ = leaves(got_grads)
    want_l, _ = leaves(grads)
    # leaves whose true gradient is zero (fixed_w, unused; the key biases,
    # which the softmax cancels) hold rounding noise: both stay below
    # BF16_ZERO of the largest gradient
    floor = BF16_ZERO * max(float(np.abs(w).max(initial=0)) for w in want_l)
    zero = key_bias_leaves(grads)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        gn, wn = np.linalg.norm(g), np.linalg.norm(w)
        if i in zero or wn == 0:
            assert max(np.abs(g).max(initial=0), np.abs(w).max(initial=0)) \
                <= floor, i
            continue
        cos = float((g * w).sum() / (gn * wn))
        assert cos >= BF16_COSINE, f"leaf {i} {w.shape}: cosine {cos}"


@pytest.mark.parametrize("balance_weight", [0.5, 0.0])
def test_mcl_loss_matches_reference(balance_weight):
    d, c, m, b = 32, 6, 8, 10
    rng = np.random.default_rng(4)
    batch = {"q_feat": rng.normal(size=(b, d + 2)).astype(np.float32),
             "pos_feat": rng.normal(size=(b, d + 2)).astype(np.float32),
             "neg_feat": rng.normal(size=(b, m, d + 2)).astype(np.float32)}
    with ref_on_cpu():
        params = ref_index.index_init(jax.random.PRNGKey(5), d, c,
                                      hidden=(32,))
        (loss, met), grads = jax.jit(jax.value_and_grad(
            lambda p, b: ref_index.mcl_loss(p, b,
                                            balance_weight=balance_weight),
            has_aux=True))(params, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    index = convert.index_from_numpy(np_tree(params))
    got, gm = port_index.mcl_loss(
        index, {k: torch.from_numpy(v) for k, v in batch.items()},
        balance_weight=balance_weight)
    got.backward()
    loss = float(loss)
    assert abs(float(got) - loss) <= LOSS_RTOL * max(1.0, abs(loss))
    for k in ("s_pos", "s_neg"):
        np.testing.assert_allclose(float(gm[k]), float(met[k]), rtol=1e-5)
    assert_grads_match(convert.to_numpy(convert.index_to_tree(
        index, convert.grad_or_zeros)), np_tree(grads))


# ---------------------------------------------------------------------------
# The optimizer, clipping and schedules
# ---------------------------------------------------------------------------


def _opt_case(seed=6):
    rng = np.random.default_rng(seed)
    shapes = [(5, 3), (7,), (2, 3, 4), ()]
    params = [np.asarray(rng.normal(size=s), np.float32) for s in shapes]
    grads = [[np.asarray(rng.normal(size=s) * 3, np.float32) for s in shapes]
             for _ in range(3)]
    return params, grads


def test_adamw_matches_reference():
    """Three updates from equal params, state and gradients (the lr of a
    warmup schedule at steps 1..3)."""
    params, grads = _opt_case()
    lrs = [1e-2 * (s + 1) / 3 for s in range(3)]
    with ref_on_cpu():
        p = [jnp.asarray(x) for x in params]
        state = ref_opt.adamw_init(p)
        for g, lr in zip(grads, lrs):
            p, state = ref_opt.adamw_update([jnp.asarray(x) for x in g],
                                            state, p, lr)
    tp = [torch.tensor(x) for x in params]
    init, update = port_optim.make_optimizer("adamw")
    tstate = init(tp)
    for g, lr in zip(grads, lrs):
        update([torch.from_numpy(x) for x in g], tstate, tp, lr)
    assert tstate["step"] == 3
    for got, want in zip(tp, p):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    for key in ("m", "v"):
        for got, want in zip(tstate[key], state[key]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, grads = _opt_case()
    with ref_on_cpu():
        want, want_g = ref_opt.clip_by_global_norm(
            [jnp.asarray(x) for x in grads[0]], max_norm)
        want_n = ref_opt.global_norm([jnp.asarray(x) for x in grads[0]])
    got, got_g = port_optim.clip_by_global_norm(
        [torch.from_numpy(x) for x in grads[0]], max_norm)
    np.testing.assert_allclose(float(got_g), float(want_g), rtol=1e-6)
    np.testing.assert_allclose(
        float(port_optim.global_norm([torch.from_numpy(x)
                                      for x in grads[0]])),
        float(want_n), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


SCHEDULES = {
    "constant": lambda m: m.constant_lr(3e-3),
    "cosine": lambda m: m.cosine_schedule(3e-3, 40),
    "warmup_cosine": lambda m: m.linear_warmup_cosine(3e-3, 5, 40),
    "warmup_linear": lambda m: m.linear_warmup_linear_decay(3e-3, 5, 40),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    want_fn = SCHEDULES[name](ref_sched)
    got_fn = SCHEDULES[name](port_optim)
    with ref_on_cpu():
        want = [float(want_fn(jnp.int32(s))) for s in range(45)]
    got = [got_fn(s) for s in range(45)]
    assert all(isinstance(x, float) for x in got)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if name.startswith("warmup"):
        assert got[0] == 0.0


# ---------------------------------------------------------------------------
# Adafactor (tests/test_substrate.py's cases, and the port against the
# reference)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_descends_quadratic(name):
    """tests/test_substrate.py's case on the port: 200 steps at lr 5e-2
    take Σ w² + Σ m² below 5% of its start."""
    init, update = port_optim.make_optimizer(name, weight_decay=0.0)
    params = [torch.tensor([3.0, -2.0]), torch.ones((4, 6)) * 2]
    state = init(params)

    def loss(ps):
        return sum(torch.sum(p ** 2) for p in ps)
    l0 = float(loss(params))
    for _ in range(200):
        update([2 * p for p in params], state, params, 5e-2)
    assert float(loss(params)) < 0.05 * l0


def test_adafactor_state_is_factored():
    """tests/test_substrate.py's case on the port, and each state leaf of
    the reference's shape."""
    shapes = [(8, 16), (5,), (3, 4, 6), (1, 7), (9, 1)]
    params = [torch.ones(s) for s in shapes]
    init, _ = port_optim.make_optimizer("adafactor")
    state = init(params)
    v = state["v"]
    assert v[0]["vr"].shape == (8,) and v[0]["vc"].shape == (16,)
    assert v[1]["v"].shape == (5,)
    assert v[2]["vr"].shape == (3, 4) and v[2]["vc"].shape == (3, 6)
    n_state = sum(x.numel() for leaf in v for x in leaf.values())
    n_param = sum(p.numel() for p in params)
    assert n_state < 0.5 * n_param
    with ref_on_cpu():
        want = ref_opt.adafactor_init([jnp.ones(s) for s in shapes])
    assert state["step"] == 0
    for got, w in zip(v, want["v"]):
        assert set(got) == set(w)
        for key in w:
            assert tuple(got[key].shape) == w[key].shape
            assert got[key].dtype == torch.float32


def _adafactor_case():
    """Params of every state kind (factored 2-d and 3-d, a vector, a
    degenerate matrix) and three steps of gradients."""
    rng = np.random.default_rng(12)
    shapes = [(6, 10), (3, 4, 5), (7,), (1, 8)]
    params = [np.asarray(rng.normal(size=s), np.float32) for s in shapes]
    grads = [[np.asarray(rng.normal(size=s) * 3, np.float32)
              for s in shapes] for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adafactor_matches_reference(dtype, weight_decay):
    """Three updates from equal params and gradients (the lr of a warmup
    schedule at steps 1..3): f32 params and every state leaf at rtol
    1e-6; bf16 params within one rounding of the reference's (each
    update computed in f32 and cast back), the state at 1e-6."""
    params, grads = _adafactor_case()
    lrs = [1e-2 * (s + 1) / 3 for s in range(3)]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with ref_on_cpu():
        p = [jnp.asarray(x, jdt) for x in params]
        state = ref_opt.adafactor_init(p)
        for g, lr in zip(grads, lrs):
            p, state = ref_opt.adafactor_update(
                [jnp.asarray(x, jdt) for x in g], state, p, lr,
                weight_decay=weight_decay)
    tp = [torch.tensor(x).to(tdt) for x in params]
    init, update = port_optim.make_optimizer("adafactor",
                                             weight_decay=weight_decay)
    tstate = init(tp)
    for g, lr in zip(grads, lrs):
        update([torch.from_numpy(x).to(tdt) for x in g], tstate, tp, lr)
    assert tstate["step"] == 3
    for got, want in zip(tp, p):
        assert got.dtype == tdt
        want = np.asarray(jnp.asarray(want, jnp.float32))
        tol = (dict(rtol=1e-6, atol=1e-7) if dtype == "float32"
               else dict(rtol=2 ** -8, atol=0))
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
    for got, want in zip(tstate["v"], state["v"]):
        for key in want:
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# Batches and minings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hard", [True, False])
def test_train_batch_matches_reference(train_corpora, hard):
    ref_corpus, port_corpus = train_corpora
    train_q = ref_corpus.split()[0]
    pool = hard_pool(ref_corpus) if hard else None
    for step in range(4):
        want = ref_corpus.train_batch(step, 16, train_q, hard_negs=pool,
                                      b_neg=4)
        got = port_corpus.train_batch(step, 16, train_q, hard_negs=pool,
                                      b_neg=4)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def assert_ranked_equal(got, want, scores):
    """``got`` and ``want`` (B, k) ids equal at every rank whose scores
    differ: where they differ, both ids' ``scores`` (the reference's) are
    exactly equal."""
    for i in range(want.shape[0]):
        for r in np.flatnonzero(got[i] != want[i]):
            assert scores[i, got[i, r]] == scores[i, want[i, r]], (
                f"query {i} rank {r}: {got[i, r]} vs {want[i, r]} "
                f"(scores {scores[i, got[i, r]]} / {scores[i, want[i, r]]})")


def test_mine_tkq_negatives_matches_reference(train_corpora):
    ref_corpus, port_corpus = train_corpora
    qids = ref_corpus.split()[0]
    want = ref_pipeline.mine_tkq_negatives(ref_corpus, qids, pool=16)
    got = port_pipeline.mine_tkq_negatives(port_corpus, qids, pool=16,
                                           device="cpu")
    assert got.shape == want.shape and got.dtype == want.dtype
    bm = ref_baselines.BM25(ref_corpus.obj_doc,
                            vocab_size=ref_corpus.cfg.vocab_size)
    pbm = port_baselines.BM25(port_corpus.obj_doc,
                              vocab_size=port_corpus.cfg.vocab_size,
                              device="cpu")
    np.testing.assert_array_equal(pbm.idf, bm.idf)
    args = (ref_corpus.q_doc[qids], ref_corpus.q_loc[qids],
            ref_corpus.obj_loc)
    scores = ref_baselines.tkq_scores(bm, *args,
                                      dist_max=ref_corpus.dist_max)
    got_scores = port_baselines.tkq_scores(pbm, *args,
                                           dist_max=ref_corpus.dist_max)
    assert got_scores.dtype == torch.float64
    # the BM25 part bit-equal; the mix within a few float64 ulps: the CPU
    # build's vectorised sqrt is not correctly rounded
    np.testing.assert_array_equal(pbm.scores(args[0]).numpy(),
                                  bm.scores(args[0]))
    np.testing.assert_allclose(got_scores.numpy(), scores, rtol=1e-14,
                               atol=0)
    assert_ranked_equal(got, want, scores)
    for i, q in enumerate(qids):
        assert not np.isin(got[i], ref_corpus.positives[q]).any()


def test_mine_negatives_matches_reference(train_corpora):
    """Eq. 13 on the reference's params and seeded embeddings: ids equal at
    every rank not exactly tied, the window's scores allclose, positives
    excluded."""
    cfg = tiny_cfg(compute_dtype="float32")
    ref_corpus, _ = train_corpora
    qids = ref_corpus.split()[0][:40]
    rng = np.random.default_rng(8)
    q_emb = rng.normal(size=(len(qids), cfg.d_model)).astype(np.float32)
    obj_emb = rng.normal(size=(ref_corpus.cfg.n_objects, cfg.d_model)
                         ).astype(np.float32)
    q_loc = ref_corpus.q_loc[qids].astype(np.float32)
    obj_loc = ref_corpus.obj_loc.astype(np.float32)
    pos_mask = ref_corpus.positives_mask(qids)
    kw = dict(neg_start=200, neg_end=300, dist_max=ref_corpus.dist_max)
    with ref_on_cpu():
        params = ref_relevance.relevance_init(jax.random.PRNGKey(2), cfg)
        want = np.asarray(ref_pl.mine_negatives(
            params, cfg, jnp.asarray(q_emb), jnp.asarray(q_loc),
            jnp.asarray(obj_emb), jnp.asarray(obj_loc),
            pos_mask=jnp.asarray(pos_mask), **kw))
        scores = np.asarray(ref_relevance.score_corpus(
            params, jnp.asarray(q_emb), jnp.asarray(q_loc),
            jnp.asarray(obj_emb), jnp.asarray(obj_loc), cfg,
            dist_max=ref_corpus.dist_max, train=False))
    got = port_pl.mine_negatives(
        port_rel(params, cfg), torch.from_numpy(q_emb),
        torch.from_numpy(q_loc), torch.from_numpy(obj_emb),
        torch.from_numpy(obj_loc), pos_mask=pos_mask, batch_queries=16,
        **kw).numpy()
    assert got.shape == want.shape == (len(qids), 100)
    assert_ranked_equal(got, want, scores)
    np.testing.assert_allclose(np.take_along_axis(scores, got, 1),
                               np.take_along_axis(scores, want, 1),
                               rtol=1e-5, atol=1e-6)
    assert not np.take_along_axis(pos_mask, got, 1).any()


def test_cluster_index_batches_match_reference(train_corpora, monkeypatch):
    """The rows, positives and pseudo-negatives the classifier's trainer
    draws equal the reference's for the same seed. The reference's draws
    are read from the features its jitted step receives: its router
    features are coded with the row index in column 0."""
    cfg = tiny_cfg(compute_dtype="float32", neg_start=100, neg_end=150)
    ref_corpus, port_corpus = train_corpora
    seen = {"fb": []}
    real_jit, real_features = jax.jit, ref_index.build_features
    real_mine = ref_pl.mine_negatives

    class RecordingJax:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def jit(fn):
            jfn = real_jit(fn)

            def call(*args):
                if len(args) == 4 and isinstance(args[2], dict):
                    seen["fb"].append({k: np.asarray(v)
                                       for k, v in args[2].items()})
                return jfn(*args)
            return call

    def coded_features(emb, loc, norm):
        f = np.array(real_features(emb, loc, norm))
        f[:, 0] = np.arange(f.shape[0])
        return jnp.asarray(f)

    def recording_mine(*a, **k):
        seen["neg"] = np.asarray(real_mine(*a, **k))
        return seen["neg"]

    monkeypatch.setattr(ref_pipeline, "jax", RecordingJax())
    monkeypatch.setattr(ref_index, "build_features", coded_features)
    monkeypatch.setattr(ref_pl, "mine_negatives", recording_mine)
    obj_emb = np.random.default_rng(1).normal(
        size=(ref_corpus.cfg.n_objects, cfg.d_model)).astype(np.float32)
    with ref_on_cpu():
        params = ref_relevance.relevance_init(jax.random.PRNGKey(0), cfg)
        ref_pipeline.train_cluster_index(params, ref_corpus, cfg,
                                         obj_emb=obj_emb, steps=3, batch=8,
                                         seed=11, log_every=100)
    assert len(seen["fb"]) == 3
    draws = []
    real_draw = port_pipeline.draw_index_batch
    monkeypatch.setattr(port_pipeline, "draw_index_batch",
                        lambda *a, **k: draws.append(real_draw(*a, **k))
                        or draws[-1])
    port_pipeline.train_cluster_index(port_rel(params, cfg), port_corpus,
                                      cfg, obj_emb=obj_emb, steps=3, batch=8,
                                      seed=11, log_every=100)
    for fb, (rows, pos, cols) in zip(seen["fb"], draws):
        np.testing.assert_array_equal(fb["q_feat"][:, 0], rows)
        np.testing.assert_array_equal(fb["pos_feat"][:, 0], pos)
        np.testing.assert_array_equal(fb["neg_feat"][..., 0],
                                      seen["neg"][rows[:, None], cols])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_gradients_match_cpu(cuda_device, train_corpora):
    """The contrastive and MCL losses and every gradient leaf on the card
    against the same port code on the CPU, TF32 off, at the CPU tests'
    tolerances."""
    full_f32_products(cuda_device)
    cfg = tiny_cfg(compute_dtype="float32")
    port_corpus = train_corpora[1]
    batch = port_corpus.train_batch(2, 8, port_corpus.split()[0],
                                    hard_negs=hard_pool(port_corpus))
    rel = port_relevance.relevance_init(cfg, torch.Generator().manual_seed(0))
    index = port_index.index_init(cfg.d_model, 6,
                                  torch.Generator().manual_seed(1),
                                  hidden=(32,))
    rng = np.random.default_rng(3)
    fb = {"q_feat": rng.normal(size=(10, 34)), "pos_feat":
          rng.normal(size=(10, 34)), "neg_feat": rng.normal(size=(10, 8, 34))}
    out = {}
    for dev in ("cpu", cuda_device):
        r, ix = copy.deepcopy(rel).to(dev), copy.deepcopy(index).to(dev)
        loss, _ = port_relevance.contrastive_loss(
            r, port_pipeline.batch_to(batch, dev))
        loss.backward()
        mloss, _ = port_index.mcl_loss(ix, {
            k: torch.from_numpy(v).float().to(dev) for k, v in fb.items()})
        mloss.backward()
        out[str(dev)] = (float(loss), float(mloss), convert.to_numpy(
            convert.relevance_to_tree(r, convert.grad_or_zeros)),
            convert.to_numpy(convert.index_to_tree(ix,
                                                   convert.grad_or_zeros)))
    (cl, cm_, cg, cig), (gl, gm_, gg, gig) = out["cpu"], out[str(cuda_device)]
    assert abs(gl - cl) <= LOSS_RTOL * max(1.0, abs(cl))
    assert abs(gm_ - cm_) <= LOSS_RTOL * max(1.0, abs(cm_))
    assert_grads_match(gg, cg)
    assert_grads_match(gig, cig)
