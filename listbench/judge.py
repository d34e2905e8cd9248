"""What decides ``correct``: the plain reference (``listbench/reference``)
works the index out again from the benchmark's inputs and judges the
answers the timed path gave.

Numbers compared (each against its limit in ``workloads/<cell>.json``):

* ``placement_mismatch``: objects the port placed against the spill
  walk's rule, by the reference's own routes of every object, and slots
  of the port's cluster buffers whose stored row, scale or location
  differs from the reference's rows of the objects placed there (exact:
  limit 0).
* ``bad_answers``: answers naming an id that is out of range, not placed,
  repeated, or from more clusters than ``cr`` (every answer of the
  window), or short of ``k`` ids while its routed clusters hold ``k``
  objects (the sample) (exact: limit 0).
* ``route_gap``: how far, in router logits, a cluster an answer's ids come
  from lies below the reference's ``cr``-th best cluster (not compared
  where ``cr`` is every cluster).
* ``score_gap``: the widest gap between a served score and the
  reference's score of the same object, over ``max(|reference|, 1)``.
* ``miss_gap``: the widest amount, in score units, by which an object of
  the reference's top-k over the answer's routes that the answer left out
  beats the answer's worst object by the reference's scores. The routes
  are the clusters its ids come from; where those are fewer than ``cr``,
  the best of their completions that lie within the route tolerance
  (``route_sets``): a route the answer shows nothing of is unknown, and a
  near tie there is the program's to break.

Answers are judged on a sample drawn from the seed once the window has
closed. The reference reads the program's buffers only to judge them.
"""
from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from listbench import inputs as inputs_lib
from listbench.reference import control, index as ref_index, model
from listbench.reference import score as ref_score

PAD_LOC = 1e6               # the location of a free slot
PLACEMENT_BLOCK = 8         # clusters compared at a time


class Reference:
    """The reference's view of one seed's index: normalizer, ŵ_s, the
    placement and each cluster's members, over the f32 object rows
    regenerated from the seed."""

    def __init__(self, cfg: dict, seed: int, device, placement=None):
        """``placement``: the port's ``ids (c, capacity)`` on ``device``,
        checked object by object against the walk's rule and, when it keeps
        the rule, taken as the walk's; without it the reference walks."""
        model.f32_products()
        t0 = time.perf_counter()
        self.times = {}
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.tree = inputs_lib.weights(cfg, seed, device)
        self.emb, self.loc = inputs_lib.objects(cfg, seed, device)
        with torch.no_grad():
            self.norm = model.normalizer(self.loc)
            self.w_hat = model.spatial_table(self.tree["rel"])
            routes = ref_index.object_routes(self.tree["index"], self.emb,
                                             self.loc, self.norm,
                                             cfg["spill"])
        self.times["route"] = time.perf_counter() - t0
        if placement is None:
            self.violations = 0
            self.ids = ref_index.place(routes.cpu().numpy(),
                                       n_clusters=cfg["n_clusters"],
                                       capacity=cfg["capacity"])
        else:
            with torch.no_grad():
                self.violations = ref_index.placement_violations(
                    routes, placement, capacity=cfg["capacity"])
            self.ids = placement.cpu().numpy()
        self.times["place"] = time.perf_counter() - t0
        ids_t = torch.from_numpy(self.ids).to(self.device)
        self.members = [row[row >= 0].long() for row in ids_t]
        cluster_of = np.full(cfg["n_objects"], -1, np.int64)
        for c, row in enumerate(self.ids):
            live = row[(row >= 0) & (row < cfg["n_objects"])]
            cluster_of[live] = c
        self.cluster_of = cluster_of
        self.times["index"] = time.perf_counter() - t0

    def rows(self, ids: torch.Tensor, tier: str):
        """Rows of object ``ids`` as ``tier`` stores them (a configured
        tier or a control tier), read back in f32, and their locations."""
        raw = self.emb[ids]
        if tier in control.LOWER_TIER.values():
            return control.tier_rows(raw, tier), self.loc[ids]
        return ref_index.tier_rows(raw, tier), self.loc[ids]

    def prefix(self, tok, msk, qloc, rnd=model.EXACT, block: int = 256):
        """→ ``(q (Q, d), w (Q, 2), logits (Q, c))`` f32 of host queries."""
        rel = self.tree["rel"]
        qs, ws, ls = [], [], []
        with torch.no_grad():
            for s in range(0, tok.shape[0], block):
                t = torch.from_numpy(tok[s:s + block]).to(self.device)
                m = torch.from_numpy(msk[s:s + block]).to(self.device)
                lq = torch.from_numpy(qloc[s:s + block]).to(self.device)
                q = model.encode(rel["q_enc"], t, m,
                                 n_heads=self.cfg["num_attention_heads"],
                                 eps=self.cfg["layer_norm_eps"], rnd=rnd)
                qs.append(q)
                ws.append(model.mixing_weights(rel, q))
                ls.append(model.router_logits(
                    self.tree["index"], model.features(q, lq, self.norm)))
        return torch.cat(qs), torch.cat(ws), torch.cat(ls)

    def placement_mismatch(self, buffers: dict) -> int:
        """Objects placed against the walk's rule (checked at set-up),
        and slots of the port's ``buffers`` whose id, stored row, scale or
        location differs from the reference's placement."""
        prec = self.cfg["precision"]
        ids_p = buffers["ids"]
        ids_r = torch.from_numpy(self.ids).to(ids_p.device)
        bad = self.violations + int((ids_p != ids_r).sum())
        c = ids_r.shape[0]
        with torch.no_grad():
            for s in range(0, c, PLACEMENT_BLOCK):
                e = min(s + PLACEMENT_BLOCK, c)
                idr = ids_r[s:e]
                live = idr >= 0
                at = idr.clamp(min=0).long()
                want, scale = ref_index.stored(self.emb[at], prec)
                want = torch.where(live[..., None], want,
                                   torch.zeros((), dtype=want.dtype,
                                               device=want.device))
                scale = torch.where(live, scale, torch.ones_like(scale))
                loc = torch.where(live[..., None], self.loc[at],
                                  torch.full((), PAD_LOC,
                                             device=want.device))
                row_bad = (buffers["emb"][s:e] != want).any(-1)
                row_bad |= buffers["scale"][s:e] != scale
                row_bad |= (buffers["loc"][s:e] != loc).any(-1)
                bad += int(row_bad.sum())
        return bad


def structural_bad(ref: Reference, ids, cr: int) -> int:
    """Answers ``ids (N, k)`` naming an id out of range or not placed, an
    id twice, or ids from more than ``cr`` clusters: the rules that need no
    score, checked on every answer."""
    ids = np.asarray(ids, np.int64)
    n = ref.cfg["n_objects"]
    live = ids >= 0
    bad = ((ids < -1) | (ids >= n)).any(1)
    cl = np.where(live & (ids < n), ref.cluster_of[np.clip(ids, 0, n - 1)],
                  -2)
    bad |= (live & (ids < n) & (cl < 0)).any(1)
    srt = np.sort(np.where(live, ids, -1), axis=1)
    bad |= ((np.diff(srt, axis=1) == 0) & (srt[:, 1:] >= 0)).any(1)
    cls = np.sort(cl, axis=1)
    distinct = ((np.diff(cls, axis=1) != 0) & (cls[:, 1:] >= 0)).sum(1) \
        + (cls[:, 0] >= 0)
    bad |= distinct > cr
    return int(bad.sum())


def sample_indices(n_answered: int, n: int, seed: int) -> np.ndarray:
    r = inputs_lib.rng(seed, inputs_lib.STREAM_SAMPLE)
    if n_answered <= n:
        return np.arange(n_answered)
    return np.sort(r.choice(n_answered, size=n, replace=False))


def control_answers(ref: Reference, tok, msk, qloc, *, k: int, cr: int):
    """The control's answers to host queries: the reference in fp8 and
    at the tier below, over the reference's placement."""
    q, w, logits = ref.prefix(tok, msk, qloc, rnd=control.FP8)
    routes = torch.sort(logits, dim=-1, descending=True,
                        stable=True).indices[:, :cr].tolist()
    tier = control.LOWER_TIER[ref.cfg["precision"]]
    lq = torch.from_numpy(qloc).to(ref.device)
    with torch.no_grad():
        s, i = ref_score.topk_over_clusters(
            routes, ref.members, lambda ids: ref.rows(ids, tier), q, lq, w,
            ref.w_hat, k=k, dist_max=ref.cfg["dist_max"])
    return i.cpu().numpy().astype(np.int64), s.cpu().numpy()


def route_sets(used, best, lg, cr: int, tol: float):
    """The route sets an answer from clusters ``used`` may have been
    scanned over: ``used`` completed to ``cr`` clusters with clusters of
    the reference's order ``best`` (logits ``lg``), every set whose worst
    logit is at most ``tol`` below the best logit it leaves out (the
    routes a program within the route tolerance could pick). Always holds
    the completion by the reference's own order."""
    need = cr - len(used)
    fill = [int(x) for x in best if x not in used][:max(need, 0)]
    sets = [list(used[:cr]) + fill]
    if need <= 0 or tol <= 0:
        return sets
    pool = [int(x) for x in best[:cr + 4] if x not in used]
    for extra in itertools.combinations(pool, need):
        cand = list(used) + list(extra)
        if sorted(cand) == sorted(sets[0]):
            continue
        chosen = set(cand)
        left = next(int(x) for x in best if int(x) not in chosen)
        if lg[cand].min() >= lg[left] - tol:
            sets.append(cand)
    return sets


def judge_answers(ref: Reference, tok, msk, qloc, ids, scores, *, k: int,
                  cr: int, route_tol: float = 0.0) -> dict:
    """The numbers of answers ``ids``, ``scores`` ``(Q, k)`` to host
    queries ``tok``, ``msk``, ``qloc``. ``route_tol`` is the route
    tolerance (the ``route_gap`` limit): an answer whose ids come from
    fewer than ``cr`` clusters is judged over the best of the route sets
    it could have been scanned over within it (``route_sets``)."""
    cfg = ref.cfg
    n, c = cfg["n_objects"], cfg["n_clusters"]
    prec = cfg["precision"]
    q, w, logits = ref.prefix(tok, msk, qloc)
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    best = order.indices.cpu().numpy()
    lg = logits.cpu().numpy()
    ids = np.asarray(ids, np.int64)
    scores = np.asarray(scores, np.float64)
    bad = 0
    route_gap = 0.0
    pairs = []                  # (query, route set) judged
    for i in range(ids.shape[0]):
        row = ids[i]
        valid = row[row >= 0]
        if (valid >= n).any() or len(set(valid.tolist())) < valid.size:
            bad += 1
            valid = valid[valid < n]
        used = sorted(set(ref.cluster_of[valid].tolist()) - {-1})
        if len(used) > cr:
            bad += 1
        if cr < c and used:
            thr = lg[i, best[i, cr - 1]]
            route_gap = max(route_gap, float(thr - lg[i, used].min()))
        sets = route_sets(used, best[i], lg[i], cr, route_tol)
        pairs += [(i, s_) for s_ in sets]
        if valid.size < k:
            held = sum(int(ref.members[x].numel()) for x in sets[0])
            if held >= k:
                bad += 1
    lq = torch.from_numpy(qloc).to(ref.device)
    at = torch.tensor([i for i, _ in pairs], device=ref.device)
    with torch.no_grad():
        top_s, top_i = ref_score.topk_over_clusters(
            [s_ for _, s_ in pairs], ref.members,
            lambda x: ref.rows(x, prec), q[at], lq[at], w[at], ref.w_hat,
            k=k, dist_max=cfg["dist_max"])
        got = torch.from_numpy(np.clip(ids, 0, n - 1)).to(ref.device)
        rows, o_loc = ref.rows(got.reshape(-1), prec)
        t = ref_score.st_pairs(q, lq, w, rows.reshape(*got.shape, -1),
                               o_loc.reshape(*got.shape, 2), ref.w_hat,
                               cfg["dist_max"]).cpu().numpy()
    top_s, top_i = top_s.cpu().numpy(), top_i.cpu().numpy()
    live = (ids >= 0) & (ids < n)
    gap = np.where(live, np.abs(scores - t) / np.maximum(np.abs(t), 1.0), 0)
    per_query = {}
    for j, (i, _) in enumerate(pairs):
        if not live[i].any():
            continue
        worst = t[i][live[i]].min()
        left_out = ~np.isin(top_i[j], ids[i]) & (top_i[j] >= 0)
        m = (max(float(top_s[j][left_out].max() - worst), 0.0)
             if left_out.any() else 0.0)
        if i not in per_query or m < per_query[i]:
            per_query[i] = m
    miss = max(per_query.values(), default=0.0)
    out = {"bad_answers": bad, "score_gap": float(gap.max()),
           "miss_gap": miss}
    if cr < c:
        out["route_gap"] = max(route_gap, 0.0)
    return out


def verdict(numbers: dict, limits: dict, failed: int):
    """→ ``(correct, checks)``: every number at most its limit and no
    request lost. ``checks`` maps each name to its value and limit."""
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in limits if name in numbers}
    missing = [name for name in limits if name not in numbers]
    ok = (not missing and failed == 0
          and all(v["value"] <= v["limit"] for v in checks.values()))
    checks["failed"] = {"value": failed, "limit": 0}
    return ok, checks
