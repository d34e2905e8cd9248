"""Step builders, input specs and shardings for every (arch × shape) cell
(reference: ``repro.launch.steps``), and the trainer's step: ``pad_up``,
``_train_step`` and ``_chunked_item_topk``, with the gradient
accumulation that ``launch.train`` shares with ``_train_step``.

``plan_cell(arch_id, shape_name, mesh)`` returns a :class:`CellPlan`:
``fn`` is the port's own function on concrete tensors (a training step,
``lm_prefill``, a recsys forward, ``dispatch_query_kernel``, ...);
``args`` has the reference's shapes and dtypes on the ``meta`` device
(the models built by their initializers through a
``layers.MetaGenerator``, the batches as meta tensors), so a full-size
plan allocates nothing, as the reference's ``jax.eval_shape`` does; the
caller materialises them to run ``fn``. ``in_shardings`` (and
``out_shardings``) are spec trees (``distributed.sharding``) in the
reference's layout: a model's parameter specs follow
``convert.param_tree`` (stacked layers; ``sharding.leaf_specs`` gives
each port parameter its own), a KV cache's ``convert.cache_to_tree``.
``mesh`` is a ``DeviceMesh`` or a ``launch.mesh.AbstractMesh``.

Sharding doctrine (the reference's):
  LM      params TP over "model" (heads/ffn/vocab/experts) + FSDP over dp;
          batch over dp; KV caches (B→dp, T→model) for full-attention
          layers, ring buffers replicated on tp.
  GNN     nodes/edges sharded over ALL axes.
  RecSys  embedding tables row-sharded over "model", batch over dp,
          candidate/item axes over "model".
  LIST    cluster buffers cluster-major over ALL axes; the query phase is
          expert-style dispatch (core/serving.py); mining is a sharded
          score + per-shard top-k merge.

A model's parameters are what its loss takes: an ``nn.Module`` (the LMs,
GatedGCN) or a nested dict of tensors (the recsys models). Its trainable
leaves are :func:`param_leaves`; gradients come from
``torch.autograd.grad`` over them, so on the card they flow through the
flash and dot twins' backward kernels (``FlashAttentionFn``,
``DotInteractionFn``). The optimizer updates the leaves in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import axis_names, axis_sizes
from repro_torch.optim import clip_by_global_norm, make_optimizer


def pad_up(x: int, m: int) -> int:
    return -(-x // m) * m


def param_leaves(params) -> List[torch.Tensor]:
    """The trainable tensors of ``params``: a module's parameters in its
    own order, or a nested dict's leaves in jax ``tree_flatten`` order."""
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return tree_leaves(params)


def _stacked(params) -> dict:
    """``{id(leaf): key}`` for the leaves the reference stacks: an LM's
    blocks by its scan (``periods``, all layers of the periods in one leaf
    a name, then ``rem``), a GNN's layers (``blocks``)."""
    keys = {}
    if not isinstance(params, nn.Module):
        return keys
    blocks = getattr(params, "blocks", None)
    if isinstance(blocks, nn.ModuleList):
        from repro_torch.models.transformer import scan_structure
        n, period, _ = scan_structure(params.cfg)
        for i, blk in enumerate(blocks):
            part = "periods" if i < n * len(period) else "rem"
            for name, p in blk.named_parameters():
                keys[id(p)] = (part, name)
    layers = getattr(params, "layers", None)
    if isinstance(layers, nn.ModuleList):
        for layer in layers:
            for name, p in layer.named_parameters():
                keys[id(p)] = ("blocks", name)
    return keys


def decay_mask(params) -> List[bool]:
    """Which :func:`param_leaves` AdamW decays, as the reference decides:
    a leaf of ``ndim ≥ 2`` in the reference's layout, where every leaf of
    a stacked LM block or GNN layer counts, its 1-D norm scales and biases
    too."""
    stacked = _stacked(params)
    return [p.ndim >= 2 or id(p) in stacked for p in param_leaves(params)]


def rms_groups(params) -> list:
    """One key per :func:`param_leaves` leaf: the reference's stacked leaf
    it belongs to, over which Adafactor takes its update's RMS, or its own
    index. (The port factors a leaf's second moment by the layer's own
    shape; the reference's stacked shape differs only for a 1-D leaf of a
    scan period longer than one layer, which no Adafactor config has.)"""
    stacked = _stacked(params)
    return [stacked.get(id(p), i) for i, p in enumerate(param_leaves(params))]


def make_update(optimizer: str, params) -> Callable:
    """``make_optimizer(optimizer)``'s update on ``params``' leaves as the
    reference lays them out: AdamW's weight decay on :func:`decay_mask`,
    Adafactor's RMS over :func:`rms_groups`."""
    _, update = make_optimizer(optimizer)
    if optimizer == "adamw":
        kw = {"decay": decay_mask(params)}
    else:
        kw = {"groups": rms_groups(params)}
    return lambda grads, state, leaves, lr: update(grads, state, leaves, lr,
                                                   **kw)


class StepSplit:
    """Marks the phases of a step: CUDA events on the card (read once the
    step has synchronised), the host clock on the CPU. :meth:`split` sums
    the time before each mark under the mark's name."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        self.marks = [("start", self._now())]

    def mark(self, name: str) -> None:
        self.marks.append((name, self._now()))

    def split(self) -> dict:
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out


def split_batch(batch: dict, n: int) -> List[dict]:
    """``n`` microbatches: every tensor of ``batch`` with a leading axis
    reshaped to ``(n, -1, ...)`` and sliced, as the reference reshapes its
    batch; scalars (a graph batch's ``n_graphs``) are kept."""
    split = {k: (v.reshape((n, -1) + tuple(v.shape[1:]))
                 if isinstance(v, torch.Tensor) and v.dim() else v)
             for k, v in batch.items()}
    return [{k: (v[i] if isinstance(v, torch.Tensor) and v.dim() else v)
             for k, v in split.items()} for i in range(n)]


def _detach(metrics: dict) -> dict:
    return {k: (v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in metrics.items()}


def loss_and_grads(loss_fn: Callable, params, batch: dict, *,
                   microbatch: int = 1, timer: Optional[StepSplit] = None):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``, one gradient per :func:`param_leaves` leaf (zeros for a
    leaf the loss does not reach; a leaf that does not require a gradient
    is switched to require one). With ``microbatch > 1`` the batch is
    split (:func:`split_batch`) and, as the reference accumulates: the
    gradients summed in f32 and divided by ``microbatch``, the loss the
    mean, the metrics the last microbatch's. ``timer`` is marked after
    each forward (``"forward"``) and backward (``"backward"``)."""
    leaves = param_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    mbs = [batch] if microbatch == 1 else split_batch(batch, microbatch)
    acc, loss_sum, metrics = None, None, {}
    for mb in mbs:
        loss, metrics = loss_fn(params, mb)
        if timer:
            timer.mark("forward")
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if microbatch == 1:
            acc, loss_sum = grads, loss.detach()
        elif acc is None:
            acc, loss_sum = [g.float() for g in grads], loss.detach().float()
        else:
            torch._foreach_add_(acc, [g.float() for g in grads])
            loss_sum = loss_sum + loss.detach().float()
        del grads, loss
        if timer:
            timer.mark("backward")
    if microbatch > 1:
        torch._foreach_div_(acc, float(microbatch))
        loss_sum = loss_sum / microbatch
    return loss_sum, _detach(metrics), acc


def _train_step(loss_fn: Callable, cfg, *, lr: float = 3e-4,
                clip: float = 1.0):
    """``(step, opt_init)``: ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` runs the loss and its gradients, clips them to a
    global norm of ``clip`` and applies ``make_optimizer(cfg.optimizer)``'s
    update in place; ``metrics`` gains ``grad_norm``. ``opt_init(params)``
    is the optimizer's state over :func:`param_leaves`. The update treats
    the leaves as the reference's stacked layout does (:func:`make_update`)."""
    opt_init, _ = make_optimizer(cfg.optimizer)

    def step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(loss_fn, params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip)
        make_update(cfg.optimizer, params)(grads, opt_state,
                                           param_leaves(params), lr)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return step, lambda params: opt_init(param_leaves(params))


def _chunked_item_topk(score_chunk: Callable, n_items: int, chunk: int,
                       k: int, batch: int):
    """Running top-k over item chunks (keeps the ``(B, V)`` logits
    virtual): ``score_chunk(ci) -> (B, chunk)`` scores of items ``ci·chunk
    ..``; returns ``(values (B, k) f32, ids (B, k) int32)``. Equal scores
    keep the earlier entry of ``[best so far, chunk]``, as
    ``jax.lax.top_k`` does."""
    n_chunks = n_items // chunk
    best_v = best_i = None
    for ci in range(n_chunks):
        s = score_chunk(ci).float()
        if best_v is None:
            best_v = torch.full((batch, k), -torch.inf, dtype=torch.float32,
                                device=s.device)
            best_i = torch.full((batch, k), -1, dtype=torch.int32,
                                device=s.device)
        ids = ci * chunk + torch.arange(chunk, dtype=torch.int32,
                                        device=s.device).expand_as(s)
        cat_v = torch.cat([best_v, s], dim=1)
        cat_i = torch.cat([best_i, ids], dim=1)
        order = torch.sort(cat_v, dim=1, descending=True,
                           stable=True).indices[:, :k]
        best_v = torch.gather(cat_v, 1, order)
        best_i = torch.gather(cat_i, 1, order)
    return best_v, best_i


# ---------------------------------------------------------------------------
# Cell plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellPlan:
    arch_id: str
    shape_name: str
    fn: Optional[Callable]
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any = None          # None: the layout is the caller's
    notes: str = ""
    skip: Optional[str] = None


def meta(shape, dtype) -> torch.Tensor:
    """A meta tensor: the shape and dtype of a plan's argument."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


I32, F32, BOOL = torch.int32, torch.float32, torch.bool


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------


def dp_axes(mesh):
    return tuple(n for n in axis_names(mesh) if n in ("pod", "data"))


def dp_size(mesh) -> int:
    s = 1
    for n in dp_axes(mesh):
        s *= axis_sizes(mesh)[n]
    return s


def tp_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def all_axes(mesh):
    return axis_names(mesh)


def all_size(mesh) -> int:
    s = 1
    for n in axis_sizes(mesh).values():
        s *= n
    return s


def batch_sharding(mesh, b: int, extra: int = 0) -> tuple:
    """The spec of a batch of ``b`` rows: rows over the dp axes when they
    divide ``b``, ``extra`` trailing dims replicated."""
    dp = dp_axes(mesh)
    lead = dp if (dp and b % dp_size(mesh) == 0) else None
    return sh.spec(lead, *([None] * extra))


def all_sharding(mesh, n: int, extra: int = 0) -> tuple:
    """The spec of ``n`` rows over every mesh axis when they divide it."""
    lead = all_axes(mesh) if n % all_size(mesh) == 0 else None
    return sh.spec(lead, *([None] * extra))


def _params_plan(mesh, params, rules):
    """``(reference-layout meta tree, its spec tree)`` of ``params``."""
    from repro_torch import convert
    shape_tree = convert.param_tree(params)
    with sh.axis_rules(sh.rules_for_mesh(mesh)):
        return shape_tree, sh.param_specs(shape_tree, rules)


def _opt_plan(mesh, shape_tree, pspecs, optimizer):
    with sh.axis_rules(sh.rules_for_mesh(mesh)):
        return sh.opt_state_specs(shape_tree, pspecs, optimizer)


def _train_plan(arch_id, shape, mesh, loss_fn, cfg, params, rules, batch,
                bsh, fn=None):
    """A training cell: ``(params, opt_state, batch)`` through
    :func:`_train_step` (or ``fn``, a wrapper of it)."""
    shape_tree, pspecs = _params_plan(mesh, params, rules)
    step, opt_init = _train_step(loss_fn, cfg)
    ospecs = _opt_plan(mesh, shape_tree, pspecs, cfg.optimizer)
    return CellPlan(arch_id, shape.name, fn(step) if fn else step,
                    (params, opt_init(params), batch), (pspecs, ospecs, bsh),
                    out_shardings=(pspecs, ospecs, None))


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------


def _lm_params_shape(cfg):
    from repro_torch.models import transformer as tf
    return tf.lm_init(cfg, device="meta")


def _cache_shardings(mesh, cache_tree, cfg, batch: int):
    """KV caches (the reference's layout), trailing dims (B, T, KV, HD):
    B→dp when divisible; T→model for full-length buffers; a window's ring
    buffer keeps T replicated (its in-place slot writes stay local)."""
    dp = dp_axes(mesh)
    tpn = tp_size(mesh)

    def leaf(_, x):
        b_ax = dp if (dp and batch % dp_size(mesh) == 0) else None
        t = x.shape[-3]
        is_ring = cfg.window_size and t == cfg.window_size
        t_ax = "model" if (not is_ring and tpn > 1 and t % tpn == 0) else None
        return sh.spec(*((None,) * (x.ndim - 4)), b_ax, t_ax, None, None)

    return sh.tree_map_with_path(leaf, cache_tree)


def plan_lm(arch_id: str, shape, mesh) -> CellPlan:
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    cfg = get_config(arch_id)
    b, s = shape.dims["global_batch"], shape.dims["seq_len"]
    params = _lm_params_shape(cfg)

    if shape.kind == "lm_train":
        return _train_plan(
            arch_id, shape, mesh, lambda p, batch: tf.lm_loss(p, batch), cfg,
            params, sh.LM_PARAM_RULES, {"tokens": meta((b, s + 1), I32)},
            {"tokens": batch_sharding(mesh, b, extra=1)})

    _, pspecs = _params_plan(mesh, params, sh.LM_PARAM_RULES)
    cache = tf.make_decode_cache(cfg, b, s, device="meta")
    csh = _cache_shardings(mesh, convert.cache_to_tree(cache, cfg), cfg, b)
    if shape.kind == "lm_prefill":
        def prefill(params, tokens):
            return tf.lm_prefill(params, tokens)

        return CellPlan(arch_id, shape.name, prefill,
                        (params, meta((b, s), I32)),
                        (pspecs, batch_sharding(mesh, b, extra=1)),
                        out_shardings=(batch_sharding(mesh, b, extra=1), csh))

    # lm_decode: one token against a seq_len cache
    def decode(params, cache, token, pos):
        return tf.lm_decode_step(params, cache, token, pos)

    return CellPlan(
        arch_id, shape.name, decode,
        (params, cache, meta((b, 1), I32), meta((b,), I32)),
        (pspecs, csh, batch_sharding(mesh, b, extra=1),
         batch_sharding(mesh, b)),
        out_shardings=(batch_sharding(mesh, b, extra=1), csh))


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------


def plan_gnn(arch_id: str, shape, mesh) -> CellPlan:
    from repro_torch.configs import get_config
    from repro_torch.models import gnn as gnn_lib
    cfg = get_config(arch_id)
    d = shape.dims
    batched = d.get("batched", False)
    sampled = d.get("sampled", False)
    n_classes = d.get("n_classes", 2)
    d_feat = d["d_feat"]

    if batched:
        n_graphs = d["batch"]
        n_nodes = pad_up(d["n_nodes"] * n_graphs, 512)
        n_edges = pad_up(d["n_edges"] * n_graphs, 512)
    elif sampled:
        seeds, (f1, f2) = d["batch_nodes"], d["fanout"]
        n_nodes = pad_up(seeds * (1 + f1 + f1 * f2), 512)
        n_edges = pad_up(seeds * f1 + seeds * f1 * f2, 512)
    else:
        n_nodes = pad_up(d["n_nodes"], 512)
        n_edges = pad_up(d["n_edges"], 512)

    params = gnn_lib.gnn_init(cfg, d_feat, n_classes,
                              d_edge_in=4 if batched else 0, device="meta")
    graph = {"x": meta((n_nodes, d_feat), F32),
             "edge_src": meta((n_edges,), I32),
             "edge_dst": meta((n_edges,), I32),
             "node_mask": meta((n_nodes,), BOOL),
             "edge_mask": meta((n_edges,), BOOL)}
    gsh = {"x": all_sharding(mesh, n_nodes, extra=1),
           "edge_src": all_sharding(mesh, n_edges),
           "edge_dst": all_sharding(mesh, n_edges),
           "node_mask": all_sharding(mesh, n_nodes),
           "edge_mask": all_sharding(mesh, n_edges)}
    fn = None
    if batched:
        n_graphs_p = pad_up(n_graphs, 512)
        graph.update({"edge_attr": meta((n_edges, 4), F32),
                      "graph_ids": meta((n_nodes,), I32),
                      "labels": meta((n_graphs_p,), F32),
                      "label_mask": meta((n_graphs_p,), F32)})
        gsh.update({"edge_attr": all_sharding(mesh, n_edges, extra=1),
                    "graph_ids": all_sharding(mesh, n_nodes),
                    "labels": all_sharding(mesh, n_graphs_p),
                    "label_mask": all_sharding(mesh, n_graphs_p)})

        def fn(step):
            # n_graphs is static: closed over, not an argument
            def step_b(params, opt_state, g):
                return step(params, opt_state, dict(g, n_graphs=n_graphs_p))
            return step_b
    else:
        graph.update({"edge_attr": None,
                      "labels": meta((n_nodes,), I32),
                      "label_mask": meta((n_nodes,), F32)})
        gsh.update({"edge_attr": None,
                    "labels": all_sharding(mesh, n_nodes),
                    "label_mask": all_sharding(mesh, n_nodes)})
    return _train_plan(arch_id, shape, mesh,
                       lambda p, g: gnn_lib.gnn_loss(p, g), cfg, params,
                       sh.GNN_PARAM_RULES, graph, gsh, fn)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------


def _recsys_model(cfg, mesh):
    """``(params on meta, loss_fn, fwd or None, batch_specs(b) ->
    (batch, specs))`` of a recsys config."""
    from repro_torch.models import recsys as rs
    model = cfg.model

    def rows(b, **keys):
        return ({k: meta((b,) + tail, dt) for k, (tail, dt) in keys.items()},
                {k: batch_sharding(mesh, b, extra=len(tail))
                 for k, (tail, _) in keys.items()})

    if model == "dlrm":
        return (rs.dlrm_init(cfg, device="meta"),
                lambda p, b: rs.dlrm_loss(p, b, cfg),
                lambda p, b: rs.dlrm_forward(p, b["dense"], b["sparse"], cfg),
                lambda b: rows(b, dense=((cfg.n_dense,), F32),
                               sparse=((cfg.n_sparse,), I32),
                               label=((), F32)))
    if model == "xdeepfm":
        return (rs.xdeepfm_init(cfg, device="meta"),
                lambda p, b: rs.xdeepfm_loss(p, b, cfg),
                lambda p, b: rs.xdeepfm_forward(p, b["sparse"], cfg),
                lambda b: rows(b, sparse=((cfg.n_sparse,), I32),
                               label=((), F32)))
    if model == "bert4rec":
        L, pm = cfg.seq_len, 20
        return (rs.bert4rec_init(cfg, device="meta"),
                lambda p, b: rs.bert4rec_loss(p, b, cfg), None,
                lambda b: rows(b, seq=((L,), I32), mask=((L,), BOOL),
                               mlm_pos=((pm,), I32), mlm_tgt=((pm,), I32),
                               mlm_mask=((pm,), F32)))
    if model == "mind":
        return (rs.mind_init(cfg, device="meta"),
                lambda p, b: rs.mind_loss(p, b, cfg), None,
                lambda b: rows(b, hist=((cfg.hist_len,), I32),
                               hist_mask=((cfg.hist_len,), BOOL),
                               target=((), I32)))
    raise ValueError(model)


def _drop(pair, *keys):
    for part in pair:
        for k in keys:
            part.pop(k)
    return pair


def plan_recsys(arch_id: str, shape, mesh) -> CellPlan:
    from repro_torch.configs import get_config
    from repro_torch.core.index import topk_stable
    from repro_torch.models import recsys as rs
    cfg = get_config(arch_id)
    d = shape.dims
    model = cfg.model
    params, loss_fn, fwd, batch_specs = _recsys_model(cfg, mesh)

    if shape.kind == "rec_train":
        batch, bsh = batch_specs(d["batch"])
        return _train_plan(arch_id, shape, mesh, loss_fn, cfg, params,
                           sh.REC_PARAM_RULES, batch, bsh)

    _, pspecs = _params_plan(mesh, params, sh.REC_PARAM_RULES)
    if shape.kind == "rec_serve":
        b = d["batch"]
        if model in ("dlrm", "xdeepfm"):
            batch, bsh = _drop(batch_specs(b), "label")
            return CellPlan(arch_id, shape.name, fwd, (params, batch),
                            (pspecs, bsh))
        # bert4rec / mind: user embedding + chunked top-k over all items
        chunk, k = 65536, 100
        n_items = pad_up(params["item_embed"].shape[0], chunk)

        def _padded_table(params):
            emb = params["item_embed"]
            return F.pad(emb, (0, 0, 0, n_items - emb.shape[0]))

        if model == "bert4rec":
            def serve(params, batch):
                u = rs.bert4rec_user_embedding(params, batch["seq"],
                                               batch["mask"], cfg)
                emb = _padded_table(params)

                def score_chunk(ci):
                    rows_ = emb[ci * chunk:(ci + 1) * chunk]
                    return (u @ rows_.T.to(u.dtype)).float()

                return _chunked_item_topk(score_chunk, n_items, chunk, k, b)
            batch, bsh = _drop(batch_specs(b), "mlm_pos", "mlm_tgt",
                               "mlm_mask")
        else:
            def serve(params, batch):
                u = rs.mind_interests(params, batch["hist"],
                                      batch["hist_mask"], cfg)  # (B, K, d)
                emb = _padded_table(params)

                def score_chunk(ci):
                    rows_ = emb[ci * chunk:(ci + 1) * chunk]
                    s = torch.einsum("bkd,cd->bkc", u, rows_.to(u.dtype))
                    return s.amax(dim=1).float()

                return _chunked_item_topk(score_chunk, n_items, chunk, k, b)
            batch, bsh = _drop(batch_specs(b), "target")
        return CellPlan(arch_id, shape.name, serve, (params, batch),
                        (pspecs, bsh))

    # retrieval: 1 query (or user) against n_candidates
    nc = pad_up(d["n_candidates"], all_size(mesh))
    k = 100
    if model in ("dlrm", "xdeepfm"):
        # CTR rankers score candidate ITEMS pointwise for one user
        # context: LIST-style retrieval does not apply; this cell is the
        # bulk pointwise scoring of 1M pairs
        def serve(params, batch):
            return topk_stable(fwd(params, batch), k)
        keys = (("dense", "sparse") if model == "dlrm" else ("sparse",))
        batch, bsh = batch_specs(nc)
        batch = {key: batch[key] for key in keys}
        bsh = {key: all_sharding(mesh, nc, extra=1) for key in keys}
        return CellPlan(arch_id, shape.name, serve, (params, batch),
                        (pspecs, bsh),
                        notes="pointwise CTR scoring (LIST inapplicable)")

    b = d["batch"]
    if model == "mind":
        def serve(params, hist, hist_mask, cand_ids):
            s = rs.mind_score_candidates(params, hist, hist_mask, cand_ids,
                                         cfg)
            return topk_stable(s, k)
        length = cfg.hist_len
    else:  # bert4rec
        def serve(params, seq, mask, cand_ids):
            u = rs.bert4rec_user_embedding(params, seq, mask, cfg)
            ce = rs.embedding_lookup(params["item_embed"], cand_ids)
            return topk_stable((u @ ce.T.to(u.dtype)).float(), k)
        length = cfg.seq_len
    args = (params, meta((b, length), I32), meta((b, length), BOOL),
            meta((nc,), I32))
    return CellPlan(arch_id, shape.name, serve, args,
                    (pspecs, sh.spec(None, None), sh.spec(None, None),
                     all_sharding(mesh, nc)))


# ---------------------------------------------------------------------------
# Dual encoder (the paper's own architecture)
# ---------------------------------------------------------------------------


def _de_params_shape(cfg):
    from repro_torch.core import relevance
    from repro_torch.models import layers
    with layers.meta_init() as g:
        return relevance.relevance_init(cfg, g)


def plan_dual_encoder(arch_id: str, shape, mesh) -> CellPlan:
    from repro_torch.configs import get_config
    from repro_torch.core import index as index_lib
    from repro_torch.core import pseudo_labels, relevance, serving
    from repro_torch.models import layers
    cfg = get_config(arch_id)
    d = shape.dims
    params = _de_params_shape(cfg)

    if shape.kind == "de_train":
        b, L, nneg = d["global_batch"], d["max_len"], d["hard_negs"]
        batch = {"q_tokens": meta((b, L), I32), "q_mask": meta((b, L), BOOL),
                 "q_loc": meta((b, 2), F32),
                 "pos_tokens": meta((b, L), I32),
                 "pos_mask": meta((b, L), BOOL),
                 "pos_loc": meta((b, 2), F32),
                 "neg_tokens": meta((b, nneg, L), I32),
                 "neg_mask": meta((b, nneg, L), BOOL),
                 "neg_loc": meta((b, nneg, 2), F32)}
        bsh = {k: batch_sharding(mesh, b, extra=v.ndim - 1)
               for k, v in batch.items()}
        return _train_plan(
            arch_id, shape, mesh,
            lambda p, batch: relevance.contrastive_loss(p, batch), cfg,
            params, sh.LM_PARAM_RULES, batch, bsh)

    _, pspecs = _params_plan(mesh, params, sh.LM_PARAM_RULES)
    if shape.kind == "de_encode":
        b, L = d["global_batch"], d["max_len"]

        def encode(params, tokens, mask):
            return relevance.encode_objects(params, tokens, mask)

        return CellPlan(
            arch_id, shape.name, encode,
            (params, meta((b, L), I32), meta((b, L), BOOL)),
            (pspecs, batch_sharding(mesh, b, extra=1),
             batch_sharding(mesh, b, extra=1)))

    if shape.kind == "list_serve":
        b = d["query_batch"]
        n_obj, c_real = d["n_objects"], d["n_clusters"]
        k = d["topk"]
        L, dm = cfg.max_len, cfg.d_model
        c = pad_up(c_real, all_size(mesh))          # padded cluster count
        cap = pad_up(int(n_obj / c_real * 1.5), 128)
        qcap = serving.query_capacity(b, c_real, cfg.cluster_route)
        with layers.meta_init() as g:
            index = index_lib.index_init(dm, c, g,
                                         hidden=cfg.index_mlp_hidden)
        replicate = ((r".*", (None,)),)
        _, ish = _params_plan(mesh, index, replicate)
        norm = {"lo": meta((2,), F32), "span": meta((2,), F32)}

        def serve(params, iparams, w_hat, norm, buf_emb, buf_loc, buf_ids,
                  q_tokens, q_mask, q_loc):
            return serving.dispatch_query_kernel(
                params, iparams, w_hat, norm, buf_emb, buf_loc, buf_ids,
                q_tokens, q_mask, q_loc, k=k, cr=cfg.cluster_route,
                dist_max=1.4142, capacity=qcap)

        # the 110M dual encoder is small next to the mesh: served pure-DP,
        # its params replicated and the query batch over ALL axes; only
        # the cluster dispatch and the top-k merge cross the network
        _, psh_rep = _params_plan(mesh, params, replicate)
        args = (params, index, meta((cfg.spatial_t,), F32), norm,
                meta((c, cap, dm), F32), meta((c, cap, 2), F32),
                meta((c, cap), I32), meta((b, L), I32), meta((b, L), BOOL),
                meta((b, 2), F32))
        insh = (psh_rep, ish, sh.spec(None),
                {"lo": sh.spec(None), "span": sh.spec(None)},
                all_sharding(mesh, c, extra=2), all_sharding(mesh, c, extra=2),
                all_sharding(mesh, c, extra=1),
                all_sharding(mesh, b, extra=1),
                all_sharding(mesh, b, extra=1),
                all_sharding(mesh, b, extra=1))
        return CellPlan(arch_id, shape.name, serve, args, insh,
                        notes=f"c={c} cap={cap} qcap={qcap} dp-encoder")

    if shape.kind == "list_mine":
        b = d["query_batch"]
        n_obj = pad_up(d["n_objects"], all_size(mesh))
        ns_, ne_ = d["neg_start"], d["neg_end"]
        dm = cfg.d_model
        shards = all_size(mesh)

        def mine(params, q_emb, q_loc, obj_emb, obj_loc):
            return pseudo_labels.mine_negatives_dense(
                params, q_emb, q_loc, obj_emb, obj_loc, neg_start=ns_,
                neg_end=ne_, dist_max=1.4142, shards=shards)

        args = (params, meta((b, dm), F32), meta((b, 2), F32),
                meta((n_obj, dm), F32), meta((n_obj, 2), F32))
        insh = (pspecs, batch_sharding(mesh, b, extra=1),
                batch_sharding(mesh, b, extra=1),
                all_sharding(mesh, n_obj, extra=1),
                all_sharding(mesh, n_obj, extra=1))
        return CellPlan(arch_id, shape.name, mine, args, insh)

    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def plan_cell(arch_id: str, shape_name: str, mesh, *,
              dims: Optional[dict] = None) -> CellPlan:
    """The plan of one (arch × shape) cell on ``mesh``; ``dims`` replaces
    entries of the shape's dims (a batch cut to what one card runs, say),
    the rest of the plan built as for the registered shape."""
    from repro_torch.configs import get_config, get_shape
    cfg = get_config(arch_id)
    shape = get_shape(arch_id, shape_name)
    if dims:
        shape = dataclasses.replace(shape, dims={**shape.dims, **dims})
    if shape.skip:
        return CellPlan(arch_id, shape_name, None, (), (), skip=shape.skip)
    fam = cfg.family
    if fam == "lm":
        return plan_lm(arch_id, shape, mesh)
    if fam == "gnn":
        return plan_gnn(arch_id, shape, mesh)
    if fam == "recsys":
        return plan_recsys(arch_id, shape, mesh)
    if fam == "dual_encoder":
        return plan_dual_encoder(arch_id, shape, mesh)
    raise ValueError(fam)
