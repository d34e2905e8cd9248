"""Carry the reference's parameter pytrees into the port's modules and back.

The LIST models (below) and the substrate's: ``lm_from_numpy`` /
``lm_to_numpy`` (the decoder LMs: the reference's ``periods`` / ``rem``
scan layout unstacked into one :class:`LMBlock` per layer and restacked),
``cache_from_numpy`` / ``cache_to_numpy`` (KV caches, ``{"main": {kind:
{"k", "v"}: (n_periods, n_k, B, T, KV, D)}, "rem": {kind: …: (n_k, B, T,
KV, D)} or None}`` against one ``{"k", "v"}`` per layer), and
``recsys_from_numpy`` / ``recsys_to_numpy`` (DLRM, xDeepFM, BERT4Rec and
MIND keep the reference's pytrees, tensors as leaves), and
``gnn_from_numpy`` / ``gnn_to_numpy`` (GatedGCN: the stacked ``blocks``
unstacked into one :class:`GatedGCNLayer` per layer and restacked).
:func:`param_tree` gives any of these models the reference's layout with
tensor leaves (meta ones for a model built on the meta device: the cell
plans' shape trees).

``rel_params`` / ``index_params`` are the nested dicts and lists the JAX
package trains and saves (``relevance.relevance_init``,
``index.index_init``), with numpy arrays (or CPU tensors) as leaves. The
encoder's layer stack is stored stacked along a leading ``n_layers`` axis;
it is unstacked into one :class:`EncoderBlock` per layer
(:func:`params_from_numpy`) and restacked on the way back
(:func:`params_to_numpy`). Dense kernels keep their ``(in, out)`` layout.
No array changes its values or dtype.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.index import ClusterIndex, index_init
from repro_torch.core.relevance import RelevanceModel, relevance_init
from repro_torch.models.gnn import GNN, GatedGCNLayer
from repro_torch.models.layers import MLP, Dense, LayerNorm, RMSNorm
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import (LM, Encoder, EncoderBlock,
                                            LMBlock, scan_structure)


def _t(x) -> torch.Tensor:
    """A leaf as a tensor, unchanged; a numpy bfloat16 array (ml_dtypes)
    comes across through its bits."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.as_tensor(a)


def _dense(p, i=None) -> Dense:
    pick = (lambda a: _t(a)) if i is None else (lambda a: _t(a)[i])
    return Dense(pick(p["w"]), pick(p["b"]) if "b" in p else None)


def _norm(p, eps, i=None) -> LayerNorm:
    pick = (lambda a: _t(a)) if i is None else (lambda a: _t(a)[i])
    return LayerNorm(pick(p["scale"]), pick(p["bias"]), eps=eps)


def _mlp(layers) -> MLP:
    return MLP([_dense(p) for p in layers])


def encoder_from_numpy(p, cfg) -> Encoder:
    blk = p["blocks"]
    n_layers = _t(blk["ln1"]["scale"]).shape[0]
    eps = cfg.norm_eps
    blocks = [EncoderBlock(
        _norm(blk["ln1"], eps, i), _norm(blk["ln2"], eps, i),
        _dense(blk["attn"]["wq"], i), _dense(blk["attn"]["wk"], i),
        _dense(blk["attn"]["wv"], i), _dense(blk["attn"]["wo"], i),
        _dense(blk["mlp"]["w1"], i), _dense(blk["mlp"]["w2"], i),
        n_heads=cfg.n_heads) for i in range(n_layers)]
    return Encoder(_t(p["embed"]), _t(p["pos_embed"]), blocks,
                   _norm(p["final_ln"], eps), _dense(p["cls"]),
                   compute_dtype=cfg.compute_dtype,
                   remat=getattr(cfg, "remat", False))


def relevance_from_numpy(rel_params, cfg) -> RelevanceModel:
    """The relevance model of the reference's ``rel_params``, on the CPU,
    holding the same arrays (trainable)."""
    o_enc = (encoder_from_numpy(rel_params["o_enc"], cfg)
             if "o_enc" in rel_params else None)
    return RelevanceModel(
        q_enc=encoder_from_numpy(rel_params["q_enc"], cfg), o_enc=o_enc,
        weight_mlp=_mlp(rel_params["weight_mlp"]),
        fixed_w=_t(rel_params["fixed_w"]),
        spatial={k: _t(v) for k, v in rel_params.get("spatial", {}).items()})


def params_from_numpy(rel_params, index_params, cfg
                      ) -> Tuple[RelevanceModel, ClusterIndex]:
    """→ ``(RelevanceModel, ClusterIndex)`` on the CPU, holding the same
    arrays as the reference's ``rel_params`` / ``index_params``."""
    return (relevance_from_numpy(rel_params, cfg),
            index_from_numpy(index_params))


def index_from_numpy(index_params) -> ClusterIndex:
    """The cluster classifier of the reference's ``index_params``."""
    return ClusterIndex(_mlp(index_params["mlp"]))


def _data(p: torch.Tensor) -> torch.Tensor:
    return p.data


def grad_or_zeros(p: torch.Tensor) -> torch.Tensor:
    """``p.grad``, or zeros like ``p`` for a parameter the loss never
    reached (the reference's gradient of an unused leaf)."""
    return torch.zeros_like(p) if p.grad is None else p.grad


def _dense_tree(m: Dense, leaf) -> dict:
    return ({"w": leaf(m.w)} if m.b is None
            else {"w": leaf(m.w), "b": leaf(m.b)})


def _norm_tree(m: LayerNorm, leaf) -> dict:
    return {"scale": leaf(m.scale), "bias": leaf(m.bias)}


def encoder_to_tree(enc: Encoder, leaf=_data, stack=torch.stack) -> dict:
    """The reference's encoder pytree of ``enc``, blocks stacked by
    ``stack``; each leaf is ``leaf(parameter)`` (the tensor itself by
    default)."""
    blocks = [{"ln1": _norm_tree(b.ln1, leaf), "ln2": _norm_tree(b.ln2, leaf),
               "attn": {n: _dense_tree(getattr(b, n), leaf)
                        for n in ("wq", "wk", "wv", "wo")},
               "mlp": {"w1": _dense_tree(b.w1, leaf),
                       "w2": _dense_tree(b.w2, leaf)}}
              for b in enc.blocks]
    return {"embed": leaf(enc.embed), "pos_embed": leaf(enc.pos_embed),
            "blocks": _stack(blocks, stack),
            "final_ln": _norm_tree(enc.final_ln, leaf),
            "cls": _dense_tree(enc.cls, leaf)}


def relevance_to_tree(rel: RelevanceModel, leaf=_data,
                      stack=torch.stack) -> dict:
    """``rel_params`` in the reference's layout, leaves ``leaf(p)``
    (``grad_or_zeros`` gives the gradient pytree)."""
    rp = {"q_enc": encoder_to_tree(rel.q_enc, leaf, stack),
          "weight_mlp": [_dense_tree(m, leaf) for m in rel.weight_mlp.layers],
          "fixed_w": leaf(rel.fixed_w),
          "spatial": {k: leaf(v) for k, v in rel.spatial.items()}}
    if rel.o_enc is not None:
        rp["o_enc"] = encoder_to_tree(rel.o_enc, leaf, stack)
    return rp


def index_to_tree(index: ClusterIndex, leaf=_data) -> dict:
    """``index_params`` in the reference's layout, leaves ``leaf(p)``."""
    return {"mlp": [_dense_tree(m, leaf) for m in index.mlp.layers]}


def params_to_tree(rel: RelevanceModel, index: ClusterIndex):
    """``(rel_params, index_params)`` in the reference's layout with the
    modules' own tensors as leaves, on their device (the per-layer blocks
    restacked: those leaves are new tensors)."""
    return relevance_to_tree(rel), index_to_tree(index)


def to_numpy(tree):
    """A pytree of tensors as numpy leaves on the host at their own dtypes
    (a bfloat16 leaf, which numpy cannot hold, stays a CPU tensor)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    if tree is None:
        return None
    t = tree.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy().copy()


def params_to_numpy(rel: RelevanceModel, index: ClusterIndex):
    """The inverse of :func:`params_from_numpy`: ``(rel_params,
    index_params)`` as the reference's pytrees on the host — per-layer
    blocks restacked along a leading ``n_layers`` axis, ``o_enc`` only
    when the model has one, ``spatial`` a dict — with numpy leaves at
    their own dtypes (a bfloat16 leaf, which numpy cannot hold, stays a
    CPU tensor)."""
    rp, ip = params_to_tree(rel, index)
    return to_numpy(rp), to_numpy(ip)


def random_params(cfg, *, n_clusters: int, generator: torch.Generator,
                  with_o_enc: bool = True):
    """Random ``(rel_params, index_params)`` pytrees in the reference's
    layout, drawn from ``generator`` on the CPU by the modules' own
    initializers (``relevance.relevance_init``, ``index.index_init``)."""
    rel = relevance_init(cfg, generator, with_o_enc=with_o_enc)
    index = index_init(cfg.d_model, n_clusters, generator,
                       hidden=cfg.index_mlp_hidden)
    detach = lambda p: p.detach()  # noqa: E731
    return relevance_to_tree(rel, detach), index_to_tree(index, detach)


def _stack(trees, stack=torch.stack):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], stack) for k in trees[0]}
    return stack(trees)


# ---------------------------------------------------------------------------
# The substrate: decoder LMs, their KV caches, the recsys models
# ---------------------------------------------------------------------------


def _layer_slots(cfg):
    """``(group, index)`` of every layer in pattern order: ``("periods",
    (i, j))`` for layer j of period i, ``("rem", (j,))`` for the
    remainder's layer j."""
    n, period, rem = scan_structure(cfg)
    return ([("periods", (i, j)) for i in range(n) for j in range(len(period))]
            + [("rem", (j,)) for j in range(len(rem))])


def _pick(tree, at):
    if isinstance(tree, dict):
        return {k: _pick(v, at) for k, v in tree.items()}
    return _t(tree)[at]


def lm_from_numpy(params, cfg) -> LM:
    """The :class:`LM` of the reference's ``lm_init`` pytree ``params``
    (numpy or CPU tensor leaves), on the CPU, one :class:`LMBlock` per
    layer; a MoE config's ``moe`` leaves (``router``, ``w1``, ``w3``,
    ``w2``) become the block's :class:`MoE`. No value or dtype
    changes."""
    blocks = []
    for (group, at), kind in zip(_layer_slots(cfg), cfg.pattern()):
        p = _pick(params[group], at)
        a = p["attn"]
        if "moe" in p:
            m = p["moe"]
            ffn = dict(moe=MoE(m["router"], m["w1"], m["w3"], m["w2"]))
        else:
            m = p["mlp"]
            ffn = dict(w1=_dense(m["w1"]), w3=_dense(m["w3"]),
                       w2=_dense(m["w2"]))
        blocks.append(LMBlock(
            RMSNorm(p["ln1"]["scale"], eps=cfg.norm_eps),
            RMSNorm(p["ln2"]["scale"], eps=cfg.norm_eps),
            _dense(a["wq"]), _dense(a["wk"]), _dense(a["wv"]),
            _dense(a["wo"]), kind=kind, **ffn))
    return LM(cfg, _t(params["embed"]), blocks,
              RMSNorm(_t(params["final_norm"]["scale"]), eps=cfg.norm_eps),
              None if cfg.tie_embeddings else _t(params["unembed"]))


def lm_to_tree(model: LM, leaf=_data, stack=torch.stack) -> dict:
    """The reference's ``lm_init`` pytree of ``model``, blocks restacked
    by ``stack`` to ``periods`` ``(n_periods, period, ...)`` and ``rem``
    ``(len(rem), ...)``; each leaf is ``leaf(parameter)``."""
    cfg = model.cfg
    n, period, rem = scan_structure(cfg)

    def block(b: LMBlock):
        out = {"ln1": {"scale": leaf(b.ln1.scale)},
               "ln2": {"scale": leaf(b.ln2.scale)},
               "attn": {k: _dense_tree(getattr(b, k), leaf)
                        for k in ("wq", "wk", "wv", "wo")}}
        if b.moe is not None:
            out["moe"] = {k: leaf(getattr(b.moe, k))
                          for k in ("router", "w1", "w3", "w2")}
        else:
            out["mlp"] = {k: _dense_tree(getattr(b, k), leaf)
                          for k in ("w1", "w3", "w2")}
        return out
    trees = [block(b) for b in model.blocks]
    plen = len(period)
    out = {"embed": leaf(model.embed),
           "periods": _stack([_stack(trees[i * plen:(i + 1) * plen], stack)
                              for i in range(n)], stack),
           "final_norm": {"scale": leaf(model.final_norm.scale)}}
    if rem:
        out["rem"] = _stack(trees[n * plen:], stack)
    if not cfg.tie_embeddings:
        out["unembed"] = leaf(model.unembed)
    return out


def lm_to_numpy(model: LM):
    """The inverse of :func:`lm_from_numpy`: :func:`lm_to_tree` on the
    host with numpy leaves (bfloat16 ones stay CPU tensors)."""
    return to_numpy(lm_to_tree(model))


def _kind_slots(cfg):
    """``(where, kind, at)`` of every layer's cache entry in the
    reference's layout: ``("main", kind, (i, ki))`` or ``("rem", kind,
    (ki,))``, ki the layer's index among its period's (or the
    remainder's) layers of that kind."""
    n, period, rem = scan_structure(cfg)

    def ki(pat, j):
        return sum(1 for k in pat[:j] if k == pat[j])
    return ([("main", period[j], (i, ki(period, j)))
             for i in range(n) for j in range(len(period))]
            + [("rem", rem[j], (ki(rem, j),)) for j in range(len(rem))])


def cache_from_numpy(cache, cfg) -> list:
    """The reference's KV-cache pytree (``lm_prefill``,
    ``make_decode_cache``) as the port's list of per-layer ``{"k",
    "v"}`` tensors on the CPU."""
    return [{kv: _t(cache[where][kind][kv])[at] for kv in ("k", "v")}
            for where, kind, at in _kind_slots(cfg)]


def cache_to_tree(cache, cfg):
    """The port's per-layer KV cache in the reference's layout (``"rem"``
    None without a remainder), the per-layer tensors stacked (a meta
    cache stacks to meta tensors)."""
    n, period, rem = scan_structure(cfg)
    slots = _kind_slots(cfg)
    out = {"main": {}, "rem": {} if rem else None}
    for kind in sorted(set(period)):
        out["main"][kind] = {kv: torch.stack([
            torch.stack([c[kv] for c, (w, k, at) in zip(cache, slots)
                         if w == "main" and k == kind and at[0] == i])
            for i in range(n)]) for kv in ("k", "v")}
    for kind in sorted(set(rem)):
        out["rem"][kind] = {kv: torch.stack(
            [c[kv] for c, (w, k, _) in zip(cache, slots)
             if w == "rem" and k == kind]) for kv in ("k", "v")}
    return out


def cache_to_numpy(cache, cfg):
    """The inverse of :func:`cache_from_numpy`: :func:`cache_to_tree`
    with numpy leaves on the host (bfloat16 ones stay CPU tensors)."""
    return to_numpy(cache_to_tree(cache, cfg))


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return _t(tree)


def recsys_from_numpy(params):
    """A recsys pytree (``dlrm_init``, ``xdeepfm_init``,
    ``bert4rec_init``, ``mind_init`` of either package) with CPU tensor
    leaves, unchanged; the port's recsys functions take it as it is."""
    return _tensors(params)


def recsys_to_numpy(params):
    """The inverse of :func:`recsys_from_numpy`: numpy leaves on the
    host."""
    return to_numpy(_tensors(params))


_GNN_DENSE = ("A", "B", "C", "U", "V")


def gnn_from_numpy(params, cfg) -> GNN:
    """The :class:`GNN` of the reference's ``gnn_init`` pytree ``params``
    (numpy or CPU tensor leaves), on the CPU: ``blocks``, stacked along a
    leading ``n_layers`` axis, unstacked into one layer each. No value or
    dtype changes."""
    blk = params["blocks"]
    eps = 1e-6                         # the reference's apply_norm default
    gnn_layers = [GatedGCNLayer(*(_dense(blk[k], i) for k in _GNN_DENSE),
                                _norm(blk["ln_h"], eps, i),
                                _norm(blk["ln_e"], eps, i))
                  for i in range(cfg.n_layers)]
    return GNN(cfg, _dense(params["node_in"]), _dense(params["edge_in"]),
               gnn_layers, _dense(params["readout"]))


def gnn_to_tree(model: GNN, leaf=_data, stack=torch.stack) -> dict:
    """The reference's ``gnn_init`` pytree of ``model``, the layers
    restacked by ``stack`` under ``blocks``; leaves ``leaf(parameter)``."""
    trees = [{**{k: _dense_tree(getattr(m, k), leaf) for k in _GNN_DENSE},
              "ln_h": _norm_tree(m.ln_h, leaf),
              "ln_e": _norm_tree(m.ln_e, leaf)} for m in model.layers]
    return {"node_in": _dense_tree(model.node_in, leaf),
            "edge_in": _dense_tree(model.edge_in, leaf),
            "blocks": _stack(trees, stack),
            "readout": _dense_tree(model.readout, leaf)}


def gnn_to_numpy(model: GNN):
    """The inverse of :func:`gnn_from_numpy`: :func:`gnn_to_tree` on the
    host with numpy leaves (bfloat16 ones stay CPU tensors)."""
    return to_numpy(gnn_to_tree(model))


def _map_leaves(tree, leaf):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(v, leaf) for v in tree]
    return None if tree is None else leaf(tree)


def param_tree(params, leaf=_data, stack=torch.stack):
    """Any of the port's parameter sets in the reference's layout, leaves
    ``leaf(parameter)``, stacked layers by ``stack``: a
    :class:`RelevanceModel`, :class:`ClusterIndex`, :class:`LM` or
    :class:`GNN`, or a recsys dict (its own layout). On meta parameters
    the result is a tree of meta tensors: the reference's
    ``jax.eval_shape`` of its init."""
    if isinstance(params, RelevanceModel):
        return relevance_to_tree(params, leaf, stack)
    if isinstance(params, ClusterIndex):
        return index_to_tree(params, leaf)
    if isinstance(params, LM):
        return lm_to_tree(params, leaf, stack)
    if isinstance(params, GNN):
        return gnn_to_tree(params, leaf, stack)
    if isinstance(params, dict):
        return _map_leaves(params, leaf)
    raise TypeError(f"param_tree: no reference layout for "
                    f"{type(params).__name__}")
