"""Carry the reference's parameter pytrees into the port's modules and back.

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

from repro_torch.core.index import ClusterIndex
from repro_torch.core.relevance import RelevanceModel
from repro_torch.models.layers import MLP, Dense, LayerNorm
from repro_torch.models.transformer import Encoder, EncoderBlock


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) \
        else x


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
                   compute_dtype=cfg.compute_dtype)


def params_from_numpy(rel_params, index_params, cfg
                      ) -> Tuple[RelevanceModel, ClusterIndex]:
    """→ ``(RelevanceModel, ClusterIndex)`` on the CPU, holding the same
    arrays as the reference's ``rel_params`` / ``index_params``."""
    o_enc = (encoder_from_numpy(rel_params["o_enc"], cfg)
             if "o_enc" in rel_params else None)
    rel = RelevanceModel(
        q_enc=encoder_from_numpy(rel_params["q_enc"], cfg), o_enc=o_enc,
        weight_mlp=_mlp(rel_params["weight_mlp"]),
        fixed_w=_t(rel_params["fixed_w"]),
        spatial={k: _t(v) for k, v in rel_params.get("spatial", {}).items()})
    return rel, index_from_numpy(index_params)


def index_from_numpy(index_params) -> ClusterIndex:
    """The cluster classifier of the reference's ``index_params``."""
    return ClusterIndex(_mlp(index_params["mlp"]))


def _dense_tree(m: Dense) -> dict:
    return {"w": m.w.data} if m.b is None else {"w": m.w.data,
                                                  "b": m.b.data}


def _norm_tree(m: LayerNorm) -> dict:
    return {"scale": m.scale.data, "bias": m.bias.data}


def encoder_to_tree(enc: Encoder) -> dict:
    """The reference's encoder pytree of ``enc``, blocks stacked."""
    blocks = [{"ln1": _norm_tree(b.ln1), "ln2": _norm_tree(b.ln2),
               "attn": {n: _dense_tree(getattr(b, n))
                        for n in ("wq", "wk", "wv", "wo")},
               "mlp": {"w1": _dense_tree(b.w1), "w2": _dense_tree(b.w2)}}
              for b in enc.blocks]
    return {"embed": enc.embed.data, "pos_embed": enc.pos_embed.data,
            "blocks": _stack(blocks),
            "final_ln": _norm_tree(enc.final_ln),
            "cls": _dense_tree(enc.cls)}


def params_to_tree(rel: RelevanceModel, index: ClusterIndex):
    """``(rel_params, index_params)`` in the reference's layout with the
    modules' own tensors as leaves, on their device (the per-layer blocks
    restacked: those leaves are new tensors)."""
    rp = {"q_enc": encoder_to_tree(rel.q_enc),
          "weight_mlp": [_dense_tree(m) for m in rel.weight_mlp.layers],
          "fixed_w": rel.fixed_w.data,
          "spatial": {k: v.data for k, v in rel.spatial.items()}}
    if rel.o_enc is not None:
        rp["o_enc"] = encoder_to_tree(rel.o_enc)
    return rp, {"mlp": [_dense_tree(m) for m in index.mlp.layers]}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
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
    return _to_numpy(rp), _to_numpy(ip)


def random_params(cfg, *, n_clusters: int, generator: torch.Generator,
                  with_o_enc: bool = True):
    """Random ``(rel_params, index_params)`` pytrees in the reference's
    layout and init scales (normal(0, 1/√fan_in) kernels, zero biases,
    unit norms), drawn from ``generator`` on the CPU."""
    def normal(*shape, scale):
        return torch.randn(*shape, generator=generator) * scale

    def dense(i, o):
        return {"w": normal(i, o, scale=i ** -0.5), "b": torch.zeros(o)}

    def mlp(dims):
        return [dense(dims[j], dims[j + 1]) for j in range(len(dims) - 1)]

    d = cfg.d_model

    def ln():
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}

    def block():
        return {"ln1": ln(), "ln2": ln(),
                "attn": {n: dense(d, d) for n in ("wq", "wk", "wv", "wo")},
                "mlp": {"w1": dense(d, cfg.d_ff), "w2": dense(cfg.d_ff, d)}}

    def encoder():
        return {"embed": normal(cfg.vocab_size, d, scale=d ** -0.5),
                "pos_embed": normal(cfg.max_len, d, scale=0.02),
                "blocks": _stack([block() for _ in range(cfg.n_layers)]),
                "final_ln": ln(),
                "cls": dense(d, d)}

    rel = {"q_enc": encoder(), "weight_mlp": mlp((d, 64, 2)),
           "fixed_w": torch.ones(2),
           "spatial": {"w_s": torch.full((cfg.spatial_t,), -2.0)
                       + 0.01 * torch.randn(cfg.spatial_t,
                                            generator=generator)}}
    if with_o_enc:
        rel["o_enc"] = encoder()
    index = {"mlp": mlp((d + 2,) + tuple(cfg.index_mlp_hidden)
                        + (n_clusters,))}
    return rel, index


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)
