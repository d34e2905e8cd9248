"""Carry the reference's parameter pytrees over into the port's modules.

``rel_params`` / ``index_params`` are the nested dicts and lists the JAX
package trains and saves (``relevance.relevance_init``,
``index.index_init``), with numpy arrays (or CPU tensors) as leaves. The
encoder's layer stack is stored stacked along a leading ``n_layers`` axis;
it is unstacked into one :class:`EncoderBlock` per layer. Dense kernels
keep their ``(in, out)`` layout. No array changes its values or dtype.
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
    return rel, ClusterIndex(_mlp(index_params["mlp"]))


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
