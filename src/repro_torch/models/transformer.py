"""The bidirectional encoder of the dual-encoder towers (reference:
``repro.models.transformer.encoder_init`` / ``encoder_forward``).

BERT geometry: token + position embedding, ``n_layers`` pre-norm blocks
(LayerNorm → multi-head attention with a key padding mask → residual;
LayerNorm → GELU MLP → residual), a final LayerNorm and a tanh CLS head.
Activations run in ``cfg.compute_dtype`` (bf16 for ``list-dual-encoder``);
attention scores and the softmax run in float32, as the reference's
einsum attention does. No Pallas kernel sits on this path.

The forward is differentiable. The reference's ``cfg.remat`` (activation
rematerialisation) changes no value and is not ported: at the trainer's
batch (64 queries, 320 objects, 16 tokens) no activation memory calls
for it.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.models.layers import Dense, LayerNorm

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class EncoderBlock(nn.Module):
    def __init__(self, ln1: LayerNorm, ln2: LayerNorm, wq: Dense, wk: Dense,
                 wv: Dense, wo: Dense, w1: Dense, w2: Dense, *, n_heads: int):
        super().__init__()
        self.ln1, self.ln2 = ln1, ln2
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.w1, self.w2 = w1, w2
        self.n_heads = int(n_heads)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        h_heads = self.n_heads
        hd = d // h_heads
        h = self.ln1(x)
        q = self.wq(h).reshape(b, l, h_heads, hd)
        k = self.wk(h).reshape(b, l, h_heads, hd)
        v = self.wv(h).reshape(b, l, h_heads, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
        s = s.masked_fill(~mask[:, None, None, :], -1e30)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
        x = x + self.wo(o.reshape(b, l, d).to(x.dtype))
        h = self.ln2(x)
        return x + self.w2(nn.functional.gelu(self.w1(h), approximate="tanh"))


class Encoder(nn.Module):
    """``forward(tokens (B, L) int, mask (B, L) bool) -> (B, d) float32``."""

    def __init__(self, embed: torch.Tensor, pos_embed: torch.Tensor,
                 blocks: Sequence[EncoderBlock], final_ln: LayerNorm,
                 cls: Dense, *, compute_dtype: str):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.pos_embed = nn.Parameter(pos_embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_ln = final_ln
        self.cls = cls
        self.compute_dtype = torch_dtype(compute_dtype)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        l = tokens.shape[1]
        cdt = self.compute_dtype
        x = (self.embed[tokens.long()].to(cdt)
             + self.pos_embed[:l].to(cdt)[None])
        for blk in self.blocks:
            x = blk(x, mask)
        x = self.final_ln(x)
        return torch.tanh(self.cls(x[:, 0])).float()


def encoder_init(cfg, generator: torch.Generator) -> Encoder:
    """A fresh :class:`Encoder` of ``cfg``'s geometry at the reference's
    scales (``repro.models.transformer.encoder_init``): token embedding
    ``N(0, 1/d)``, positions ``N(0, 0.02²)``, every dense ``1/√fan_in``
    with a zero bias, unit LayerNorms. Draws, in order: the token and
    position tables, then per layer wq, wk, wv, wo, w1, w2, then the CLS
    head."""
    d, eps = cfg.d_model, cfg.norm_eps
    dtype = torch_dtype(cfg.param_dtype)
    embed = layers.normal(generator, (cfg.vocab_size, d), 1.0 / math.sqrt(d))
    pos_embed = layers.normal(generator, (cfg.max_len, d), 0.02)
    blocks = []
    for _ in range(cfg.n_layers):
        wq, wk, wv, wo = (layers.dense_init(generator, d, d, bias=True)
                          for _ in range(4))
        w1 = layers.dense_init(generator, d, cfg.d_ff, bias=True)
        w2 = layers.dense_init(generator, cfg.d_ff, d, bias=True)
        blocks.append(EncoderBlock(
            layers.norm_init(d, eps=eps), layers.norm_init(d, eps=eps),
            wq, wk, wv, wo, w1, w2, n_heads=cfg.n_heads))
    cls = layers.dense_init(generator, d, d, bias=True)
    enc = Encoder(embed, pos_embed, blocks, layers.norm_init(d, eps=eps), cls,
                  compute_dtype=cfg.compute_dtype)
    return enc.to(dtype)
