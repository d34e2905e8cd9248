"""Decoder LMs and the bidirectional encoder of the dual-encoder towers
(reference: ``repro.models.transformer``).

**Decoder LMs** (dense, GQA, RoPE, QKV bias, the sliding-window hybrid):
``lm_init``, ``lm_forward``, ``lm_loss``, ``lm_prefill``,
``lm_decode_step`` and ``make_decode_cache``. The reference scans its
layers in periods (``scan_structure``) so a hybrid pattern stays static
in the scan body; the port keeps one :class:`LMBlock` per layer, in the
pattern's order, and ``convert.lm_from_numpy`` / ``lm_to_numpy`` unstack
and restack the reference's ``periods`` / ``rem`` layout. Every
full-sequence attention of a block on the card launches the flash twin
(``layers.attention_full`` / ``attention_local_banded``); decode attends
in plain torch, as the reference does. The KV cache is a list with one
``{"k", "v"}`` dict per layer, ``(B, T, KV, D)`` each: a global layer
keeps ``T`` = the cache length, a local one a ring of ``window`` slots.
``lm_decode_step`` writes the new token's slot in place (the reference
returns a new pytree; at a 32k cache a copy per step would double the
cache). A MoE config's blocks hold a :class:`~repro_torch.models.moe.MoE`
in place of the dense MLP (``models/moe.py``): the prefill groups its
tokens by sequence, decode by batch, and ``lm_forward`` sums each
layer's ``aux`` (the load-balance and z losses, ``drop_fraction``) over
the layers, as the reference does.

**The encoder**: ``encoder_init`` / ``Encoder``.

BERT geometry: token + position embedding, ``n_layers`` pre-norm blocks
(LayerNorm → multi-head attention with a key padding mask → residual;
LayerNorm → GELU MLP → residual), a final LayerNorm and a tanh CLS head.
Activations run in ``cfg.compute_dtype`` (bf16 for ``list-dual-encoder``);
attention scores and the softmax run in float32, as the reference's
einsum attention does. No Pallas kernel sits on this path.

The forward is differentiable. ``lm_forward`` and :class:`Encoder` honour
the config's ``cfg.remat`` as the reference's
``jax.checkpoint(nothing_saveable)`` does (``_maybe_remat``, used by both
the LM's scan and ``encoder_forward``): while autograd records, each
block runs under ``torch.utils.checkpoint`` (non-reentrant), which keeps
only the block's input and recomputes the rest in the backward; the
values and gradients are the same (bit for bit on the CPU). Under
``torch.no_grad`` (serving, encoding a corpus) nothing is checkpointed.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import require_device
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import Dense, LayerNorm, RMSNorm

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
    """``forward(tokens (B, L) int, mask (B, L) bool) -> (B, d) float32``.
    With ``remat`` (the config's ``cfg.remat``) and autograd recording,
    each block is checkpointed: its activations are recomputed in the
    backward instead of kept."""

    def __init__(self, embed: torch.Tensor, pos_embed: torch.Tensor,
                 blocks: Sequence[EncoderBlock], final_ln: LayerNorm,
                 cls: Dense, *, compute_dtype: str, remat: bool = False):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.pos_embed = nn.Parameter(pos_embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_ln = final_ln
        self.cls = cls
        self.compute_dtype = torch_dtype(compute_dtype)
        self.remat = bool(remat)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        l = tokens.shape[1]
        cdt = self.compute_dtype
        x = (self.embed[tokens.long()].to(cdt)
             + self.pos_embed[:l].to(cdt)[None])
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            x = (checkpoint(blk, x, mask, use_reentrant=False) if remat
                 else blk(x, mask))
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
            layers.norm_init(d, kind="layer", eps=eps),
            layers.norm_init(d, kind="layer", eps=eps),
            wq, wk, wv, wo, w1, w2, n_heads=cfg.n_heads))
    cls = layers.dense_init(generator, d, d, bias=True)
    enc = Encoder(embed, pos_embed, blocks,
                  layers.norm_init(d, kind="layer", eps=eps), cls,
                  compute_dtype=cfg.compute_dtype,
                  remat=getattr(cfg, "remat", False))
    return enc.to(dtype)


# ---------------------------------------------------------------------------
# Decoder LMs
# ---------------------------------------------------------------------------


def scan_structure(cfg) -> Tuple[int, Tuple[str, ...], Tuple[str, ...]]:
    """``(n_periods, period_pattern, remainder_pattern)`` of the
    reference's layer scan: the pattern is ``period * n_periods +
    remainder``."""
    pat = cfg.pattern()
    if all(k == pat[0] for k in pat):
        return len(pat), (pat[0],), ()
    # the smallest period that tiles a prefix, leaving a remainder
    for plen in range(2, len(pat) + 1):
        period = pat[:plen]
        n = len(pat) // plen
        if n >= 1 and pat[: n * plen] == period * n:
            rem = pat[n * plen:]
            if not rem or len(rem) < plen:
                return n, period, rem
    return len(pat), (pat[0],), ()  # unreachable


class LMBlock(nn.Module):
    """One decoder layer: RMS norm → GQA attention with RoPE → residual;
    RMS norm → SwiGLU MLP (``w2(silu(w1 h) · w3 h)``) or, given ``moe``,
    the MoE (``moe_lib.moe_apply``) → residual. ``kind`` is ``"G"``
    (global) or ``"L"`` (local, window-limited)."""

    def __init__(self, ln1: RMSNorm, ln2: RMSNorm, wq: Dense, wk: Dense,
                 wv: Dense, wo: Dense, w1: Optional[Dense] = None,
                 w3: Optional[Dense] = None, w2: Optional[Dense] = None, *,
                 kind: str, moe: Optional[moe_lib.MoE] = None):
        super().__init__()
        if (moe is None) == (w1 is None or w3 is None or w2 is None):
            raise ValueError("a block holds the dense MLP (w1, w3, w2) or "
                             "a MoE, not both")
        self.ln1, self.ln2 = ln1, ln2
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.w1, self.w3, self.w2 = w1, w3, w2
        self.moe = moe
        self.kind = kind

    def ffn(self, h: torch.Tensor, cfg) -> Tuple[torch.Tensor, dict]:
        """The feed-forward half on the normed ``h`` → ``(out, aux)``:
        the MoE with ``cfg.moe`` (its routing group from h's shape), or
        the dense MLP with zero aux."""
        if self.moe is not None:
            return moe_lib.moe_apply(self.moe, h, cfg.moe)
        return (self.w2(layers.silu(self.w1(h)) * self.w3(h)),
                _zero_aux(h.device))


class LM(nn.Module):
    """A decoder LM of ``cfg``: token embedding ``(V, d)``, one
    :class:`LMBlock` per layer of ``cfg.pattern()``, a final RMS norm and
    an unembedding ``(d, V)`` (``embed.T`` when tied)."""

    def __init__(self, cfg, embed: torch.Tensor, blocks: Sequence[LMBlock],
                 final_norm: RMSNorm, unembed: Optional[torch.Tensor]):
        super().__init__()
        if [b.kind for b in blocks] != list(cfg.pattern()):
            raise ValueError("the blocks' kinds do not follow cfg.pattern()")
        if any((b.moe is not None) != cfg.is_moe for b in blocks):
            raise ValueError("a MoE config's blocks hold MoEs, a dense "
                             "config's dense MLPs")
        if (unembed is None) != bool(cfg.tie_embeddings):
            raise ValueError("an unembedding is given iff the embeddings "
                             "are not tied")
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.unembed = None if unembed is None else nn.Parameter(unembed)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _block_init(generator, cfg, kind, dtype) -> LMBlock:
    """One layer in ``dtype``, each dense drawn in float32 and cast as it
    is drawn; a MoE's router stays float32 (``moe_lib.moe_init``)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bias, dev = cfg.qkv_bias, generator.device

    def dense(i, o, **kw):
        return layers.dense_init(generator, i, o, **kw).to(dtype)
    wq = dense(d, h * hd, bias=bias)
    wk = dense(d, kv * hd, bias=bias)
    wv = dense(d, kv * hd, bias=bias)
    wo = dense(h * hd, d)
    norms = [layers.norm_init(d, eps=cfg.norm_eps, device=dev).to(dtype)
             for _ in range(2)]
    if cfg.is_moe:
        return LMBlock(*norms, wq, wk, wv, wo, kind=kind,
                       moe=moe_lib.moe_init(generator, d, cfg.moe,
                                            dtype=dtype))
    w1 = dense(d, cfg.d_ff)
    w3 = dense(d, cfg.d_ff)
    w2 = dense(cfg.d_ff, d)
    return LMBlock(*norms, wq, wk, wv, wo, w1, w3, w2, kind=kind)


def lm_init(cfg, *, seed: int = 0, device="cuda") -> LM:
    """A fresh :class:`LM` of ``cfg`` at the reference's scales
    (``repro.models.transformer.lm_init``): embedding and unembedding
    ``N(0, 1/d)``, every dense kernel ``1/√fan_in`` (zero QKV biases when
    ``cfg.qkv_bias``), unit RMS norms, in ``cfg.param_dtype``. Drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``: the
    embedding, then per layer wq, wk, wv, wo and w1, w3, w2 (a MoE
    config: the router, then the expert stacks ``moe_lib.moe_init``),
    then the unembedding. The MoE's router stays float32."""
    dev = require_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    g = layers.make_generator(seed, dev)
    d = cfg.d_model
    embed = layers.normal(g, (cfg.vocab_size, d),
                          1.0 / math.sqrt(d)).to(dtype)
    blocks = [_block_init(g, cfg, kind, dtype) for kind in cfg.pattern()]
    unembed = (None if cfg.tie_embeddings else
               layers.normal(g, (d, cfg.vocab_size),
                             1.0 / math.sqrt(d)).to(dtype))
    return LM(cfg, embed, blocks,
              layers.norm_init(d, eps=cfg.norm_eps, device=dev).to(dtype),
              unembed)


def _qkv(blk: LMBlock, x, cfg, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = blk.wq(x).reshape(b, s, h, hd)
    k = blk.wk(x).reshape(b, s, kv, hd)
    v = blk.wv(x).reshape(b, s, kv, hd)
    q = layers.rope(q, positions, theta=cfg.rope_theta)
    k = layers.rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _block_full(blk: LMBlock, x, cfg, *, return_cache=False, cache_len=0):
    """The train / prefill path of one layer. ``x (B, S, d)`` →
    ``(x', aux, cache or None)``."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    h = blk.ln1(x)
    q, k, v = _qkv(blk, h, cfg, positions)
    local = blk.kind == "L" and cfg.window_size > 0
    if local and s > cfg.window_size and s % cfg.window_size == 0:
        o = layers.attention_local_banded(q, k, v, window=cfg.window_size)
    else:
        o = layers.attention_full(q, k, v, causal=True,
                                  window=cfg.window_size if local else 0,
                                  chunk=min(cfg.attn_chunk, s))
    x = x + blk.wo(o.reshape(b, s, -1))
    m, aux = blk.ffn(blk.ln2(x), cfg)
    x = x + m
    cache = None
    if return_cache:
        if local:
            w = cfg.window_size
            last = min(s, w)
            slots = torch.arange(s - last, s, device=x.device) % w
            kc = k.new_zeros((b, w) + k.shape[2:])
            vc = v.new_zeros((b, w) + v.shape[2:])
            kc[:, slots] = k[:, s - last:]
            vc[:, slots] = v[:, s - last:]
        else:
            pad = (0, 0, 0, 0, 0, cache_len - s)
            kc = nn.functional.pad(k, pad)
            vc = nn.functional.pad(v, pad)
        cache = {"k": kc, "v": vc}
    return x, aux, cache


def _block_decode(blk: LMBlock, x, cache, pos, cfg):
    """The decode path of one layer: ``x (B, 1, d)``, ``pos (B,)`` the
    new token's absolute position. Writes its slot of ``cache`` in place:
    ``pos % T`` in a local layer's ring, ``min(pos, T - 1)`` in a global
    layer."""
    b = x.shape[0]
    local = blk.kind == "L" and cfg.window_size > 0
    h = blk.ln1(x)
    q, k, v = _qkv(blk, h, cfg, pos[:, None])
    t = cache["k"].shape[1]
    slot = torch.remainder(pos, t) if local else torch.clamp(pos, max=t - 1)
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, slot] = k[:, 0]
    cache["v"][rows, slot] = v[:, 0]
    o = layers.decode_attention(q, cache["k"], cache["v"], pos,
                                window=cfg.window_size if local else 0,
                                ring=local)
    x = x + blk.wo(o.reshape(b, 1, -1))
    return x + blk.ffn(blk.ln2(x), cfg)[0]


def _zero_aux(device) -> dict:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "z_loss": z, "drop_fraction": z}


def _embed(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    tokens = torch.as_tensor(tokens, device=model.device).long()
    return model.embed[tokens].to(torch_dtype(model.cfg.compute_dtype))


def lm_forward(model: LM, tokens, *, collect_cache: bool = False,
               cache_len: int = 0):
    """``tokens (B, S)`` → ``(hidden (B, S, d) after the final norm, aux,
    cache or None)``; the cache (one ``{"k", "v"}`` per layer) is
    allocated at ``cache_len`` for global layers. ``aux`` holds the MoE
    losses and ``drop_fraction``, each summed over the layers (the
    reference's sum, not a mean), zero for a dense model. With
    ``cfg.remat`` and autograd recording, each block is checkpointed: its
    activations are recomputed in the backward instead of kept."""
    cfg = model.cfg
    x = _embed(model, tokens)
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    caches, auxes = [], []
    for blk in model.blocks:
        if remat:
            x, aux, cache = checkpoint(_block_full, blk, x, cfg,
                                       use_reentrant=False)
        else:
            x, aux, cache = _block_full(blk, x, cfg,
                                        return_cache=collect_cache,
                                        cache_len=cache_len)
        caches.append(cache)
        auxes.append(aux)
    x = model.final_norm(x)
    aux = {k: torch.stack([a[k] for a in auxes]).sum() for k in auxes[0]}
    return x, aux, (caches if collect_cache else None)


def unembed_matrix(model: LM) -> torch.Tensor:
    """``(d, V)``: the unembedding, or ``embed.T`` when tied."""
    return model.embed.T if model.cfg.tie_embeddings else model.unembed


def lm_loss(model: LM, batch):
    """``batch = {"tokens": (B, S + 1)}`` → ``(loss, metrics)``: the
    next-token cross-entropy plus the MoE auxiliary losses (0.01 · lb +
    0.001 · z, zero for a dense model)."""
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    x, aux, _ = lm_forward(model, inp)
    loss = layers.chunked_softmax_xent(x, unembed_matrix(model), tgt)
    total = loss + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    metrics = {"xent": loss, "lb_loss": aux["lb_loss"],
               "z_loss": aux["z_loss"],
               "drop_fraction": aux["drop_fraction"]}
    return total, metrics


@torch.no_grad()
def lm_prefill(model: LM, tokens, *, max_len: Optional[int] = None):
    """``tokens (B, S)`` → ``(last-token logits (B, V) f32, cache)``; the
    cache is allocated at ``max_len`` (default S) so decode can extend
    it. The logits are the bf16 (compute-dtype) product with the
    unembedding, returned in f32. Serving: runs under ``no_grad``."""
    s = torch.as_tensor(tokens).shape[1]
    x, _, cache = lm_forward(model, tokens, collect_cache=True,
                             cache_len=max_len or s)
    last = x[:, -1]
    logits = last @ unembed_matrix(model).to(last.dtype)
    return logits.float(), cache


@torch.no_grad()
def lm_decode_step(model: LM, cache: List[dict], token, pos):
    """``token (B, 1)``, ``pos (B,)`` → ``(logits (B, V) f32, cache)``.
    The cache is updated in place and returned. Runs under ``no_grad``."""
    cfg = model.cfg
    pos = torch.as_tensor(pos, device=model.device).long()
    x = _embed(model, token)
    for blk, c in zip(model.blocks, cache):
        x = _block_decode(blk, x, c, pos, cfg)
    x = model.final_norm(x)
    logits = x[:, 0] @ unembed_matrix(model).to(x.dtype)
    return logits.float(), cache


def make_decode_cache(cfg, batch: int, seq_len: int, *, dtype=None,
                      device="cuda") -> List[dict]:
    """A zero KV cache, one ``{"k", "v"}`` per layer, ``(batch, T, KV,
    head_dim)`` in ``dtype`` (default the compute dtype): ``T`` is the
    window for a local layer, ``seq_len`` for a global one."""
    dev = require_device(device)
    dtype = torch_dtype(dtype or cfg.compute_dtype) if not isinstance(
        dtype, torch.dtype) else dtype
    out = []
    for kind in cfg.pattern():
        t = cfg.window_size if (kind == "L" and cfg.window_size) else seq_len
        shp = (batch, t, cfg.n_kv_heads, cfg.head_dim)
        out.append({"k": torch.zeros(shp, dtype=dtype, device=dev),
                    "v": torch.zeros(shp, dtype=dtype, device=dev)})
    return out
