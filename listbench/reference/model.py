"""The plain reference of LIST's query phase up to the scan: the query tower
(a BERT-style encoder), the mixing weights of Eq. 6, the serve-form
spatial table ŵ_s of Eq. 5, the location normalizer, the router features
of Eq. 9–10 and the cluster classifier of Eq. 11.

Plain PyTorch in float32 with TF32 off, from the benchmark's weight tree
(``inputs.weights``). The tower follows the port's published block, which
departs from BERT in two ways the configuration lists: layer norm before
each sub-layer (pre-LN) and GELU's tanh form. The CLS row's final
projection goes through tanh.

``rnd`` is where the configuration's compute type rounds: identity for
the reference itself, a lower precision for the control (``control.py``).
Attention scores and the softmax stay float32, as the configuration
states.
"""
from __future__ import annotations

import math

import torch


def f32_products() -> None:
    """Full float32 products on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Exact:
    """No rounding: the float32 reference."""

    def act(self, x):
        return x

    def weight(self, w):
        return w


EXACT = Exact()


def layer_norm(x, p, i=None, eps=1e-6):
    scale = p["scale"] if i is None else p["scale"][i]
    bias = p["bias"] if i is None else p["bias"][i]
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def dense(x, p, i=None, rnd=EXACT):
    w = p["w"] if i is None else p["w"][i]
    b = p["b"] if i is None else p["b"][i]
    return rnd.act(rnd.act(x) @ rnd.weight(w) + b)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def encode(enc: dict, tokens: torch.Tensor, mask: torch.Tensor, *,
           n_heads: int, eps: float, rnd=EXACT) -> torch.Tensor:
    """``tokens (B, L)``, ``mask (B, L)`` bool → ``(B, d)`` f32."""
    b, L = tokens.shape
    x = rnd.act(rnd.act(enc["embed"][tokens.long()])
                + rnd.act(enc["pos_embed"][:L])[None])
    blk = enc["blocks"]
    d = x.shape[-1]
    hd = d // n_heads
    key_mask = mask[:, None, None, :]
    for i in range(blk["ln1"]["scale"].shape[0]):
        h = rnd.act(layer_norm(x, blk["ln1"], i, eps))
        q = dense(h, blk["attn"]["wq"], i, rnd).reshape(b, L, n_heads, hd)
        k = dense(h, blk["attn"]["wk"], i, rnd).reshape(b, L, n_heads, hd)
        v = dense(h, blk["attn"]["wv"], i, rnd).reshape(b, L, n_heads, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        s = s.masked_fill(~key_mask, -1e30)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        x = rnd.act(x + dense(o.reshape(b, L, d), blk["attn"]["wo"], i, rnd))
        h = rnd.act(layer_norm(x, blk["ln2"], i, eps))
        u = rnd.act(gelu_tanh(dense(h, blk["mlp"]["w1"], i, rnd)))
        x = rnd.act(x + dense(u, blk["mlp"]["w2"], i, rnd))
    x = rnd.act(layer_norm(x, enc["final_ln"], None, eps))
    return torch.tanh(dense(x[:, 0], enc["cls"], None, rnd))


def mlp(x, layers):
    """Dense layers with ReLU between them, float32."""
    for j, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if j < len(layers) - 1:
            x = torch.relu(x)
    return x


def mixing_weights(rel: dict, q: torch.Tensor) -> torch.Tensor:
    """Eq. 6: ``[w_text, w_spatial] = softplus(MLP(q))``, ``(B, 2)``."""
    return torch.nn.functional.softplus(mlp(q, rel["weight_mlp"]))


def spatial_table(rel: dict) -> torch.Tensor:
    """Eq. 5: ŵ_s[i] = Σ_{j≤i} softplus(w_s[j])."""
    return torch.cumsum(torch.nn.functional.softplus(rel["spatial"]["w_s"]),
                        dim=0)


def normalizer(loc: torch.Tensor):
    """``(lo, span)`` of the objects' locations (min / max, span ≥ 1e-9)."""
    lo = loc.min(dim=0).values
    return lo, torch.clamp(loc.max(dim=0).values - lo, min=1e-9)


def features(emb: torch.Tensor, loc: torch.Tensor, norm) -> torch.Tensor:
    """Eq. 9–10: ``[emb / ‖emb‖, (loc − lo) / span]``."""
    nrm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    lo, span = norm
    return torch.cat([emb / torch.clamp(nrm, min=1e-9), (loc - lo) / span],
                     dim=-1)


def router_logits(index: dict, feats: torch.Tensor) -> torch.Tensor:
    """Eq. 11's classifier: ``(B, c)`` logits."""
    return mlp(feats, index["mlp"])
