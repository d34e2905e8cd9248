"""The benchmark's inputs, made from ``--seed``: the weights, the objects
and the queries. Both sides get the same inputs: the port builds its
modules and buffers from them, the plain reference reads them directly.

* Weights: one tree in the layout the port's ``convert.params_from_numpy``
  reads (the encoder's layers stacked on a leading axis), drawn on the
  device by one ``torch.randn`` from the configuration's ``weights_seed``
  and cut into leaves at the port's initial scales (tokens ``N(0, 1/d)``,
  positions ``N(0, 0.02²)``, every dense ``1/√fan_in`` with a zero bias,
  unit layer norms, ``w_s = -2 + 0.01·N``); ``--seed`` orders its units.
* Objects: unit rows ``(n, d)`` f32 and locations ``(n, 2)`` uniform on the
  unit square, on the device, in blocks of ``OBJECT_BLOCK`` rows.
* Queries: host numpy rows (the port's API takes numpy), one stream per
  purpose, each call a function of ``(seed, stream, index)`` alone.

Nothing here imports the port.
"""
from __future__ import annotations

import math

import numpy as np
import torch

OBJECT_BLOCK = 1 << 18

# sub-streams of one seed
STREAM_WEIGHTS, STREAM_OBJECTS, STREAM_QUERIES = 1, 2, 3
STREAM_WARMUP, STREAM_ARRIVALS, STREAM_SAMPLE = 4, 5, 6


def sub_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit seed for one (seed, stream, index), any whole ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), stream, index])
    a, b = ss.generate_state(2, np.uint32)
    return ((int(a) << 31) ^ int(b)) & ((1 << 63) - 1)


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream, index))


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def weight_leaves(cfg: dict):
    """``[(path, shape, kind, scale)]`` of every leaf: ``kind`` is
    ``normal`` (drawn, times ``scale``, plus ``shift``), ``zeros`` or
    ``ones``. Paths are tuples of dict keys and list positions."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    f, v = cfg["intermediate_size"], cfg["vocab_size"]
    out = []

    def dense(path, i, o, stack=None):
        lead = () if stack is None else (stack,)
        out.append((path + ("w",), lead + (i, o), "normal", 1 / math.sqrt(i)))
        out.append((path + ("b",), lead + (o,), "zeros", 0.0))

    def norm(path, stack=None):
        lead = () if stack is None else (stack,)
        out.append((path + ("scale",), lead + (d,), "ones", 0.0))
        out.append((path + ("bias",), lead + (d,), "zeros", 0.0))

    enc = ("rel", "q_enc")
    out.append((enc + ("embed",), (v, d), "normal", 1 / math.sqrt(d)))
    out.append((enc + ("pos_embed",), (cfg["max_position_embeddings"], d),
                "normal", 0.02))
    blk = enc + ("blocks",)
    norm(blk + ("ln1",), L)
    norm(blk + ("ln2",), L)
    for name in ("wq", "wk", "wv", "wo"):
        dense(blk + ("attn", name), d, d, L)
    dense(blk + ("mlp", "w1"), d, f, L)
    dense(blk + ("mlp", "w2"), f, d, L)
    norm(enc + ("final_ln",))
    dense(enc + ("cls",), d, d)
    h = cfg["weight_mlp_hidden"]
    dense(("rel", "weight_mlp", 0), d, h)
    dense(("rel", "weight_mlp", 1), h, 2)
    out.append((("rel", "fixed_w"), (2,), "ones", 0.0))
    out.append((("rel", "spatial", "w_s"), (cfg["spatial_t"],), "normal",
                0.01))
    dims = [d + 2] + list(cfg["router_hidden"]) + [cfg["n_clusters"]]
    for i in range(len(dims) - 1):
        dense(("index", "mlp", i), dims[i], dims[i + 1])
    return out


# the constant added to a drawn leaf (w_s's prior of small increments)
SHIFT = {("rel", "spatial", "w_s"): -2.0}


def _put(tree, path, leaf):
    node = tree
    for i, key in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(node, list):
            while len(node) <= key:
                node.append(None)
            if node[key] is None:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
        node[path[-1]] = leaf
    else:
        node[path[-1]] = leaf


def weights(cfg: dict, seed: int, device) -> dict:
    """``{"rel": rel_params, "index": index_params}`` f32 on ``device``.

    One model per configuration, drawn from its ``weights_seed``: every
    drawn leaf is a view of one ``randn`` of their total size. ``seed``
    then orders it: it permutes the vocabulary's rows, each layer's
    feed-forward units, the router's hidden units and the cluster labels.
    Each seed serves the same model up to those orders, so the routes'
    loads, and the scan's work with them, do not change with the seed."""
    leaves = weight_leaves(cfg)
    drawn = [lf for lf in leaves if lf[2] == "normal"]
    total = sum(math.prod(lf[1]) for lf in drawn)
    g = device_generator(cfg["weights_seed"], STREAM_WEIGHTS, device)
    flat = torch.randn(total, generator=g, device=device)
    tree, at = {}, 0
    for path, shape, kind, scale in leaves:
        if kind == "normal":
            n = math.prod(shape)
            leaf = flat[at:at + n].view(shape).mul_(scale)
            leaf.add_(SHIFT.get(path, 0.0))
            at += n
        elif kind == "ones":
            leaf = torch.ones(shape, device=device)
        else:
            leaf = torch.zeros(shape, device=device)
        _put(tree, path, leaf)
    _order(tree, device_generator(seed, STREAM_WEIGHTS, device))
    return tree


def _order(tree: dict, g: torch.Generator) -> None:
    """Permute ``tree``'s units in place of its leaves (see ``weights``)."""
    def perm(n):
        return torch.randperm(n, generator=g, device=g.device)

    enc = tree["rel"]["q_enc"]
    enc["embed"] = enc["embed"][perm(enc["embed"].shape[0])]
    w1, w2 = enc["blocks"]["mlp"]["w1"], enc["blocks"]["mlp"]["w2"]
    ps = [perm(w1["w"].shape[-1]) for _ in range(w1["w"].shape[0])]
    w1["w"] = torch.stack([w[:, p] for w, p in zip(w1["w"], ps)])
    w1["b"] = torch.stack([b[p] for b, p in zip(w1["b"], ps)])
    w2["w"] = torch.stack([w[p] for w, p in zip(w2["w"], ps)])
    router = tree["index"]["mlp"]
    for j, layer in enumerate(router):
        p = perm(layer["w"].shape[1])
        layer["w"], layer["b"] = layer["w"][:, p], layer["b"][p]
        if j + 1 < len(router):
            router[j + 1]["w"] = router[j + 1]["w"][p]


def objects(cfg: dict, seed: int, device):
    """``(emb (n, d) f32 unit rows, loc (n, 2) f32)`` on ``device``."""
    n, d = cfg["n_objects"], cfg["hidden_size"]
    g = device_generator(seed, STREAM_OBJECTS, device)
    emb = torch.empty((n, d), device=device)
    for s in range(0, n, OBJECT_BLOCK):
        e = min(s + OBJECT_BLOCK, n)
        emb[s:e] = torch.nn.functional.normalize(
            torch.randn(e - s, d, generator=g, device=device), dim=-1)
    loc = torch.rand(n, 2, generator=g, device=device)
    return emb, loc


def queries(cfg: dict, traffic: dict, seed: int, stream: int, index: int,
            n: int):
    """``n`` queries of one call: ``tokens (n, L) int32`` (0 = padding),
    ``mask (n, L) bool``, ``loc (n, 2) f32``, ``lengths (n,)``. Lengths
    cover ``len_min..len_max`` evenly, in an order drawn from the seed,
    so every call holds the same lengths; tokens are uniform over
    ``1..vocab-1`` and locations uniform on the unit square."""
    r = rng(seed, stream, index)
    L = cfg["max_position_embeddings"]
    lo, hi = traffic["len_min"], traffic["len_max"]
    lengths = r.permutation(lo + np.arange(n) % (hi - lo + 1))
    tok = r.integers(1, cfg["vocab_size"], (n, L), dtype=np.int64)
    mask = np.arange(L)[None, :] < lengths[:, None]
    tok = np.where(mask, tok, 0).astype(np.int32)
    loc = r.uniform(size=(n, 2)).astype(np.float32)
    return tok, mask, loc, lengths
