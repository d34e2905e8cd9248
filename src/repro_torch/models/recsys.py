"""The recsys model zoo: DLRM, xDeepFM, BERT4Rec, MIND (reference:
``repro.models.recsys``).

Parameters are plain dicts and lists of tensors in the reference's
pytree layout (``convert.recsys_from_numpy`` / ``recsys_to_numpy`` carry
them across unchanged); the functions take them with the config, as the
reference does. On the card two of the six hand-written kernels sit on
this path:

* ``dlrm_dot_interaction`` launches the dot-interaction twin
  (``kernels.dot_interaction``) for every DLRM forward, and under
  autograd its backward kernel for the gradient (``DotInteractionFn``):
  it is the only way from the 26 tables to the loss;
* ``embedding_bag`` launches the embedding-bag twin
  (``kernels.embedding_bag``) for ``sum`` and ``mean`` bags. It is
  forward-only: no loss of the reference pools through it, and on the
  card a table that requires a gradient raises.

On a CPU tensor each wrapper runs its plain version. Everything else is
plain torch on every device, as the reference computes it in jnp, and
differentiable: the losses train through ``launch.train``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels import dot_interaction as dot_kernel
from repro_torch.kernels import embedding_bag as bag_kernel
from repro_torch.models import layers
from repro_torch.models.layers import apply_norm, dense, mlp_apply
from repro_torch.models.transformer import torch_dtype

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameters: the reference's pytrees, tensors as leaves
# ---------------------------------------------------------------------------


def _normal(g, shape, scale, dtype):
    return layers.normal(g, shape, scale).to(dtype)


def _dense_init(g, in_dim, out_dim, *, bias=False, dtype=torch.float32):
    p = {"w": _normal(g, (in_dim, out_dim), 1.0 / math.sqrt(in_dim), dtype)}
    if bias:
        p["b"] = torch.zeros(out_dim, dtype=dtype, device=g.device)
    return p


def _mlp_init(g, dims, *, dtype):
    return [_dense_init(g, dims[i], dims[i + 1], bias=True, dtype=dtype)
            for i in range(len(dims) - 1)]


def _norm_init(d, *, dtype, device):
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def _generator(seed, device):
    return layers.make_generator(seed, device)


def _gelu(x):
    return nn.functional.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Embedding primitives
# ---------------------------------------------------------------------------


def pad_rows(v: int, m: int = 512) -> int:
    """Table rows rounded up to a multiple of ``m`` (the reference's
    row-sharding padding; the padding rows are dead weight)."""
    return -(-v // m) * m


def embedding_lookup(table, idx):
    """``table (V, d)``, ``idx (...)`` → ``(..., d)``."""
    return table[torch.as_tensor(idx, device=table.device).long()]


def bag_matrix(segment_ids: torch.Tensor, n_bags: int, idx: torch.Tensor
               ) -> torch.Tensor:
    """The ``(n_bags, P)`` int32 id matrix the embedding-bag kernel takes,
    −1 past each bag's end: bag b holds the entries of ``idx`` whose
    segment id is b, in their order in ``idx`` (the kernel sums a bag's
    row in that order, in f32). Entries whose segment id is outside
    ``[0, n_bags)`` belong to no bag."""
    dev = idx.device
    seg = segment_ids.to(dev).long()
    keep = (seg >= 0) & (seg < n_bags)
    seg, ids = seg[keep], idx[keep]
    order = torch.sort(seg, stable=True).indices
    seg, ids = seg[order], ids[order]
    counts = torch.bincount(seg, minlength=n_bags)
    p = max(1, int(counts.max())) if seg.numel() else 1
    start = torch.cumsum(counts, 0) - counts
    col = torch.arange(seg.numel(), device=dev) - start[seg]
    out = torch.full((n_bags, p), -1, dtype=torch.int32, device=dev)
    out[seg, col] = ids.to(torch.int32)
    return out


def embedding_bag(table, idx, offsets=None, *, segment_ids=None,
                  n_bags=None, mode: str = "sum", weights=None):
    """EmbeddingBag: bag b pools the rows of ``idx[offsets[b]:offsets[b +
    1]]`` (torch-style offsets, with ``n_bags``) or of the entries whose
    ``segment_ids`` is b; ``mode`` ``"sum"`` or ``"mean"`` (divided by
    the count, floored at 1). Ids are in ``[0, V)``.

    Unweighted bags go through the embedding-bag kernel
    (``kernels.embedding_bag``: on the card the hand-written kernel,
    on the CPU its plain version) over :func:`bag_matrix`'s padded ids;
    its f32 sums come back in the table's dtype, as the reference's
    segment sum. Weighted bags (``weights``, one per entry of ``idx``)
    have no kernel — the reference's TPU kernel takes no weights — and
    are a gather and an ``index_add_`` in the table's dtype.

    Forward-only on the card: the bag kernel has no backward, so an
    unweighted bag of a table that requires a gradient raises there
    (under ``torch.no_grad`` or on a detached table it runs) rather than
    return a value with no gradient. The CPU's plain version and the
    weighted bags are differentiable."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode {mode!r} is not 'sum' or 'mean'")
    idx = torch.as_tensor(idx, device=table.device)
    if segment_ids is None:
        if offsets is None or n_bags is None:
            raise ValueError("give offsets and n_bags, or segment_ids")
        offsets = torch.as_tensor(offsets, device=table.device)
        pos = torch.arange(idx.shape[0], device=table.device)
        segment_ids = torch.searchsorted(offsets.long(), pos,
                                         right=True) - 1
    else:
        segment_ids = torch.as_tensor(segment_ids, device=table.device)
        if n_bags is None:
            raise ValueError("segment_ids needs n_bags")
    if weights is None:
        out = bag_kernel.embedding_bag(
            table, bag_matrix(segment_ids, n_bags, idx)).to(table.dtype)
    else:
        rows = embedding_lookup(table, idx) * torch.as_tensor(
            weights, device=table.device)[:, None].to(table.dtype)
        seg = segment_ids.long()
        keep = (seg >= 0) & (seg < n_bags)
        out = torch.zeros((n_bags, table.shape[1]), dtype=rows.dtype,
                          device=table.device)
        out.index_add_(0, seg[keep], rows[keep])
    if mode == "mean":
        seg = segment_ids.long()
        seg = seg[(seg >= 0) & (seg < n_bags)]
        cnt = torch.bincount(seg, minlength=n_bags).to(out.dtype)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def _bce(logit, label):
    """Binary cross-entropy with logits, numerically stable, f32."""
    logit, label = logit.float(), label.float()
    return (torch.clamp(logit, min=0) - logit * label
            + torch.log1p(torch.exp(-logit.abs())))


# ---------------------------------------------------------------------------
# DLRM (MLPerf config)
# ---------------------------------------------------------------------------


def dlrm_init(cfg, *, seed: int = 0, device="cuda"):
    """DLRM's params (reference ``dlrm_init``'s layout and scales): one
    ``N(0, 1/d)`` table per sparse feature of ``pad_rows(rows)`` rows,
    the bottom and top MLPs."""
    g = _generator(seed, device)
    dtype = torch_dtype(cfg.param_dtype)
    tables = [_normal(g, (pad_rows(v), cfg.embed_dim),
                      1.0 / math.sqrt(cfg.embed_dim), dtype)
              for v in cfg.table_sizes]
    bot = _mlp_init(g, (cfg.n_dense,) + tuple(cfg.bot_mlp), dtype=dtype)
    n_feat = cfg.n_sparse + 1
    top_in = cfg.embed_dim + n_feat * (n_feat - 1) // 2
    top = _mlp_init(g, (top_in,) + tuple(cfg.top_mlp), dtype=dtype)
    return {"tables": tables, "bot": bot, "top": top}


def dlrm_dot_interaction(feats):
    """``feats (B, F, d)`` → the upper-triangle pairwise dots ``(B,
    F(F-1)/2)`` in ``np.triu_indices(F, 1)`` order: the dot-interaction
    kernel (``kernels.dot_interaction``), through ``DotInteractionFn``
    when autograd needs the gradient (its backward kernel)."""
    return dot_kernel.dot_interaction(feats.contiguous())


def dlrm_forward(params, dense_x, sparse, cfg):
    """``dense_x (B, n_dense)`` f32, ``sparse (B, n_sparse)`` int →
    logits ``(B,)``."""
    dev = params["bot"][0]["w"].device
    dense_x = torch.as_tensor(dense_x, device=dev)
    sparse = torch.as_tensor(sparse, device=dev)
    x = mlp_apply(params["bot"], torch.log1p(dense_x.abs()),
                  act=torch.relu, final_act=torch.relu)
    embs = [embedding_lookup(t, sparse[:, i])
            for i, t in enumerate(params["tables"])]
    feats = torch.stack([x] + embs, dim=1)               # (B, 27, d)
    inter = dlrm_dot_interaction(feats)
    top_in = torch.cat([x, inter], dim=-1)
    return mlp_apply(params["top"], top_in, act=torch.relu)[..., 0]


def dlrm_loss(params, batch, cfg):
    logit = dlrm_forward(params, batch["dense"], batch["sparse"], cfg)
    loss = _bce(logit, torch.as_tensor(batch["label"],
                                       device=logit.device)).mean()
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# xDeepFM
# ---------------------------------------------------------------------------


def xdeepfm_init(cfg, *, seed: int = 0, device="cuda"):
    g = _generator(seed, device)
    dtype = torch_dtype(cfg.param_dtype)
    m, d = cfg.n_sparse, cfg.embed_dim
    rows = pad_rows(cfg.n_sparse * cfg.vocab_per_field)
    table = _normal(g, (rows, d), 1.0 / math.sqrt(d), dtype)
    lin = _normal(g, (rows,), 0.01, dtype)
    cin_ws, h_prev = [], m
    for h in cfg.cin_layers:
        cin_ws.append(_normal(g, (h, h_prev, m),
                              1.0 / math.sqrt(h_prev * m), dtype))
        h_prev = h
    mlp = _mlp_init(g, (m * d,) + tuple(cfg.mlp) + (1,), dtype=dtype)
    cin_out = _dense_init(g, sum(cfg.cin_layers), 1, bias=True, dtype=dtype)
    return {"tables": table, "linear": lin, "cin": cin_ws, "mlp": mlp,
            "cin_out": cin_out}


def xdeepfm_forward(params, sparse, cfg):
    """``sparse (B, n_sparse)`` per-field ids (the field offset is applied
    here) → logits ``(B,)``: linear + CIN + deep."""
    dev = params["tables"].device
    sparse = torch.as_tensor(sparse, device=dev).long()
    b, m = sparse.shape
    offs = torch.arange(m, device=dev) * cfg.vocab_per_field
    flat = (sparse + offs[None, :]).reshape(-1)
    x0 = embedding_lookup(params["tables"], flat).reshape(b, m, cfg.embed_dim)
    lin = params["linear"][flat].reshape(b, m).sum(-1)
    xk, cin_feats = x0, []
    for w in params["cin"]:
        z = torch.einsum("bhd,bmd->bhmd", xk, x0)
        xk = torch.einsum("bhmd,nhm->bnd", z, w.to(z.dtype))
        cin_feats.append(xk.sum(-1))                     # (B, H_k)
    cin = dense(params["cin_out"], torch.cat(cin_feats, -1))[..., 0]
    deep = mlp_apply(params["mlp"], x0.reshape(b, -1), act=torch.relu)[..., 0]
    return lin + cin + deep


def xdeepfm_loss(params, batch, cfg):
    logit = xdeepfm_forward(params, batch["sparse"], cfg)
    loss = _bce(logit, torch.as_tensor(batch["label"],
                                       device=logit.device)).mean()
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# BERT4Rec
# ---------------------------------------------------------------------------


def bert4rec_init(cfg, *, seed: int = 0, device="cuda"):
    g = _generator(seed, device)
    dtype = torch_dtype(cfg.param_dtype)
    d = cfg.embed_dim
    blocks = []
    for _ in range(cfg.n_blocks):
        blk = {"ln1": _norm_init(d, dtype=dtype, device=g.device),
               "ln2": _norm_init(d, dtype=dtype, device=g.device)}
        for name, (i, o) in (("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
                             ("wo", (d, d)), ("w1", (d, cfg.d_ff)),
                             ("w2", (cfg.d_ff, d))):
            blk[name] = _dense_init(g, i, o, bias=True, dtype=dtype)
        blocks.append(blk)
    return {
        # +2: [PAD] = 0 reserved, [MASK] = n_items + 1; padded to 512×
        "item_embed": _normal(g, (pad_rows(cfg.n_items + 2), d),
                              1.0 / math.sqrt(d), dtype),
        "pos_embed": _normal(g, (cfg.seq_len, d), 0.02, dtype),
        "blocks": blocks,
        "final_ln": _norm_init(d, dtype=dtype, device=g.device),
    }


def bert4rec_encode(params, seq, mask, cfg):
    """``seq (B, L)`` item ids, ``mask (B, L)`` valid → hidden ``(B, L,
    d)``. Bidirectional blocks; the softmax in f32."""
    dev = params["item_embed"].device
    seq = torch.as_tensor(seq, device=dev)
    mask = torch.as_tensor(mask, device=dev).bool()
    b, l = seq.shape
    h_heads = cfg.n_heads
    hd = cfg.embed_dim // h_heads
    x = embedding_lookup(params["item_embed"], seq) + \
        params["pos_embed"][:l][None]
    neg = torch.full((), NEG_INF, dtype=x.dtype, device=dev)
    for p in params["blocks"]:
        h = apply_norm(p["ln1"], x)
        q = dense(p["wq"], h).reshape(b, l, h_heads, hd)
        k = dense(p["wk"], h).reshape(b, l, h_heads, hd)
        v = dense(p["wv"], h).reshape(b, l, h_heads, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        s = torch.where(mask[:, None, None, :], s, neg)
        w = torch.softmax(s.float(), dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, l, -1)
        x = x + dense(p["wo"], o)
        h = apply_norm(p["ln2"], x)
        x = x + dense(p["w2"], _gelu(dense(p["w1"], h)))
    return apply_norm(params["final_ln"], x)


def bert4rec_loss(params, batch, cfg):
    """Masked-item prediction over ``batch = {seq, mask, mlm_pos, mlm_tgt,
    mlm_mask}``."""
    dev = params["item_embed"].device
    h = bert4rec_encode(params, batch["seq"], batch["mask"], cfg)
    pos = torch.as_tensor(batch["mlm_pos"], device=dev).long()     # (B, P)
    hm = torch.gather(h, 1, pos[..., None].expand(-1, -1, h.shape[-1]))
    logits = hm @ params["item_embed"].T.to(h.dtype)               # (B, P, V+2)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = torch.as_tensor(batch["mlm_tgt"], device=dev).long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    m = torch.as_tensor(batch["mlm_mask"], device=dev).float()
    loss = (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return loss, {"loss": loss}


def bert4rec_user_embedding(params, seq, mask, cfg):
    """Serving: the hidden state at the last valid position, ``(B, d)``."""
    dev = params["item_embed"].device
    mask = torch.as_tensor(mask, device=dev)
    h = bert4rec_encode(params, seq, mask, cfg)
    last = torch.clamp(mask.long().sum(-1) - 1, min=0)             # (B,)
    return h[torch.arange(h.shape[0], device=dev), last]


def bert4rec_score_all(params, seq, mask, cfg):
    """Scores of every item row, ``(B, pad_rows(n_items + 2))``."""
    u = bert4rec_user_embedding(params, seq, mask, cfg)
    return u @ params["item_embed"].T.to(u.dtype)


# ---------------------------------------------------------------------------
# MIND (multi-interest capsules)
# ---------------------------------------------------------------------------


def mind_init(cfg, *, seed: int = 0, device="cuda"):
    g = _generator(seed, device)
    dtype = torch_dtype(cfg.param_dtype)
    d = cfg.embed_dim
    return {
        "item_embed": _normal(g, (pad_rows(cfg.n_items + 1), d),
                              1.0 / math.sqrt(d), dtype),
        "bilinear": _normal(g, (d, d), 1.0 / math.sqrt(d), dtype),
        "routing_init": _normal(g, (cfg.n_interests, cfg.hist_len), 1.0,
                                dtype),
    }


def _squash(x, dim=-1):
    n2 = torch.sum(x * x, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def mind_interests(params, hist, hist_mask, cfg):
    """``hist (B, T)`` item ids → ``(B, K, d)`` interest capsules by
    ``cfg.capsule_iters`` rounds of dynamic routing."""
    dev = params["item_embed"].device
    hist = torch.as_tensor(hist, device=dev)
    hist_mask = torch.as_tensor(hist_mask, device=dev).bool()
    e = embedding_lookup(params["item_embed"], hist)               # (B, T, d)
    eh = e @ params["bilinear"].to(e.dtype)
    b_logit = params["routing_init"][None].expand(
        (hist.shape[0],) + tuple(params["routing_init"].shape)).float()
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(torch.where(hist_mask[:, None, :], b_logit, neg),
                          dim=-1)
        z = torch.einsum("bkt,btd->bkd", w.to(eh.dtype), eh)
        u = _squash(z)                                             # (B, K, d)
        b_logit = b_logit + torch.einsum("bkd,btd->bkt", u, eh).float()
    return u


def mind_loss(params, batch, cfg):
    """Label-aware attention over the interests + in-batch softmax."""
    u = mind_interests(params, batch["hist"], batch["hist_mask"], cfg)
    tgt = embedding_lookup(params["item_embed"], batch["target"])  # (B, d)
    att = torch.softmax(torch.einsum("bkd,bd->bk", u, tgt).float() * 2.0,
                        dim=-1)
    user = torch.einsum("bk,bkd->bd", att.to(u.dtype), u)          # (B, d)
    logits = (user @ tgt.T).float()                                # (B, B)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.diagonal(logp).mean()
    return loss, {"loss": loss}


def mind_score_candidates(params, hist, hist_mask, cand_ids, cfg):
    """Retrieval: the max over interests of the dot scores, ``cand_ids
    (C,)`` → ``(B, C)``."""
    u = mind_interests(params, hist, hist_mask, cfg)               # (B, K, d)
    ce = embedding_lookup(params["item_embed"], cand_ids)          # (C, d)
    return torch.einsum("bkd,cd->bkc", u, ce).amax(dim=1)
