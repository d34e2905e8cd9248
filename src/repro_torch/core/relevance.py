"""LIST-R (reference: ``repro.core.relevance``, paper §4.2): the two towers,
the adaptive (textual, spatial) mixing weights of Eq. 6, the score of
Eq. 7 over aligned pairs and over a corpus, and the contrastive loss of
Eq. 8.

ST(q, o) = w_st · [TRel, SRel]; TRel = q.emb · o.emb; SRel the learned
step function (``core/spatial.py``); w_st = softplus(MLP(q.emb)).

``train=True`` scores with Eq. 4's straight-through step (differentiable);
``train=False`` with Eq. 5's lookup. The corpus score in its serve form
builds no autograd graph: it ranks (the recall oracle, Eq. 13's mining)
and is never differentiated.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import spatial as sp
from repro_torch.device import full_f32_products
from repro_torch.models import layers
from repro_torch.models.layers import MLP
from repro_torch.models.transformer import Encoder, encoder_init

SPATIAL_MODES = ("step", "linear", "exp")
WEIGHT_MODES = ("mlp", "fixed")


class RelevanceModel(nn.Module):
    """The relevance params of a snapshot: the two encoder towers, the
    weight MLP (Eq. 6), the fixed weights of the ``fixed`` ablation, and
    the step-function increments ``w_s`` (``spatial`` params; empty for
    the ``linear`` ablation, ``alpha``/``beta`` for ``exp``)."""

    def __init__(self, q_enc: Encoder, o_enc: Optional[Encoder],
                 weight_mlp: MLP, fixed_w: torch.Tensor, spatial: dict):
        super().__init__()
        self.q_enc = q_enc
        self.o_enc = o_enc
        self.weight_mlp = weight_mlp
        self.fixed_w = nn.Parameter(fixed_w)
        self.spatial = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in spatial.items()})


def relevance_init(cfg, generator: torch.Generator, *,
                   spatial_mode: str = "step", weight_mode: str = "mlp",
                   with_o_enc: bool = True) -> RelevanceModel:
    """A fresh :class:`RelevanceModel` at the reference's scales
    (``repro.core.relevance.relevance_init``). Draws the query tower, the
    weight MLP ``(d, 64, 2)`` and the spatial params, then the object tower
    (last, so a model without one draws the same). ``weight_mode`` selects
    nothing at init: both weight forms are held, as in the reference."""
    if spatial_mode not in SPATIAL_MODES:
        raise ValueError(f"spatial_mode must be one of {SPATIAL_MODES}, "
                         f"got {spatial_mode!r}")
    if weight_mode not in WEIGHT_MODES:
        raise ValueError(f"weight_mode must be one of {WEIGHT_MODES}, "
                         f"got {weight_mode!r}")
    q_enc = encoder_init(cfg, generator)
    weight_mlp = layers.mlp_init(generator, (cfg.d_model, 64, 2))
    if spatial_mode == "step":
        spatial = sp.spatial_init(cfg.spatial_t, generator)
    elif spatial_mode == "exp":
        spatial = sp.exp_init()
    else:
        spatial = {}
    o_enc = encoder_init(cfg, generator) if with_o_enc else None
    return RelevanceModel(q_enc, o_enc, weight_mlp, torch.ones(2), spatial)


def encode_queries(rel: RelevanceModel, tokens: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    return rel.q_enc(tokens, mask)


def encode_objects(rel: RelevanceModel, tokens: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    if rel.o_enc is None:
        raise ValueError("this relevance model has no object tower (o_enc)")
    return rel.o_enc(tokens, mask)


def st_weights(rel: RelevanceModel, q_emb: torch.Tensor, *,
               weight_mode: str = "mlp") -> torch.Tensor:
    """Per-query [w_text, w_spatial] (Eq. 6); softplus keeps them positive."""
    if weight_mode == "fixed":
        w = rel.fixed_w.float().expand(q_emb.shape[:-1] + (2,))
        return F.softplus(w)
    return F.softplus(rel.weight_mlp(q_emb))


def srel(rel: RelevanceModel, s_in: torch.Tensor, *,
         spatial_mode: str = "step", train: bool = True) -> torch.Tensor:
    """Spatial relevance by ``spatial_mode``: the step function (Eq. 4 when
    ``train``, Eq. 5's lookup when not), ``alpha·S_in^beta`` (``exp``), or
    ``S_in`` (``linear``)."""
    if spatial_mode == "step":
        if train:
            return sp.spatial_relevance_train(rel.spatial["w_s"], s_in)
        return sp.spatial_relevance_serve(
            sp.extract_lookup(rel.spatial["w_s"]), s_in)
    if spatial_mode == "exp":
        return sp.exp_srel(rel.spatial, s_in)
    return sp.linear_srel(s_in)


def score_pairs(rel: RelevanceModel, q_emb, q_loc, o_emb, o_loc, *,
                dist_max=1.0, spatial_mode: str = "step",
                weight_mode: str = "mlp", train: bool = True
                ) -> torch.Tensor:
    """ST(q, o) of aligned (broadcasting) pairs: ``q_emb (..., d)``,
    ``o_emb (..., d)`` → ``(...,)``."""
    trel = torch.sum(q_emb * o_emb, dim=-1)
    s_in = sp.s_in_from_locs(q_loc, o_loc, dist_max)
    s = srel(rel, s_in, spatial_mode=spatial_mode, train=train)
    w = st_weights(rel, q_emb, weight_mode=weight_mode)
    return w[..., 0] * trel + w[..., 1] * s


def _score_corpus(rel, q_emb, q_loc, obj_emb, obj_loc, *, dist_max,
                  spatial_mode, weight_mode, train):
    full_f32_products(q_emb.device)
    trel = q_emb.float() @ obj_emb.float().T
    q_loc, obj_loc = q_loc.float(), obj_loc.float()
    dx = q_loc[:, None, 0] - obj_loc[None, :, 0]
    dy = q_loc[:, None, 1] - obj_loc[None, :, 1]
    dist = torch.sqrt(dx * dx + dy * dy)
    del dx, dy
    divisor = torch.as_tensor(dist_max, dtype=torch.float32,
                              device=dist.device)
    s_in = 1.0 - torch.clamp(dist / divisor, 0.0, 1.0)
    del dist
    s = srel(rel, s_in, spatial_mode=spatial_mode, train=train)
    w = st_weights(rel, q_emb, weight_mode=weight_mode)
    return w[:, :1] * trel + w[:, 1:] * s


def score_corpus(rel: RelevanceModel, q_emb: torch.Tensor,
                 q_loc: torch.Tensor, obj_emb: torch.Tensor,
                 obj_loc: torch.Tensor, *, dist_max=1.0,
                 spatial_mode: str = "step", weight_mode: str = "mlp",
                 train: bool = False) -> torch.Tensor:
    """ST(q, o) of every (query, object) pair: ``(B, d) × (N, d) → (B,
    N)`` f32 (Eq. 7). ``train=False`` (the plain scan of the recall oracle
    and of Eq. 13) builds no autograd graph; ``train=True`` (in-batch
    negatives, Eq. 8) is differentiable.

    TRel is one f32 product, TF32 turned off for it on the card
    (:func:`~repro_torch.device.full_f32_products`). The distance is
    the reference's arithmetic, ``sqrt(dx² + dy²)`` then a true division
    by ``dist_max``, computed per coordinate so no ``(B, N, 2)``
    intermediate exists."""
    kw = dict(dist_max=dist_max, spatial_mode=spatial_mode,
              weight_mode=weight_mode, train=train)
    if train:
        return _score_corpus(rel, q_emb, q_loc, obj_emb, obj_loc, **kw)
    with torch.no_grad():
        return _score_corpus(rel, q_emb, q_loc, obj_emb, obj_loc, **kw)


def contrastive_loss(rel: RelevanceModel, batch: dict, *,
                     spatial_mode: str = "step", weight_mode: str = "mlp",
                     in_batch_negatives: bool = True):
    """Eq. 8: NLL of the positive against ``b`` hard negatives and, with
    ``in_batch_negatives``, the other queries' positives (self masked to
    −1e30), log-softmax in f32. ``batch`` holds tensors ``q_tokens (B,
    L)``, ``q_mask``, ``q_loc (B, 2)``, ``pos_*`` alike, ``neg_tokens (B,
    b, L)``, ``neg_mask``, ``neg_loc (B, b, 2)`` and ``dist_max``. The
    positives and negatives go through the object tower in one pass.
    Returns ``(loss, {"loss", "acc"})``, the metrics detached."""
    b, nneg = batch["neg_tokens"].shape[:2]
    q = encode_queries(rel, batch["q_tokens"], batch["q_mask"])
    tokens = torch.cat([batch["pos_tokens"],
                        batch["neg_tokens"].reshape(b * nneg, -1)])
    mask = torch.cat([batch["pos_mask"],
                      batch["neg_mask"].reshape(b * nneg, -1)])
    objs = encode_objects(rel, tokens, mask)
    pos, neg = objs[:b], objs[b:].reshape(b, nneg, -1)

    kw = dict(spatial_mode=spatial_mode, weight_mode=weight_mode, train=True,
              dist_max=batch.get("dist_max", 1.0))
    s_neg = score_pairs(rel, q[:, None, :], batch["q_loc"][:, None, :], neg,
                        batch["neg_loc"], **kw)
    if in_batch_negatives:
        # the positive's score is the diagonal of the in-batch scores: one
        # arithmetic for both, so a query whose positive is also another
        # query's ties with that in-batch negative exactly, and the tie
        # ranks the positive first (argmax), as in the reference
        s_ib = score_corpus(rel, q, batch["q_loc"], pos, batch["pos_loc"],
                            **kw)
        eye = torch.eye(b, dtype=torch.bool, device=s_ib.device)
        logits = [torch.diagonal(s_ib)[:, None], s_neg,
                  s_ib.masked_fill(eye, -1e30)]
    else:
        s_pos = score_pairs(rel, q, batch["q_loc"], pos, batch["pos_loc"],
                            **kw)
        logits = [s_pos[:, None], s_neg]
    logits = torch.cat(logits, dim=1).float()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp[:, 0].mean()
    acc = (logits.argmax(-1) == 0).float().mean()
    return loss, {"loss": loss.detach(), "acc": acc.detach()}
