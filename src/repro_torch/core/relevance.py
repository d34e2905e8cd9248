"""LIST-R serve side (reference: ``repro.core.relevance``): the two towers,
the adaptive (textual, spatial) mixing weights of Eq. 6, and the
exhaustive score of Eq. 7 over a corpus (the recall oracle's)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import spatial as sp
from repro_torch.device import full_f32_products
from repro_torch.models.layers import MLP
from repro_torch.models.transformer import Encoder


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
        self.fixed_w = nn.Parameter(fixed_w, requires_grad=False)
        self.spatial = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in spatial.items()})


def encode_queries(rel: RelevanceModel, tokens: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    return rel.q_enc(tokens, mask)


def encode_objects(rel: RelevanceModel, tokens: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    if rel.o_enc is None:
        raise ValueError("this relevance model has no object tower (o_enc)")
    return rel.o_enc(tokens, mask)


@torch.no_grad()
def st_weights(rel: RelevanceModel, q_emb: torch.Tensor, *,
               weight_mode: str = "mlp") -> torch.Tensor:
    """Per-query [w_text, w_spatial] (Eq. 6); softplus keeps them positive."""
    if weight_mode == "fixed":
        w = rel.fixed_w.float().expand(q_emb.shape[:-1] + (2,))
        return F.softplus(w)
    return F.softplus(rel.weight_mlp(q_emb))


@torch.no_grad()
def srel_serve(rel: RelevanceModel, s_in: torch.Tensor, *,
               spatial_mode: str = "step") -> torch.Tensor:
    """Spatial relevance at serve time (Eq. 5) by ``spatial_mode``: the
    step table's lookup, ``alpha·S_in^beta`` (``exp``), or ``S_in``
    (``linear``)."""
    if spatial_mode == "step":
        return sp.spatial_relevance_serve(
            sp.extract_lookup(rel.spatial["w_s"]), s_in)
    if spatial_mode == "exp":
        a = F.softplus(rel.spatial["alpha"].float())
        b = F.softplus(rel.spatial["beta"].float())
        return a * torch.pow(torch.clamp(s_in, min=1e-6), b)
    return s_in


@torch.no_grad()
def score_corpus(rel: RelevanceModel, q_emb: torch.Tensor,
                 q_loc: torch.Tensor, obj_emb: torch.Tensor,
                 obj_loc: torch.Tensor, *, dist_max: float = 1.0,
                 spatial_mode: str = "step",
                 weight_mode: str = "mlp") -> torch.Tensor:
    """ST(q, o) of every (query, object) pair: ``(B, d) × (N, d) → (B,
    N)`` f32 (Eq. 7), the plain scan the recall oracle runs.

    TRel is one f32 product, TF32 turned off for it on the card
    (:func:`~repro_torch.device.full_f32_products`). The distance is
    the reference's arithmetic, ``sqrt(dx² + dy²)`` then a true division
    by ``dist_max``, computed per coordinate so no ``(B, N, 2)``
    intermediate exists."""
    full_f32_products(q_emb.device)
    trel = q_emb.float() @ obj_emb.float().T
    q_loc, obj_loc = q_loc.float(), obj_loc.float()
    dx = q_loc[:, None, 0] - obj_loc[None, :, 0]
    dy = q_loc[:, None, 1] - obj_loc[None, :, 1]
    dist = torch.sqrt(dx * dx + dy * dy)
    del dx, dy
    divisor = torch.tensor(dist_max, dtype=torch.float32, device=dist.device)
    s_in = 1.0 - torch.clamp(dist / divisor, 0.0, 1.0)
    del dist
    s = srel_serve(rel, s_in, spatial_mode=spatial_mode)
    w = st_weights(rel, q_emb, weight_mode=weight_mode)
    return w[:, :1] * trel + w[:, 1:] * s
