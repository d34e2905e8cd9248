"""LIST-R serve side (reference: ``repro.core.relevance``): the query tower
and the adaptive (textual, spatial) mixing weights of Eq. 6."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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


@torch.no_grad()
def st_weights(rel: RelevanceModel, q_emb: torch.Tensor, *,
               weight_mode: str = "mlp") -> torch.Tensor:
    """Per-query [w_text, w_spatial] (Eq. 6); softplus keeps them positive."""
    if weight_mode == "fixed":
        w = rel.fixed_w.float().expand(q_emb.shape[:-1] + (2,))
        return F.softplus(w)
    return F.softplus(rel.weight_mlp(q_emb))
