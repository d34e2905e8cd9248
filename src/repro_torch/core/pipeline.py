"""Offline corpus embedding (reference: ``repro.core.pipeline``
``embed_objects`` / ``embed_queries``): a tower over a corpus's tokens in
fixed-size batches through ``engine.run_batched``, on the device the
relevance model lives on. Training is not ported here."""
from __future__ import annotations

import numpy as np

from repro_torch.core import engine as engine_lib
from repro_torch.core import relevance
from repro_torch.core.relevance import RelevanceModel


def embed_objects(rel: RelevanceModel, corpus, *, batch: int = 512
                  ) -> np.ndarray:
    """``(n_objects, d)`` f32 object embeddings of ``corpus``."""
    tokens, mask = corpus.object_tokens()
    return engine_lib.run_batched(
        lambda t, m: relevance.encode_objects(rel, t, m), [tokens, mask],
        batch=batch, device=rel.q_enc.embed.device)


def embed_queries(rel: RelevanceModel, corpus, query_ids=None, *,
                  batch: int = 512) -> np.ndarray:
    """``(n, d)`` f32 embeddings of ``corpus``'s queries ``query_ids``
    (all when None)."""
    tokens, mask = corpus.query_tokens(query_ids)
    return engine_lib.run_batched(
        lambda t, m: relevance.encode_queries(rel, t, m), [tokens, mask],
        batch=batch, device=rel.q_enc.embed.device)
