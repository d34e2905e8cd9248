"""The port's copy of the dual-encoder config (``repro.configs.base``).

The field names, types and defaults must stay identical to the
reference's ``DualEncoderConfig``: a snapshot's ``cfg_digest`` hashes
``dataclasses.asdict(cfg)``, so a port config that differed in any field
would refuse every artifact the reference writes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DualEncoderConfig:
    arch_id: str = "list-dual-encoder"
    family: str = "dual_encoder"
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 32_768      # hashing tokenizer vocab
    max_len: int = 64
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    optimizer: str = "adamw"

    # --- LIST-specific hyperparameters (paper Table 2) ---
    spatial_t: int = 1000          # step-function resolution
    n_clusters: int = 20           # c  (n/10k rule)
    cluster_route: int = 1         # cr
    neg_start: int = 50_000
    neg_end: int = 55_000
    hard_neg_b: int = 4            # b hard negatives per query (Eq. 8)
    mcl_negatives: int = 8         # m negatives per query for MCL (Eq. 14)
    index_mlp_hidden: Tuple[int, ...] = (512, 512)


def list_dual_encoder() -> DualEncoderConfig:
    """``list-dual-encoder``: BERT-base geometry (12L / 768 / 12H / 3072),
    the paper's own relevance model."""
    return DualEncoderConfig()


# the query-phase shape of ``list-dual-encoder`` (reference:
# configs/list_dual_encoder.py ``serve_queries``): Geo-Glue scale
SERVE_QUERIES = dict(query_batch=4096, n_objects=2_849_754, n_clusters=300,
                     topk=20)
