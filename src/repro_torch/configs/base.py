"""The port's copy of the config dataclasses (``repro.configs.base``).

Configs are plain frozen dataclasses, data only: importing one touches no
device. Field names, types and defaults must stay identical to the
reference's: a snapshot's ``cfg_digest`` hashes ``dataclasses.asdict(cfg)``
of a ``DualEncoderConfig``, so a port config that differed in any field
would refuse every artifact the reference writes, and the parity tests
hold every config and shape of the registry equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell for an architecture.

    kind:
      lm_train    — train_step(tokens (B,S))
      lm_prefill  — serve_prefill(tokens (B,S)) -> logits + kv cache
      lm_decode   — serve_decode(cache seq=S, one new token)
      gnn_train   — train_step over a (padded) graph
      rec_train   — train_step over a recsys batch
      rec_serve   — pointwise inference batch
      retrieval   — 1 query vs n_candidates scoring
    """
    name: str
    kind: str
    dims: dict
    # If the cell is inapplicable for this arch, the reason (DESIGN.md
    # §Arch-applicability): a cell to skip, not a failure.
    skip: Optional[str] = None


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class LMConfig:
    arch_id: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    family: str = "lm"
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # Attention pattern: "G" = global full attention, "L" = sliding window.
    # Empty tuple = all global. Length must equal n_layers when set.
    layer_pattern: Tuple[str, ...] = ()
    window_size: int = 0
    moe: Optional[MoESpec] = None
    norm_eps: float = 1e-6
    param_dtype: str = "float32"     # master params
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    optimizer: str = "adamw"
    tie_embeddings: bool = False
    # attention chunk size for the jnp online-softmax path
    attn_chunk: int = 1024

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern:
            assert len(self.layer_pattern) == self.n_layers
            return self.layer_pattern
        return ("G",) * self.n_layers

    def n_params(self) -> int:
        """Approximate parameter count (for MODEL_FLOPS = 6·N·D)."""
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.moe is not None:
            ff = self.moe.n_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.n_experts
        else:
            ff = 3 * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ff + 2 * d) + emb + d

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        attn = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim \
            + self.n_heads * self.head_dim * d
        ff = self.moe.top_k * 3 * d * self.moe.d_ff_expert + d * self.moe.n_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ff + 2 * d) + emb + d


# ---------------------------------------------------------------------------
# Dual encoder (the paper's own architecture: BERT-base geometry)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GNNConfig:
    arch_id: str
    n_layers: int = 16
    d_hidden: int = 70
    aggregator: str = "gated"      # GatedGCN
    family: str = "gnn"
    dropout: float = 0.0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    optimizer: str = "adamw"
    residual: bool = True
    norm: str = "layer"            # per-layer norm on node/edge states


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DLRMConfig:
    arch_id: str = "dlrm-mlperf"
    family: str = "recsys"
    model: str = "dlrm"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    bot_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    interaction: str = "dot"
    # Criteo-1TB row counts capped at 40M per MLPerf reference (--max-ind-range).
    table_sizes: Tuple[int, ...] = (
        40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
        40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
        40_000_000, 40_000_000, 40_000_000, 590_152, 12_973, 108, 36)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    optimizer: str = "adamw"


@dataclass(frozen=True)
class XDeepFMConfig:
    arch_id: str = "xdeepfm"
    family: str = "recsys"
    model: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    mlp: Tuple[int, ...] = (400, 400)
    vocab_per_field: int = 200_000
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    optimizer: str = "adamw"


@dataclass(frozen=True)
class BERT4RecConfig:
    arch_id: str = "bert4rec"
    family: str = "recsys"
    model: str = "bert4rec"
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    n_items: int = 1_000_000
    d_ff: int = 256
    mask_prob: float = 0.2
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    optimizer: str = "adamw"


@dataclass(frozen=True)
class MINDConfig:
    arch_id: str = "mind"
    family: str = "recsys"
    model: str = "mind"
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    n_items: int = 1_000_000
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    optimizer: str = "adamw"


# ---------------------------------------------------------------------------
# Shared shape tables
# ---------------------------------------------------------------------------

def lm_shapes(arch_id: str, *, full_attention_only: bool) -> Tuple[ShapeSpec, ...]:
    long_skip = None
    if full_attention_only:
        long_skip = ("pure full-attention arch: 500k-context decode requires "
                     "sub-quadratic attention / bounded KV (DESIGN.md §7)")
    return (
        ShapeSpec("train_4k", "lm_train", dict(seq_len=4096, global_batch=256)),
        ShapeSpec("prefill_32k", "lm_prefill", dict(seq_len=32768, global_batch=32)),
        ShapeSpec("decode_32k", "lm_decode", dict(seq_len=32768, global_batch=128)),
        ShapeSpec("long_500k", "lm_decode", dict(seq_len=524288, global_batch=1),
                  skip=long_skip),
    )


GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "gnn_train",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)),
    ShapeSpec("minibatch_lg", "gnn_train",
              dict(n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
                   fanout=(15, 10), d_feat=602, n_classes=41, sampled=True)),
    ShapeSpec("ogb_products", "gnn_train",
              dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                   n_classes=47)),
    ShapeSpec("molecule", "gnn_train",
              dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, n_classes=1,
                   batched=True)),
)

REC_SHAPES = (
    ShapeSpec("train_batch", "rec_train", dict(batch=65_536)),
    ShapeSpec("serve_p99", "rec_serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "rec_serve", dict(batch=262_144)),
    ShapeSpec("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)),
)


def reduced(cfg):
    """Return a small config of the same family for CPU smoke tests."""
    if isinstance(cfg, LMConfig):
        kw = dict(
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
            head_dim=16, d_ff=128, vocab_size=512, scan_layers=True, remat=False,
            attn_chunk=32,
        )
        if cfg.layer_pattern:
            kw["layer_pattern"] = ("L", "G")
            kw["window_size"] = 16
        if cfg.moe is not None:
            kw["moe"] = MoESpec(n_experts=4, top_k=2, d_ff_expert=32,
                                capacity_factor=cfg.moe.capacity_factor)
        return dataclasses.replace(cfg, **kw)
    if isinstance(cfg, DualEncoderConfig):
        return dataclasses.replace(
            cfg, n_layers=2, d_model=32, n_heads=2, d_ff=64, vocab_size=128,
            max_len=16, spatial_t=50, n_clusters=4, neg_start=20, neg_end=30,
            index_mlp_hidden=(32,))
    if isinstance(cfg, GNNConfig):
        return dataclasses.replace(cfg, n_layers=3, d_hidden=16)
    if isinstance(cfg, DLRMConfig):
        return dataclasses.replace(
            cfg, embed_dim=16, bot_mlp=(32, 16), top_mlp=(64, 32, 1),
            table_sizes=tuple([100] * 26))
    if isinstance(cfg, XDeepFMConfig):
        return dataclasses.replace(cfg, embed_dim=8, cin_layers=(16, 16),
                                   mlp=(32, 32), vocab_per_field=100)
    if isinstance(cfg, BERT4RecConfig):
        return dataclasses.replace(cfg, embed_dim=16, n_blocks=2, n_heads=2,
                                   seq_len=16, n_items=200, d_ff=32)
    if isinstance(cfg, MINDConfig):
        return dataclasses.replace(cfg, embed_dim=16, n_interests=2,
                                   hist_len=8, n_items=200)
    raise TypeError(f"unknown config type {type(cfg)}")
