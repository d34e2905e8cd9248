"""The work a query needs, counted from shapes, and the H100's peaks: the
yardstick of ``mfu.offline`` and ``scan_roofline.offline``. The counts
depend on the configuration, the queries and the routes alone, never on
which backend or kernel did the work.

Peaks: NVIDIA's H100 SXM data sheet, dense rates: 989 TFLOP/s bf16 on
the tensor cores, 67 TFLOP/s f32 off them, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# bytes of a stored row's element, by tier
ELEM_BYTES = {"f32": 4, "bf16": 2, "int8": 1}


def encoder_flops(n_tokens: int, cfg: dict) -> int:
    """One query of ``n_tokens`` unpadded tokens through the tower: per
    layer the four d×d projections (8·n·d²), the feed-forward (4·n·d·f)
    and the attention's two products (4·n²·d); then the CLS head (2·d²)."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    n = int(n_tokens)
    layer = 8 * n * d * d + 4 * n * d * f + 4 * n * n * d
    return cfg["num_hidden_layers"] * layer + 2 * d * d


def head_flops(cfg: dict) -> int:
    """Per query after the tower: the mixing-weight MLP and the router."""
    d = cfg["hidden_size"]
    h = cfg["weight_mlp_hidden"]
    dims = [d + 2] + list(cfg["router_hidden"]) + [cfg["n_clusters"]]
    router = sum(2 * a * b for a, b in zip(dims, dims[1:]))
    return 2 * (d * h + h * 2) + router


def queries_flops(lengths, cfg: dict) -> int:
    """Tower and heads of every query, by its unpadded length."""
    return sum(encoder_flops(n, cfg) for n in lengths) \
        + len(lengths) * head_flops(cfg)


def scan_flops(pair_rows: int, cfg: dict) -> int:
    """2·d for each (query, live row of one of its routed clusters)."""
    return 2 * cfg["hidden_size"] * int(pair_rows)


def row_bytes(cfg: dict) -> int:
    """A live row as stored: the embedding, its f32 location, its id and,
    for int8, its f32 scale."""
    d = cfg["hidden_size"]
    prec = cfg["precision"]
    return d * ELEM_BYTES[prec] + 8 + 4 + (4 if prec == "int8" else 0)


def scan_bytes(queries: int, pairs: int, distinct_rows: int, k: int,
               cfg: dict) -> int:
    """Each input byte once, each output byte once: the live rows of the
    chunk's distinct routed clusters, the queries (f32 embedding,
    location, weights), their routes, the spatial table, and ``k`` scores
    and ids per query."""
    d = cfg["hidden_size"]
    per_query = d * 4 + 8 + 8 + k * 8
    return (distinct_rows * row_bytes(cfg) + queries * per_query + pairs * 4
            + cfg["spatial_t"] * 4)


def scan_bound_s(queries: int, pairs: int, pair_rows: int,
                 distinct_rows: int, k: int, cfg: dict) -> float:
    """The least time a scan could take: bytes at HBM's rate or products
    at the bf16 tensor-core rate, whichever is longer."""
    return max(scan_bytes(queries, pairs, distinct_rows, k, cfg)
               / PEAK_HBM_BYTES,
               scan_flops(pair_rows, cfg) / PEAK_BF16_FLOPS)
