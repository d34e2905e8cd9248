"""A cell at a size the CPU runs in seconds, for the tests: widths cut,
the shapes and the code paths kept."""
TINY_CFG = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=128, vocab_size=512,
                max_position_embeddings=16, weight_mlp_hidden=64,
                router_hidden=[32, 32], spatial_t=100, n_objects=3000,
                n_clusters=8, capacity=768, spill=3)
TINY_TRAFFIC = dict(call_queries=512, len_min=4, len_max=16, pregen_qps=2000,
                    rate_qps=400, warmup_requests=64)
TINY_SAMPLE = 256


def overrides(cell: str, limits=None) -> dict:
    traffic = dict(TINY_TRAFFIC)
    if cell == "int8-exhaustive":
        traffic["cr"] = TINY_CFG["n_clusters"]
    lim = {"sample": TINY_SAMPLE}
    if limits is not None:
        lim["limits"] = limits
    return {"cfg": TINY_CFG, "traffic": traffic, "limits": lim}
