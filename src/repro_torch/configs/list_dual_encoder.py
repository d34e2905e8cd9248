"""list-dual-encoder — the paper's own relevance-model architecture.

BERT-base geometry (12L/768/12H) dual encoder + LIST hyperparameters
(Table 2 of the paper). Shapes mirror the paper's workloads: contrastive
training, corpus embedding (encode), query serving through the index, and
pseudo-label mining (brute-force scoring sweep).
"""
from repro_torch.configs import base, register
from repro_torch.configs.base import ShapeSpec


def config():
    return base.DualEncoderConfig()


def shapes():
    return (
        # Contrastive training step: (query, positive, b hard negatives).
        ShapeSpec("contrastive_train", "de_train",
                  dict(global_batch=4096, max_len=64, hard_negs=4)),
        # Offline corpus embedding at Geo-Glue scale (2.85M objects).
        ShapeSpec("encode_corpus", "de_encode",
                  dict(global_batch=16384, max_len=64)),
        # Query phase: route + fused score + top-k over cluster buffers.
        ShapeSpec("serve_queries", "list_serve",
                  dict(query_batch=4096, n_objects=2_849_754, n_clusters=300,
                       topk=20)),
        # Pseudo-label mining: distributed brute-force score + window select.
        ShapeSpec("mine_negatives", "list_mine",
                  dict(query_batch=1024, n_objects=2_849_754,
                       neg_start=180_000, neg_end=181_000)),
    )


register("list-dual-encoder", config, shapes)
