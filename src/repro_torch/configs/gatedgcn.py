"""gatedgcn — 16L d_hidden=70, gated edge aggregation. [arXiv:2003.00982]."""
from repro_torch.configs import base, register


def config():
    return base.GNNConfig(arch_id="gatedgcn", n_layers=16, d_hidden=70,
                          aggregator="gated")


def shapes():
    return base.GNN_SHAPES


register("gatedgcn", config, shapes)
