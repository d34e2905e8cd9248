"""mind — multi-interest capsule retrieval. [arXiv:1904.08030]."""
from repro_torch.configs import base, register


def config():
    return base.MINDConfig()


def shapes():
    return base.REC_SHAPES


register("mind", config, shapes)
