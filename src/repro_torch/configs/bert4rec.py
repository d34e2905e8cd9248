"""bert4rec — bidirectional sequential recommender. [arXiv:1904.06690]."""
from repro_torch.configs import base, register


def config():
    return base.BERT4RecConfig()


def shapes():
    return base.REC_SHAPES


register("bert4rec", config, shapes)
