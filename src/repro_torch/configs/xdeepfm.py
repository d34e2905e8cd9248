"""xdeepfm — CIN + deep MLP CTR model. [arXiv:1803.05170]."""
from repro_torch.configs import base, register


def config():
    return base.XDeepFMConfig()


def shapes():
    return base.REC_SHAPES


register("xdeepfm", config, shapes)
