"""dlrm-mlperf — MLPerf DLRM benchmark config (Criteo 1TB). [arXiv:1906.00091]."""
from repro_torch.configs import base, register


def config():
    return base.DLRMConfig()


def shapes():
    return base.REC_SHAPES


register("dlrm-mlperf", config, shapes)
