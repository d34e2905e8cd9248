"""Architecture registry of the port (reference: ``repro.configs``):
``get_config(arch_id)`` / ``get_shapes(arch_id)``.

Every architecture of the reference registers its exact full config and
its four shape cells here, from one module each, field for field the
reference's. ``SERVE_QUERIES`` is the dims of ``list-dual-encoder``'s
``serve_queries`` cell, the query phase at Geo-Glue scale.
"""
from __future__ import annotations

from repro_torch.configs import base
from repro_torch.configs.base import DualEncoderConfig, reduced  # noqa: F401

_REGISTRY = {}


def register(arch_id, cfg_fn, shapes_fn):
    _REGISTRY[arch_id] = (cfg_fn, shapes_fn)


def arch_ids():
    return sorted(_REGISTRY)


def get_config(arch_id: str):
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {arch_ids()}")
    return _REGISTRY[arch_id][0]()


def get_shapes(arch_id: str):
    return _REGISTRY[arch_id][1]()


def get_shape(arch_id: str, shape_name: str):
    for s in get_shapes(arch_id):
        if s.name == shape_name:
            return s
    raise KeyError(f"arch {arch_id} has no shape {shape_name!r}")


# --- import registrations (order: LM, gnn, recsys, paper) ---
from repro_torch.configs import gemma3_27b          # noqa: F401,E402
from repro_torch.configs import stablelm_1_6b       # noqa: F401,E402
from repro_torch.configs import qwen2_7b            # noqa: F401,E402
from repro_torch.configs import moonshot_16b_a3b    # noqa: F401,E402
from repro_torch.configs import kimi_k2_1t_a32b     # noqa: F401,E402
from repro_torch.configs import gatedgcn            # noqa: F401,E402
from repro_torch.configs import mind                # noqa: F401,E402
from repro_torch.configs import bert4rec            # noqa: F401,E402
from repro_torch.configs import xdeepfm             # noqa: F401,E402
from repro_torch.configs import dlrm_mlperf         # noqa: F401,E402
from repro_torch.configs import list_dual_encoder   # noqa: F401,E402

SERVE_QUERIES = dict(get_shape("list-dual-encoder", "serve_queries").dims)

__all__ = ["DualEncoderConfig", "SERVE_QUERIES", "arch_ids", "base",
           "get_config", "get_shape", "get_shapes", "reduced", "register"]
