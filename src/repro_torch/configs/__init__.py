"""Config registry of the port: only the LIST dual encoder is ported."""
from __future__ import annotations

from repro_torch.configs.base import (DualEncoderConfig, SERVE_QUERIES,
                                      list_dual_encoder)

_REGISTRY = {"list-dual-encoder": list_dual_encoder}


def get_config(arch_id: str) -> DualEncoderConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


__all__ = ["DualEncoderConfig", "SERVE_QUERIES", "get_config",
           "list_dual_encoder"]
