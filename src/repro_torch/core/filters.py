"""Filtered search (reference: ``repro.core.filters``).

Objects carry ``attrs = [tenant, category bitmask, timestamp]`` int32
rows; a :class:`FilterSpec` compiles to ``fvals = [tenant, mask, t_min,
t_max]`` with sentinel no-op values (tenant -1, mask 0, int32 extremes),
so one predicate serves every filter combination.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

N_ATTRS = 3
N_FVALS = 4
INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1
ANY_TENANT = -1
ANY_CATEGORY = 0


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """Tenant equality ∧ category-bitmask intersection ∧ inclusive time
    window; each clause's default accepts everything."""

    tenant: int = ANY_TENANT
    category_mask: int = ANY_CATEGORY
    t_min: int = INT32_MIN
    t_max: int = INT32_MAX

    def __post_init__(self):
        for name in ("tenant", "category_mask", "t_min", "t_max"):
            v = getattr(self, name)
            if not (INT32_MIN <= int(v) <= INT32_MAX):
                raise ValueError(f"FilterSpec.{name}={v} outside int32")

    @property
    def is_noop(self) -> bool:
        return (self.tenant == ANY_TENANT
                and self.category_mask == ANY_CATEGORY
                and self.t_min == INT32_MIN and self.t_max == INT32_MAX)

    def signature(self) -> Tuple[int, int, int, int]:
        """Hashable identity for cache keys (exact component values)."""
        return (int(self.tenant), int(self.category_mask),
                int(self.t_min), int(self.t_max))

    def to_fvals(self) -> np.ndarray:
        return np.array(self.signature(), np.int32)


NOOP_FILTER = FilterSpec()

Filters = Union[None, FilterSpec, Sequence[Optional[FilterSpec]]]


def filter_signature(filters: Filters):
    """Hashable cache-key component. ``None`` / no-op collapse to ``None``
    so pre-filter cache entries stay valid for unfiltered queries."""
    if filters is None:
        return None
    if isinstance(filters, FilterSpec):
        return None if filters.is_noop else filters.signature()
    sigs = tuple((f.signature() if f is not None else NOOP_FILTER.signature())
                 for f in filters)
    if all(s == NOOP_FILTER.signature() for s in sigs):
        return None
    return sigs


def validate_attrs(attrs, n: int) -> torch.Tensor:
    """A per-object attribute table as an ``(n, 3)`` int32 CPU tensor;
    ``None`` gives all zeros (tenant 0, no categories, t 0)."""
    if attrs is None:
        return torch.zeros((n, N_ATTRS), dtype=torch.int32)
    if isinstance(attrs, torch.Tensor):
        attrs = attrs.cpu().numpy()
    out = np.asarray(attrs)
    if out.shape != (n, N_ATTRS):
        raise ValueError(f"attrs must be ({n}, {N_ATTRS}), got {out.shape}")
    if not np.issubdtype(out.dtype, np.integer):
        raise ValueError(f"attrs must be integer, got dtype {out.dtype}")
    return torch.from_numpy(out.astype(np.int32))


def make_attrs(tenant, category_mask=0, timestamp=0) -> np.ndarray:
    """Pack broadcastable per-object columns into an ``(n, 3)`` int32
    table."""
    t, c, ts = np.broadcast_arrays(
        np.asarray(tenant), np.asarray(category_mask), np.asarray(timestamp))
    return np.stack([t, c, ts], axis=-1).astype(np.int32).reshape(
        -1, N_ATTRS)


def compile_filters(filters: Filters, batch: int) -> Tuple[np.ndarray, bool]:
    """→ ``(fvals (batch, 4) int32, filtered)``. ``filtered`` is False when
    every row is a no-op, and callers then take the unfiltered plan."""
    if filters is None:
        specs = [NOOP_FILTER] * batch
    elif isinstance(filters, FilterSpec):
        specs = [filters] * batch
    else:
        specs = [f if f is not None else NOOP_FILTER for f in filters]
        if len(specs) != batch:
            raise ValueError(f"got {len(specs)} filters for batch {batch}")
        for f in specs:
            if not isinstance(f, FilterSpec):
                raise TypeError(f"filters must be FilterSpec, got {type(f)}")
    fvals = np.stack([f.to_fvals() for f in specs])
    return fvals, not all(f.is_noop for f in specs)


def predicate_mask(attrs: torch.Tensor, fvals: torch.Tensor) -> torch.Tensor:
    """``attrs (..., 3)`` against ``fvals (..., 4)`` (broadcastable) →
    bool ``(...)``, True where the row passes."""
    tenant, cat, ts = attrs[..., 0], attrs[..., 1], attrs[..., 2]
    f_tenant, f_mask = fvals[..., 0], fvals[..., 1]
    t_lo, t_hi = fvals[..., 2], fvals[..., 3]
    ok_tenant = (f_tenant < 0) | (tenant == f_tenant)
    ok_cat = (f_mask == 0) | ((cat & f_mask) != 0)
    ok_time = (ts >= t_lo) & (ts <= t_hi)
    return ok_tenant & ok_cat & ok_time


def predicate_mask_np(attrs, fvals) -> np.ndarray:
    """:func:`predicate_mask` on CPU tensors, for host-side oracles:
    numpy in, numpy bool out."""
    return predicate_mask(torch.as_tensor(np.asarray(attrs)),
                          torch.as_tensor(np.asarray(fvals))).numpy()
