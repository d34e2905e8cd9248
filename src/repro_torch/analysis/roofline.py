"""Three-term roofline of a cell on H100s (reference:
``repro.analysis.roofline``).

  compute    = FLOPs / peak FLOP/s            (per card)
  memory     = bytes / HBM rate               (per card)
  collective = wire bytes / link rate         (per card)

The peaks are the published H100 SXM data sheet's; the card the port
runs on is "NVIDIA H100 80GB HBM3, 700.00 W" (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``). They replace the
reference's TPU v5e constants (``repro/launch/mesh.py:16–19``), which
belong to its chip:

* HBM3: 3.35e12 B/s (:data:`HBM_BYTES_PER_S`);
* f32 on the CUDA cores: 67e12 FLOP/s (:data:`F32_FLOPS_PER_S`; the
  kernels' f32 FMAs);
* bf16 dense on the tensor cores: 989e12 FLOP/s
  (:data:`BF16_FLOPS_PER_S`; the reference's roofline takes its bf16
  peak, so :func:`roofline_terms` does too);
* NVLink 4: 450e9 B/s per direction, the data sheet's 900 GB/s
  bidirectional (:data:`NVLINK_BYTES_PER_S`), within one HGX node of
  :data:`NODE_SIZE` = 8 cards;
* between nodes one 400 Gb/s NIC per card: 50e9 B/s
  (:data:`NIC_BYTES_PER_S`).

No link rate here is measured: the machine the port runs on has one
GPU. A collective whose group holds more than :data:`NODE_SIZE` cards
crosses nodes and is charged to the NIC, where the reference split at
its pod of 256 chips. The records keep the reference's key names:
``ici_*`` is the traffic within a node (NVLink), ``dcn_*`` the traffic
between nodes (the NIC).

Collective wire bytes per card follow ring algorithms
(:func:`wire_bytes`, the arithmetic of the reference's
``collective_bytes``):

  all-gather          out_bytes · (n-1)/n
  reduce-scatter      out_bytes · n · (n-1)/n   (the result is 1/n)
  all-reduce          2 · bytes · (n-1)/n
  all-to-all          bytes · (n-1)/n
  collective-permute  bytes
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

# published H100 SXM peaks (data sheet), per card
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # CUDA cores: the kernels run f32 FMAs
BF16_FLOPS_PER_S = 989e12        # tensor cores, dense
NVLINK_BYTES_PER_S = 450e9       # per direction (900 GB/s bidirectional)
NIC_BYTES_PER_S = 50e9           # one 400 Gb/s NIC per card
NODE_SIZE = 8                    # cards in one HGX node's NVLink domain

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Wire bytes per card of one ``kind`` collective over a group of
    ``n`` cards whose per-card result is ``nbytes``."""
    frac = (n - 1) / n
    if kind == "all-gather":
        return nbytes * frac
    if kind == "reduce-scatter":
        return nbytes * n * frac
    if kind == "all-reduce":
        return 2 * nbytes * frac
    if kind == "all-to-all":
        return nbytes * frac
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {kind!r}")


def collectives(items: Iterable[Tuple[str, float, int]], *,
                node_size: int = NODE_SIZE) -> Dict[str, float]:
    """``[(kind, result bytes per card, group size)]`` → wire bytes per
    card by kind, ``ici_bytes`` (groups within a node), ``dcn_bytes``
    (groups of more than ``node_size`` cards) and ``total``: the
    reference's ``collective_bytes`` record."""
    out = {k: 0.0 for k in COLLECTIVES}
    out["ici_bytes"] = 0.0
    out["dcn_bytes"] = 0.0
    for kind, nbytes, n in items:
        wire = wire_bytes(kind, nbytes, n)
        out[kind] += wire
        out["dcn_bytes" if n > node_size else "ici_bytes"] += wire
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def roof(nbytes, flops, peak) -> dict:
    """The least time of one launch: the larger of its bytes over the HBM
    rate and its FLOPs over ``peak``, in ms, with what bounds it."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / peak * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                bytes=int(nbytes), flops=int(flops))


def roofline_terms(flops: float, bytes_accessed: float,
                   coll: Dict[str, float], *,
                   peak_flops: float = BF16_FLOPS_PER_S,
                   hbm: float = HBM_BYTES_PER_S,
                   link: float = NVLINK_BYTES_PER_S,
                   network: float = NIC_BYTES_PER_S) -> Dict[str, float]:
    """All inputs are per card; the three terms in seconds, the bottleneck,
    the least step time and the compute term's share of it. The peaks
    default to the H100's; the reference's constants give the reference's
    dict."""
    compute_s = flops / peak_flops
    memory_s = bytes_accessed / hbm
    ici_s = coll.get("ici_bytes", 0.0) / link
    dcn_s = coll.get("dcn_bytes", 0.0) / network
    collective_s = ici_s + dcn_s
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s, "ici_s": ici_s, "dcn_s": dcn_s}
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom
    step_s = max(compute_s, memory_s, collective_s)
    terms["step_time_lb_s"] = step_s
    terms["roofline_fraction"] = (compute_s / step_s) if step_s > 0 else 0.0
    return terms


def model_flops(cfg, *, tokens: Optional[int] = None, train: bool = True,
                extra: float = 0.0) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for LM configs;
    ``extra`` lets callers add attention FLOPs etc. GLOBAL (all cards)."""
    if hasattr(cfg, "n_active_params"):
        n = cfg.n_active_params()
    elif hasattr(cfg, "n_params"):
        n = cfg.n_params()
    else:
        return 0.0
    mult = 6.0 if train else 2.0
    return mult * n * (tokens or 0) + extra
