"""The system under test: the port's ``repro_torch.api.Searcher`` over a
snapshot built by the port from the benchmark's inputs, and the recorder
that reads the scans' routes in a traced run.

The port derives everything it serves: its modules from the weight tree
(``convert.params_from_numpy``), the location normalizer, each object's
preferred clusters (``index.assign_clusters``) and the cluster buffers at
the configuration's tier (``index.build_cluster_buffers``, whose spill
walk runs on the host).
"""
from __future__ import annotations

import contextlib

import torch

from listbench import inputs as inputs_lib

ROUTE_BLOCK = 1 << 18


def port_config(cfg: dict):
    from repro_torch.configs.base import DualEncoderConfig
    return DualEncoderConfig(
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], max_len=cfg["max_position_embeddings"],
        norm_eps=cfg["layer_norm_eps"], param_dtype=cfg["param_dtype"],
        compute_dtype=cfg["compute_dtype"], spatial_t=cfg["spatial_t"],
        n_clusters=cfg["n_clusters"],
        index_mlp_hidden=tuple(cfg["router_hidden"]))


def build_searcher(cfg: dict, seed: int, device):
    """The port's searcher over the index of ``cfg`` and ``seed``, on
    ``device`` (the engine picks its backend: ``auto``)."""
    from repro_torch import api, convert
    from repro_torch.core import index as index_lib
    from repro_torch.core.snapshot import IndexSnapshot

    pcfg = port_config(cfg)
    tree = inputs_lib.weights(cfg, seed, device)
    rel, index = convert.params_from_numpy(tree["rel"], tree["index"], pcfg)
    emb, loc = inputs_lib.objects(cfg, seed, device)
    with torch.no_grad():
        norm = index_lib.loc_normalizer(loc)
        assign = torch.cat([
            index_lib.assign_clusters(
                index, index_lib.build_features(emb[s:s + ROUTE_BLOCK],
                                                loc[s:s + ROUTE_BLOCK], norm),
                top=cfg["spill"])
            for s in range(0, emb.shape[0], ROUTE_BLOCK)])
        buffers = index_lib.build_cluster_buffers(
            assign.cpu().numpy(), emb, loc, n_clusters=cfg["n_clusters"],
            capacity=cfg["capacity"], spill=cfg["spill"],
            precision=cfg["precision"])
    del emb, loc, assign
    snap = IndexSnapshot.from_parts(pcfg, rel, index, norm, buffers,
                                    dist_max=cfg["dist_max"])
    return api.Searcher(snap, backend="auto", device=device)


def warm_backends(searcher, tok, msk, loc, *, k: int, cr: int, batch: int):
    """One chunk through each scan the engine's ``auto`` pick may choose
    for these shapes, then one call as the window makes it."""
    from repro_torch.core import engine as engine_lib
    snap = searcher.snapshot
    c, cap = snap.buffers["emb"].shape[:2]
    base = engine_lib.resolve_backend("auto", snap.device)
    targets = [base]
    if engine_lib.cluster_major_feasible(batch, cr, c, cap):
        targets.append(engine_lib.cluster_major_variant(base, float("inf")))
    for backend in targets:
        searcher.query(tok[:batch], msk[:batch], loc[:batch], k=k, cr=cr,
                       batch=batch, backend=backend)
    searcher.query(tok, msk, loc, k=k, cr=cr, batch=batch)


class RouteRecorder:
    """Records, while open, the routes and cluster loads of every scan the
    engine runs (``core.engine._routed_topk``): ``(top_c (B, cr), counts
    (c,))`` device tensors, kept without a sync. Records nothing where the
    engine has no such function: a traced offline run then fails, its
    scan metrics having nothing to read (``run.NothingToRead``)."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.core import engine as engine_lib
        orig = getattr(engine_lib, "_routed_topk", None)
        if orig is None:
            yield self
            return

        def wrapped(q_emb, q_loc, w, top_c, buffers, *args, **kw):
            self.calls.append((top_c, buffers["counts"]))
            return orig(q_emb, q_loc, w, top_c, buffers, *args, **kw)

        engine_lib._routed_topk = wrapped
        try:
            yield self
        finally:
            engine_lib._routed_topk = orig

    def scans(self):
        """Per recorded scan: ``(pairs, pair_rows, distinct_rows)`` — its
        (query, route) pairs, the live rows those pairs score, and the live
        rows of their distinct clusters."""
        out = []
        for top_c, counts in self.calls:
            live = counts.long()
            pair_rows = int(live[top_c.long()].sum())
            distinct = int(live[torch.unique(top_c.long())].sum())
            out.append((top_c.numel(), pair_rows, distinct))
        return out
