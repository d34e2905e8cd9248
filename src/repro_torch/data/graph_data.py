"""Graph generators + fanout neighbor sampler (GNN shapes): the port's own
copy of ``repro.data.graph_data`` (numpy only; the same seed gives the
same arrays, bit for bit).

- ``community_graph``: planted-partition graph with community-correlated
  features/labels (full-batch cells: full_graph_sm, ogb_products geometry).
- ``molecule_batch``: batched small graphs with graph-level labels.
- ``NeighborSampler``: real fanout sampling (15-10 style) over a CSR adjacency
  built once; emits padded static-shape subgraphs (minibatch_lg cell).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def community_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                    *, seed: int = 0, homophily: float = 0.8):
    """Random graph with planted communities. Returns a graph dict (numpy)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n_nodes)
    # community-informative features + noise
    centers = rng.normal(0, 1, size=(n_classes, d_feat))
    x = centers[labels] + rng.normal(0, 1.0, size=(n_nodes, d_feat))
    # edges: homophilous within class, else random
    src = rng.integers(0, n_nodes, size=n_edges)
    same = rng.random(n_edges) < homophily
    # destination from same class where homophilous (approx via resample)
    dst = rng.integers(0, n_nodes, size=n_edges)
    # cheap homophily: redirect same-class edges to a random same-class node
    order = np.argsort(labels, kind="stable")
    cls_start = np.searchsorted(labels[order], np.arange(n_classes))
    cls_end = np.append(cls_start[1:], n_nodes)
    lab_src = labels[src]
    lo = cls_start[lab_src]
    hi = np.maximum(cls_end[lab_src], lo + 1)
    redirect = order[(lo + rng.integers(0, 1 << 30, size=n_edges)
                      % np.maximum(hi - lo, 1))]
    dst = np.where(same, redirect, dst)
    return {
        "x": x.astype(np.float32),
        "edge_src": src.astype(np.int32),
        "edge_dst": dst.astype(np.int32),
        "edge_attr": None,
        "node_mask": np.ones(n_nodes, bool),
        "edge_mask": np.ones(n_edges, bool),
        "labels": labels.astype(np.int32),
        "label_mask": np.ones(n_nodes, np.float32),
    }


def molecule_batch(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                   *, seed: int = 0):
    """Batched small graphs, one regression target per graph."""
    rng = np.random.default_rng(seed)
    N, E = batch * n_nodes, batch * n_edges
    x = rng.normal(0, 1, size=(N, d_feat)).astype(np.float32)
    # edges within each graph
    src = (rng.integers(0, n_nodes, size=E)
           + np.repeat(np.arange(batch), n_edges) * n_nodes)
    dst = (rng.integers(0, n_nodes, size=E)
           + np.repeat(np.arange(batch), n_edges) * n_nodes)
    graph_ids = np.repeat(np.arange(batch), n_nodes)
    # target: mean feature norm per graph (learnable from x)
    tgt = x.reshape(batch, n_nodes, d_feat).mean((1, 2))
    return {
        "x": x,
        "edge_src": src.astype(np.int32),
        "edge_dst": dst.astype(np.int32),
        "edge_attr": rng.normal(0, 1, size=(E, 4)).astype(np.float32),
        "node_mask": np.ones(N, bool),
        "edge_mask": np.ones(E, bool),
        "graph_ids": graph_ids.astype(np.int32),
        "n_graphs": batch,
        "labels": tgt.astype(np.float32),
        "label_mask": np.ones(batch, np.float32),
    }


class NeighborSampler:
    """Fanout neighbor sampler over a CSR adjacency (GraphSAGE-style).

    Produces padded, static-shape subgraphs: seeds -> fanout[0] neighbors ->
    fanout[1] neighbors of those, etc. Loss is computed on seed nodes only
    (label_mask marks them).
    """

    def __init__(self, edge_src, edge_dst, n_nodes: int):
        order = np.argsort(edge_dst, kind="stable")
        self.nbr = edge_src[order]                     # in-neighbors per dst
        counts = np.bincount(edge_dst, minlength=n_nodes)
        self.ptr = np.concatenate([[0], np.cumsum(counts)])
        self.n_nodes = n_nodes

    def sample(self, seeds: np.ndarray, fanout: Sequence[int], *, seed: int = 0):
        rng = np.random.default_rng(seed)
        layers = [seeds.astype(np.int64)]
        edges_s, edges_d = [], []
        frontier = seeds.astype(np.int64)
        for f in fanout:
            lo, hi = self.ptr[frontier], self.ptr[frontier + 1]
            deg = hi - lo
            # sample f neighbors (with replacement; isolated nodes self-loop)
            off = rng.integers(0, 1 << 62, size=(len(frontier), f))
            idx = lo[:, None] + off % np.maximum(deg, 1)[:, None]
            nb = np.where(deg[:, None] > 0, self.nbr[idx], frontier[:, None])
            edges_s.append(nb.reshape(-1))
            edges_d.append(np.repeat(frontier, f))
            frontier = np.unique(nb.reshape(-1))
            layers.append(frontier)
        # relabel to compact local ids
        nodes = np.unique(np.concatenate(layers))
        remap = {g: l for l, g in enumerate(nodes.tolist())}
        src = np.array([remap[g] for g in np.concatenate(edges_s).tolist()],
                       np.int32)
        dst = np.array([remap[g] for g in np.concatenate(edges_d).tolist()],
                       np.int32)
        seed_local = np.array([remap[g] for g in seeds.tolist()], np.int32)
        return nodes, src, dst, seed_local

    def padded_batch(self, seeds, fanout, x, labels, *, pad_nodes: int,
                     pad_edges: int, seed: int = 0):
        nodes, src, dst, seed_local = self.sample(seeds, fanout, seed=seed)
        n, e = len(nodes), len(src)
        if n > pad_nodes or e > pad_edges:
            raise ValueError(f"sample ({n} nodes, {e} edges) exceeds padding "
                             f"({pad_nodes}, {pad_edges})")
        xb = np.zeros((pad_nodes, x.shape[1]), np.float32)
        xb[:n] = x[nodes]
        lb = np.zeros(pad_nodes, np.int32)
        lb[:n] = labels[nodes]
        lmask = np.zeros(pad_nodes, np.float32)
        lmask[seed_local] = 1.0
        sp = np.zeros(pad_edges, np.int32)
        dp = np.zeros(pad_edges, np.int32)
        sp[:e], dp[:e] = src, dst
        emask = np.zeros(pad_edges, bool)
        emask[:e] = True
        nmask = np.zeros(pad_nodes, bool)
        nmask[:n] = True
        return {
            "x": xb, "edge_src": sp, "edge_dst": dp, "edge_attr": None,
            "node_mask": nmask, "edge_mask": emask,
            "labels": lb, "label_mask": lmask,
        }
