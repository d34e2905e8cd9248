"""GatedGCN [arXiv:2003.00982] with gather / scatter-add message passing
(reference: ``repro.models.gnn``).

Message passing is ``index_select`` over the edge index (the reference's
``jnp.take``) and ``index_add`` into ``(n, d)`` zeros (its
``jax.ops.segment_sum``), plain torch on every device: the reference
computes them in jnp, outside any Pallas kernel. On a CUDA tensor the
scatter-add sums each node's messages in no fixed order, so its f32 sums
differ from the CPU's in the last bits. Three regimes, as the reference:
full-batch node classification, sampled subgraphs
(``data.graph_data.NeighborSampler``) and batched small graphs with a
graph-level mean readout over ``graph_ids``.

The reference scans its stacked layers under ``jax.checkpoint`` and
``constrain``s the node and edge states to its mesh; neither changes a
value, and the port runs one :class:`GatedGCNLayer` module per layer.

Graph dict contract (static shapes, padded):
  x          (N, d_in)   node features
  edge_src   (E,) int    message source
  edge_dst   (E,) int    message destination
  edge_attr  (E, d_e)    optional edge features (zeros if absent)
  node_mask  (N,)  bool  valid nodes
  edge_mask  (E,)  bool  valid edges
  graph_ids  (N,) int    graph id per node (batched readout) [optional]
  n_graphs   int         graphs in the batch, with ``graph_ids``
  labels     (N,) or (G,)  targets
  label_mask (N,) or (G,)  which targets count (e.g. seed nodes)
Arrays may be numpy or tensors; they are moved to the model's device.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from repro_torch.device import require_device
from repro_torch.models import layers
from repro_torch.models.layers import Dense, LayerNorm


class GatedGCNLayer(nn.Module):
    """One GatedGCN layer: ``e' = e + ReLU(LN_e(A h_dst + B h_src + C
    e))``; ``η = σ(e') · edge_mask``; ``h' = h + ReLU(LN_h(U h + Σ η ·
    V h_src / (Σ η + 1e-6)))``, the sums over each node's incoming
    edges."""

    def __init__(self, A: Dense, B: Dense, C: Dense, U: Dense, V: Dense,
                 ln_h: LayerNorm, ln_e: LayerNorm):
        super().__init__()
        self.A, self.B, self.C, self.U, self.V = A, B, C, U, V
        self.ln_h, self.ln_e = ln_h, ln_e

    def forward(self, h: torch.Tensor, e: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, emask: torch.Tensor):
        """``h (N, d)``, ``e (E, d)``, ``src`` / ``dst (E,)``, ``emask (E,
        1)`` float → ``(h', e')``. Each ``(E, d)`` temporary is dropped as
        soon as it is used: on a full-batch graph they dominate memory."""
        n, d = h.shape
        h_src = h.index_select(0, src)
        a = self.A(h.index_select(0, dst))
        a = a + self.B(h_src)
        a = a + self.C(e)
        e_new = e + torch.relu(self.ln_e(a))
        del a
        eta = torch.sigmoid(e_new) * emask
        msg = eta * self.V(h_src)
        del h_src
        agg = h.new_zeros((n, d)).index_add(0, dst, msg)
        del msg
        den = h.new_zeros((n, d)).index_add(0, dst, eta) + 1e-6
        del eta
        upd = self.U(h) + agg / den
        return h + torch.relu(self.ln_h(upd)), e_new


class GNN(nn.Module):
    """GatedGCN of ``cfg``: ``node_in (d_in → d)``, ``edge_in (max(d_e, 1)
    → d)``, ``cfg.n_layers`` :class:`GatedGCNLayer`, ``readout (d →
    n_classes)``."""

    def __init__(self, cfg, node_in: Dense, edge_in: Dense,
                 gnn_layers: Sequence[GatedGCNLayer], readout: Dense):
        super().__init__()
        if len(gnn_layers) != cfg.n_layers:
            raise ValueError(f"{len(gnn_layers)} layers for a config of "
                             f"{cfg.n_layers}")
        self.cfg = cfg
        self.node_in, self.edge_in = node_in, edge_in
        self.layers = nn.ModuleList(gnn_layers)
        self.readout = readout

    @property
    def device(self) -> torch.device:
        return self.readout.w.device


def gnn_init(cfg, d_in: int, n_classes: int, d_edge_in: int = 0, *,
             seed: int = 0, device="cuda") -> GNN:
    """A fresh :class:`GNN` at the reference's scales (``gnn_init``):
    every dense ``N(0, 1/fan_in)`` with a zero bias, unit LayerNorms, in
    ``cfg.param_dtype``. Drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``: node_in, edge_in, then per layer A, B, C, U, V,
    then the readout."""
    dev = require_device(device)
    g = layers.make_generator(seed, dev)
    d = cfg.d_hidden

    def dense(i, o):
        return layers.dense_init(g, i, o, bias=True)

    def norm():
        return layers.norm_init(d, kind="layer", device=dev)
    node_in = dense(d_in, d)
    edge_in = dense(max(d_edge_in, 1), d)
    gnn_layers = [GatedGCNLayer(*(dense(d, d) for _ in range(5)), norm(),
                                norm()) for _ in range(cfg.n_layers)]
    model = GNN(cfg, node_in, edge_in, gnn_layers, dense(d, n_classes))
    return model.to(getattr(torch, cfg.param_dtype))


def _on(model: GNN, a):
    return None if a is None else torch.as_tensor(a, device=model.device)


def gnn_forward(model: GNN, graph: dict) -> torch.Tensor:
    """Logits ``(N, n_classes)``, or ``(G, n_classes)`` for a batch of
    graphs (``graph_ids``: the mean of each graph's valid nodes)."""
    src = _on(model, graph["edge_src"]).long()
    dst = _on(model, graph["edge_dst"]).long()
    emask = _on(model, graph["edge_mask"]).float()[:, None]
    h = model.node_in(_on(model, graph["x"]))
    edge_attr = _on(model, graph.get("edge_attr"))
    if edge_attr is not None:
        e = model.edge_in(edge_attr)
    else:
        e = h.new_zeros((src.shape[0], model.cfg.d_hidden))
    for layer in model.layers:
        h, e = layer(h, e, src, dst, emask)
    del e
    graph_ids = _on(model, graph.get("graph_ids"))
    if graph_ids is not None:
        n_graphs = int(graph["n_graphs"])
        gid = graph_ids.long()
        mask = _on(model, graph["node_mask"]).to(h.dtype)[:, None]
        pooled = h.new_zeros((n_graphs, h.shape[1])).index_add(0, gid,
                                                               h * mask)
        cnt = h.new_zeros((n_graphs, 1)).index_add(0, gid, mask)
        h = pooled / torch.clamp(cnt, min=1.0)
    return model.readout(h)


def gnn_loss(model: GNN, graph: dict):
    """``(loss, {"loss", "acc"})``: over the targets ``label_mask``
    selects, the squared error of a one-logit head or the cross-entropy
    (f32 log-softmax) and accuracy of a classifier; ``acc`` is the loss
    itself for a one-logit head."""
    logits = gnn_forward(model, graph)
    labels = _on(model, graph["labels"])
    lmask = _on(model, graph["label_mask"]).float()
    if logits.shape[-1] == 1:
        loss = torch.square(logits[..., 0] - labels.float())
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    denom = torch.clamp(lmask.sum(), min=1.0)
    loss = (loss * lmask).sum() / denom
    acc = loss
    if logits.shape[-1] > 1:
        acc = ((logits.argmax(-1) == labels) * lmask).sum() / denom
    return loss, {"loss": loss, "acc": acc}
