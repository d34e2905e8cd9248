"""The port's GatedGCN and graph data (``repro_torch.models.gnn``,
``repro_torch.data.graph_data``) against the reference's, on the CPU.

The generators and the neighbor sampler are the reference's numpy code,
copied: the same seed gives bit-equal arrays. The GNN cases are
``tests/test_arch_smoke.py``'s three (a community graph, a batch of
molecules with edge features and the ``graph_ids`` readout, a sampled
subgraph), run on both packages with the reference's ``gnn_init`` weights
carried across by ``convert.gnn_from_numpy``: logits and loss at 1e-5,
the loss's gradients at 1e-4 of each leaf's largest. The ``cuda``-marked
case runs a forward on the card against the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.data import graph_data as ref_graph
from repro.models import gnn as ref_gnn
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.data import graph_data as port_graph
from repro_torch.models import gnn

from test_torch_common import np_tree, ref_on_cpu

KEY = jax.random.PRNGKey(0)          # tests/test_arch_smoke.py's
F32 = dict(rtol=1e-5, atol=1e-5)


def _assert_graphs_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if w is None or isinstance(w, int):
            assert g == w, k
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# ---------------------------------------------------------------------------
# The graph data, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args,seed", [((100, 400, 16, 5), 0),
                                       ((500, 3000, 16, 5), 1),
                                       ((257, 2000, 7, 3), 9)])
def test_community_graph_matches_reference(args, seed):
    _assert_graphs_equal(port_graph.community_graph(*args, seed=seed),
                         ref_graph.community_graph(*args, seed=seed))


@pytest.mark.parametrize("args,seed", [((8, 10, 20, 16), 0),
                                       ((128, 30, 64, 16), 3)])
def test_molecule_batch_matches_reference(args, seed):
    _assert_graphs_equal(port_graph.molecule_batch(*args, seed=seed),
                         ref_graph.molecule_batch(*args, seed=seed))


@pytest.mark.parametrize("fanout,seed", [((5, 3), 0), ((15, 10), 4)])
def test_neighbor_sampler_matches_reference(fanout, seed):
    g = ref_graph.community_graph(500, 3000, 16, 5, seed=1)
    ref_ns = ref_graph.NeighborSampler(g["edge_src"], g["edge_dst"], 500)
    ns = port_graph.NeighborSampler(g["edge_src"], g["edge_dst"], 500)
    np.testing.assert_array_equal(ns.nbr, ref_ns.nbr)
    np.testing.assert_array_equal(ns.ptr, ref_ns.ptr)
    seeds = np.arange(32)
    for got, want in zip(ns.sample(seeds, fanout, seed=seed),
                         ref_ns.sample(seeds, fanout, seed=seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    kw = dict(pad_nodes=1024, pad_edges=4096, seed=seed)
    _assert_graphs_equal(
        ns.padded_batch(seeds, fanout, g["x"], g["labels"], **kw),
        ref_ns.padded_batch(seeds, fanout, g["x"], g["labels"], **kw))
    with pytest.raises(ValueError, match="exceeds padding"):
        ns.padded_batch(seeds, fanout, g["x"], g["labels"], pad_nodes=16,
                        pad_edges=16)


# ---------------------------------------------------------------------------
# The GNN on both packages
# ---------------------------------------------------------------------------


def _models(d_in, n_classes, d_edge_in=0):
    rcfg = ref_configs.reduced(ref_configs.get_config("gatedgcn"))
    pcfg = port_configs.reduced(port_configs.get_config("gatedgcn"))
    with ref_on_cpu():
        params = ref_gnn.gnn_init(KEY, rcfg, d_in, n_classes, d_edge_in)
    return rcfg, params, convert.gnn_from_numpy(np_tree(params), pcfg)


def _ref_graph(g):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in g.items()}


def _sampled():
    g = ref_graph.community_graph(500, 3000, 16, 5, seed=1)
    ns = ref_graph.NeighborSampler(g["edge_src"], g["edge_dst"], 500)
    return ns.padded_batch(np.arange(32), (5, 3), g["x"], g["labels"],
                           pad_nodes=512, pad_edges=1024, seed=0)


GRAPHS = {
    "community": (lambda: ref_graph.community_graph(100, 400, 16, 5, seed=0),
                  (16, 5, 0), (100, 5)),
    "molecules": (lambda: ref_graph.molecule_batch(8, 10, 20, 16, seed=0),
                  (16, 1, 4), (8, 1)),
    "sampled": (_sampled, (16, 5, 0), (512, 5)),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gnn_matches_reference(name):
    """tests/test_arch_smoke.py's three GNN cases on both packages: the
    logits' shape, finite losses, the seed-only label mask; logits, loss
    and accuracy at 1e-5."""
    make, dims, shape = GRAPHS[name]
    graph = make()
    rcfg, params, model = _models(*dims)
    with ref_on_cpu():
        rg = _ref_graph(graph)
        want = ref_gnn.gnn_forward(params, rg, rcfg)
        w_loss, w_m = ref_gnn.gnn_loss(params, rg, rcfg)
    got = gnn.gnn_forward(model, graph)
    g_loss, g_m = gnn.gnn_loss(model, graph)
    assert tuple(got.shape) == tuple(want.shape) == shape
    assert np.isfinite(float(g_loss))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(g_loss), float(w_loss), **F32)
    np.testing.assert_allclose(float(g_m["acc"]), float(w_m["acc"]), **F32)
    if name == "sampled":
        assert float(np.asarray(graph["label_mask"]).sum()) == 32


@pytest.mark.parametrize("name", ["community", "molecules"])
def test_gnn_loss_grads_match_reference(name):
    make, dims, _ = GRAPHS[name]
    graph = make()
    rcfg, params, model = _models(*dims)
    with ref_on_cpu():
        rg = _ref_graph(graph)
        want = jax.grad(lambda p: ref_gnn.gnn_loss(p, rg, rcfg)[0])(params)
    gnn.gnn_loss(model, graph)[0].backward()
    grads = {"node_in": model.node_in, "edge_in": model.edge_in,
             "readout": model.readout}
    for key, mod in grads.items():
        for leaf in ("w", "b"):
            w = np.asarray(want[key][leaf])
            np.testing.assert_allclose(
                convert.grad_or_zeros(getattr(mod, leaf)).numpy(), w,
                rtol=1e-4,
                atol=1e-4 * max(np.abs(w).max(), 1e-6), err_msg=key)
    for key in ("A", "B", "C", "U", "V"):
        for leaf in ("w", "b"):
            w = np.asarray(want["blocks"][key][leaf])
            g = np.stack([getattr(getattr(m, key), leaf).grad.numpy()
                          for m in model.layers])
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * max(np.abs(w).max(),
                                                       1e-6), err_msg=key)


def test_gnn_weights_round_trip():
    _, params, model = _models(16, 1, 4)
    back = convert.gnn_to_numpy(model)
    want = np_tree(params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_gnn_init_matches_reference_layout():
    """The port's own init: the reference's leaf shapes and dtypes, unit
    LayerNorms, zero biases, kernels at 1/√fan_in."""
    rcfg = ref_configs.get_config("gatedgcn")
    cfg = port_configs.get_config("gatedgcn")
    model = gnn.gnn_init(cfg, 602, 41, device="cpu")
    with ref_on_cpu():
        want = np_tree(ref_gnn.gnn_init(KEY, rcfg, 602, 41))
    got = convert.gnn_to_numpy(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
    assert len(model.layers) == 16
    assert not got["blocks"]["A"]["b"].any()
    assert (got["blocks"]["ln_h"]["scale"] == 1).all()
    assert got["node_in"]["w"].std() == pytest.approx(602 ** -0.5, rel=0.05)


def test_gnn_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        gnn.gnn_init(port_configs.get_config("gatedgcn"), 8, 2)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_cuda_gnn_matches_cpu(cuda_device, name):
    """The forward and loss on the card against the CPU's: the card's
    scatter-add sums in another order, so 1e-4 over the 3 layers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    make, dims, _ = GRAPHS[name]
    graph = make()
    _, _, model = _models(*dims)
    want = gnn.gnn_forward(model, graph).detach()
    w_loss = gnn.gnn_loss(model, graph)[0].item()
    model.to(cuda_device)
    got = gnn.gnn_forward(model, graph).detach().cpu()
    g_loss = gnn.gnn_loss(model, graph)[0].item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(g_loss, w_loss, rtol=1e-4)
