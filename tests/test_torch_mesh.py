"""The port's sharding rules, meshes and cell plans against the reference.

* ``plan_cell`` on abstract (2, 4) ("data", "model") and (2, 2, 2)
  ("pod", "data", "model") meshes against the reference's ``plan_cell`` on
  ``jax.make_mesh`` over the 8 forced host devices (tests/conftest.py):
  the same ``skip`` and ``notes``, every argument's shape and dtype (the
  port's meta models and states brought to the reference's layout by
  ``convert.param_tree`` / ``cache_to_tree``), every input and output spec
  equal to the reference's ``PartitionSpec``; the reference's plans are
  built once per module;
* the reference's rule tests (``tests/test_sharding_rules.py`` and
  ``tests/test_substrate.py``'s planner and ``param_specs`` tests) on the
  port;
* ``named_shardings``' DTensor placements, ``leaf_specs`` and
  ``opt_state_specs`` for adamw and adafactor.
"""
import functools
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as RefNamedSharding
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import arch_ids, get_shapes
from repro.distributed import sharding as ref_sh
from repro.distributed.resilience import ElasticPlanner as RefPlanner
from repro.launch import steps as ref_steps
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.resilience import ElasticPlanner
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import steps
from repro_torch.models import transformer as tf

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}

# one cell of every kind and every cell of the cheap families: the LM
# cells each cover a part of the rules (the MoE's experts, QKV biases, a
# window's ring caches, the skips)
LM_CELLS = [("moonshot-v1-16b-a3b", "train_4k"), ("qwen2-7b", "prefill_32k"),
            ("gemma3-27b", "decode_32k"), ("kimi-k2-1t-a32b", "long_500k"),
            ("stablelm-1.6b", "long_500k")]
CELLS = LM_CELLS + [
    (a, s.name) for a in arch_ids()
    if port_configs.get_config(a).family != "lm" for s in get_shapes(a)]


@functools.lru_cache(maxsize=None)
def ref_plan(mesh_name, arch, shape):
    shape_, names = MESHES[mesh_name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ref_steps.plan_cell(arch, shape, jax.make_mesh(shape_, names))


def port_plan(mesh_name, arch, shape):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return steps.plan_cell(arch, shape,
                               port_mesh.AbstractMesh(*MESHES[mesh_name]))


def _ref_key(k):
    return str(k.key) if hasattr(k, "key") else str(k.idx)


def ref_leaves(tree, leaf=lambda x: x, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(_ref_key(k) for k in path): leaf(x) for path, x in flat}


def port_leaves(tree, leaf=lambda x: x, is_leaf=lambda x: False, path=()):
    if tree is None:
        return {}
    if is_leaf(tree):
        return {path: leaf(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: leaf(tree)}
    out = {}
    for k, v in items:
        out.update(port_leaves(v, leaf, is_leaf, path + (str(k),)))
    return out


def _as_ref_layout(arg, params):
    """A port argument in the reference's layout: a model through
    ``convert.param_tree``, an optimizer state's per-parameter lists
    likewise, a per-layer KV cache through ``cache_to_tree``."""
    if isinstance(arg, torch.nn.Module):
        return convert.param_tree(arg)
    if isinstance(arg, dict) and "step" in arg:
        index = {id(p): i for i, p in enumerate(steps.param_leaves(params))}
        return {k: convert.param_tree(
            params, leaf=lambda p, v=v: v[index[id(p)]])
            for k, v in arg.items() if k != "step"}
    if isinstance(arg, list) and arg and isinstance(arg[0], dict) \
            and set(arg[0]) == {"k", "v"}:
        return convert.cache_to_tree(arg, params.cfg)
    return arg


def _shape_dtype(x):
    name = (str(x.dtype).replace("torch.", "") if isinstance(x, torch.Tensor)
            else np.dtype(x.dtype).name)
    return tuple(x.shape), name


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_plan_matches_reference(mesh_name, arch, shape):
    want = ref_plan(mesh_name, arch, shape)
    got = port_plan(mesh_name, arch, shape)
    assert (got.arch_id, got.shape_name) == (arch, shape)
    assert got.skip == want.skip and got.notes == want.notes
    if want.skip:
        assert got.fn is None and got.args == () and got.in_shardings == ()
        return
    assert callable(got.fn) and len(got.args) == len(want.args)
    params = got.args[0]
    for i, (g, w) in enumerate(zip(got.args, want.args)):
        g = _as_ref_layout(g, params)
        if isinstance(w, dict) and "step" in w:
            w = {k: v for k, v in w.items() if k != "step"}
        gl = port_leaves(g, _shape_dtype)
        wl = ref_leaves(w, _shape_dtype)
        assert gl == wl, f"argument {i}"
        # nothing of a plan is allocated
        assert all(t.is_meta for t in port_leaves(
            got.args[i], is_leaf=lambda x: isinstance(x, torch.Tensor),
            leaf=lambda x: x).values() if isinstance(t, torch.Tensor))
    is_ns = lambda x: isinstance(x, RefNamedSharding)  # noqa: E731
    for g, w in ((got.in_shardings, want.in_shardings),
                 (got.out_shardings, want.out_shardings)):
        assert (g is None) == (w is None)
        gs = port_leaves(g, tuple, lambda x: isinstance(x, sh.Spec))
        ws = ref_leaves(w, lambda x: tuple(x.spec), is_ns)
        assert gs == ws


def test_all_cells_plan_without_allocation():
    """Every registered cell (11 archs × 4 shapes) plans on the abstract
    production meshes; the four skips are the reference's."""
    for multi_pod in (False, True):
        mesh = port_mesh.abstract_production_mesh(multi_pod=multi_pod)
        assert port_mesh.mesh_chips(mesh) == (512 if multi_pod else 256)
        skipped = []
        for arch in port_configs.arch_ids():
            for s in port_configs.get_shapes(arch):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    plan = steps.plan_cell(arch, s.name, mesh)
                if plan.skip:
                    skipped.append((arch, s.name))
                else:
                    assert callable(plan.fn) and plan.args
        assert sorted(skipped) == [
            ("kimi-k2-1t-a32b", "long_500k"),
            ("moonshot-v1-16b-a3b", "long_500k"),
            ("qwen2-7b", "long_500k"), ("stablelm-1.6b", "long_500k")]


def test_serve_plan_notes_at_production_size():
    plan = steps.plan_cell("list-dual-encoder", "serve_queries",
                           port_mesh.abstract_production_mesh())
    assert plan.notes == "c=512 cap=14336 qcap=32 dp-encoder"
    assert tuple(plan.args[4].shape) == (512, 14336, 768)


# ---------------------------------------------------------------------------
# the reference's rule tests, on the port
# ---------------------------------------------------------------------------


def test_rules_for_mesh_single_pod():
    rules = sh.rules_for_mesh(port_mesh.AbstractMesh((2, 4),
                                                      ("data", "model")))
    assert rules["dp"] == ("data",)
    assert rules["tp"] == ("model",)
    assert rules["cluster"] == ()
    assert rules["all"] == ("data", "model")
    assert rules["_sizes"] == {"data": 2, "model": 4}


def test_rules_for_mesh_multi_pod_dp_spans_axes():
    rules = sh.rules_for_mesh(port_mesh.AbstractMesh(
        (2, 2, 2), ("pod", "data", "model")))
    assert rules["dp"] == ("pod", "data")
    assert rules["tp"] == ("model",)


def test_rules_for_mesh_cluster_axis():
    rules = sh.rules_for_mesh(sh.cluster_mesh(4, device="cpu"))
    assert rules["cluster"] == (sh.CLUSTER_AXIS,)
    assert rules["dp"] == () and rules["tp"] == ()
    assert rules["_sizes"] == {sh.CLUSTER_AXIS: 4}


def test_logical_spec_under_rules():
    mesh = port_mesh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    ref_mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    for logical in (("dp", None, "tp"), (None, "tp"), ("nope",)):
        with sh.axis_rules(sh.rules_for_mesh(mesh)):
            got = sh.logical_spec(*logical)
        with ref_sh.axis_rules(ref_sh.rules_for_mesh(ref_mesh)):
            want = ref_sh.logical_spec(*logical)
        assert got == tuple(want)
    with sh.axis_rules(sh.rules_for_mesh(mesh)):
        assert sh.logical_spec("dp", None, "tp") == (("pod", "data"), None,
                                                     "model")
        assert sh.logical_spec("nope") == (None,)


def test_logical_spec_is_none_outside_binding():
    assert sh.current_rules() is None
    assert sh.logical_spec("dp", "tp") is None
    x = torch.ones(4, 4)
    assert sh.constrain(x, "dp", "tp") is x
    with sh.axis_rules(sh.rules_for_mesh(port_mesh.AbstractMesh(
            (2,), ("model",)))):
        assert sh.current_rules()["tp"] == ("model",)
        assert sh.constrain(x, None, "tp") is x       # a local block
    assert sh.current_rules() is None


def _model_rules(n=2):
    return sh.rules_for_mesh(port_mesh.AbstractMesh((n,), ("model",)))


def test_param_specs_divisible_dim_shards():
    with sh.axis_rules(_model_rules()):
        specs = sh.param_specs({"tables": torch.zeros(8, 4)},
                               sh.REC_PARAM_RULES)
    assert specs["tables"] == ("model", None)


def test_param_specs_nondivisible_dim_warns_and_replicates():
    with sh.axis_rules(_model_rules()):
        with pytest.warns(UserWarning, match="not divisible"):
            specs = sh.param_specs({"tables": torch.zeros(7, 4)},
                                   sh.REC_PARAM_RULES)
    assert specs["tables"] == (None, None)


def test_param_specs_leading_scan_dims_padded():
    with sh.axis_rules(_model_rules()):
        specs = sh.param_specs({"item_embed": torch.zeros(3, 8, 4)},
                               sh.REC_PARAM_RULES)
    assert specs["item_embed"] == (None, "model", None)


def test_param_specs_divisibility_guard():
    rules = {"dp": ("data",), "tp": ("model",),
             "_sizes": {"data": 16, "model": 16}}
    shapes = {"item_embed": torch.empty(1000001, 64, device="meta"),
              "tables": [torch.empty(512, 64, device="meta")]}
    with sh.axis_rules(rules), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        specs = sh.param_specs(shapes, sh.REC_PARAM_RULES)
    assert specs["item_embed"] == (None, None)
    assert specs["tables"][0] == ("model", None)


def test_param_specs_lm_rules():
    rules = {"dp": ("pod", "data"), "tp": ("model",),
             "_sizes": {"pod": 2, "data": 16, "model": 16}}
    shapes = {"periods": {"attn": {"wq": {"w": torch.empty(
        4, 1, 2048, 4096, device="meta")}}},
        "embed": torch.empty(32768, 2048, device="meta")}
    with sh.axis_rules(rules):
        specs = sh.param_specs(shapes, sh.LM_PARAM_RULES)
    assert specs["periods"]["attn"]["wq"]["w"] == (
        None, None, ("pod", "data"), "model")
    assert specs["embed"] == ("model", ("pod", "data"))


def test_param_specs_none_outside_binding():
    assert sh.param_specs({"a": torch.zeros(2)}, sh.REC_PARAM_RULES) == \
        {"a": None}


@pytest.mark.parametrize("pods", range(5))
def test_elastic_planner(pods):
    got = ElasticPlanner(chips_per_pod=256, tp_divisor=16, global_batch=256)
    want = RefPlanner(chips_per_pod=256, tp_divisor=16, global_batch=256)
    g, w = got.plan(pods), want.plan(pods)
    assert (g is None) == (w is None)
    if w is not None:
        assert (g.shape, g.axes, g.n_chips, g.reason) == (
            w.shape, w.axes, w.n_chips, w.reason)
    if pods == 2:
        assert g.shape == (2, 16, 16) and g.n_chips == 512
    if pods == 3:
        assert g.shape == (2, 16, 16)       # 256 % 3 != 0: two pods


# ---------------------------------------------------------------------------
# placements, leaf specs, optimizer specs
# ---------------------------------------------------------------------------


def test_named_shardings_maps_tree_with_none_leaves():
    mesh = port_mesh.AbstractMesh((2,), ("model",))
    out = sh.named_shardings(mesh, {"a": sh.spec("model", None), "b": None,
                                    "nested": {"c": sh.spec(None)}})
    assert out["a"].placements == (Shard(0),)
    assert out["b"].spec == () and out["b"].placements == (Replicate(),)
    assert out["nested"]["c"].placements == (Replicate(),)


def test_named_shardings_dim_over_two_axes():
    """A dim over ("pod", "data") shards on both mesh dims, the pod axis
    major, as DTensor orders several mesh dims on one tensor dim."""
    mesh = port_mesh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    ns = sh.named_shardings(mesh, {"w": sh.spec(("pod", "data"), "model")},
                            {"w": torch.empty(8, 6, device="meta")})
    assert ns["w"].placements == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements(mesh, sh.spec(("data", "pod")))


def test_named_shardings_nondivisible_dim_replicated_with_warning():
    mesh = port_mesh.AbstractMesh((2, 4), ("data", "model"))
    with pytest.warns(UserWarning, match="not divisible"):
        ns = sh.named_shardings(mesh, {"w": sh.spec("data", "model")},
                                {"w": torch.empty(6, 6, device="meta")})
    # never DTensor's uneven split: model (4) does not divide 6
    assert ns["w"].placements == (Shard(0), Replicate())


def test_leaf_specs_drop_the_stacked_dims():
    cfg = port_configs.reduced(port_configs.get_config("gemma3-27b"))
    model = tf.lm_init(cfg, device="meta")
    mesh = port_mesh.AbstractMesh((2, 4), ("data", "model"))
    tree = convert.param_tree(model)
    with sh.axis_rules(sh.rules_for_mesh(mesh)):
        specs = sh.param_specs(tree, sh.LM_PARAM_RULES)
    pairs = sh.leaf_specs(model, specs)
    assert {id(p) for p, _ in pairs} == {id(p) for p in model.parameters()}
    for p, s in pairs:
        assert len(s) == p.ndim
    by_id = {id(p): s for p, s in pairs}
    blk = model.blocks[1]
    assert by_id[id(blk.wq.w)] == ("data", "model")
    assert by_id[id(blk.wo.w)] == ("model", "data")
    assert by_id[id(model.embed)] == ("model", "data")
    assert by_id[id(blk.ln1.scale)] == (None,)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_opt_state_specs_match_reference(optimizer):
    mesh_shape, names = MESHES["2x4"]
    ref_mesh = jax.make_mesh(mesh_shape, names)
    mesh = port_mesh.AbstractMesh(mesh_shape, names)
    shapes = {"embed": torch.empty(64, 16, device="meta"),
              "periods": {"w": torch.empty(3, 1, 16, 32, device="meta"),
                          "scale": torch.empty(3, 1, 16, device="meta")},
              "bias": torch.empty(8, 1, device="meta")}
    ref_shapes = jax.tree.map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), np.float32), shapes)
    rules = ((r"embed$", ("tp", "dp")), (r"w$", ("dp", "tp")),
             (r".*", (None,)))
    with sh.axis_rules(sh.rules_for_mesh(mesh)):
        got = sh.opt_state_specs(shapes, sh.param_specs(shapes, rules),
                                 optimizer)
    with ref_sh.axis_rules(ref_sh.rules_for_mesh(ref_mesh)):
        want = ref_sh.opt_state_specs(
            ref_shapes, ref_sh.param_specs(ref_shapes, rules), optimizer)
    gs = port_leaves(got, tuple, lambda x: isinstance(x, sh.Spec))
    ws = ref_leaves(want, tuple, lambda x: isinstance(x, P))
    assert gs == ws
