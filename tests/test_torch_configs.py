"""The port's config registry against the reference's.

Same arch ids; every config, shape cell and reduced config field-equal
(``dataclasses.asdict``); the helpers (``pattern``, ``n_params``,
``n_active_params``, ``is_moe``) agree; ``list-dual-encoder`` is still the
config the LIST path hashes into a snapshot's ``cfg_digest``.
"""
import dataclasses

import pytest

from repro import configs as ref_configs
from repro.configs import base as ref_base
from repro_torch import configs as port_configs
from repro_torch.configs import base as port_base

ARCHS = ref_configs.arch_ids()


def test_registry_complete():
    """tests/test_arch_smoke.py's registry test on the port, and the same
    ids as the reference."""
    expect = {"gemma3-27b", "stablelm-1.6b", "qwen2-7b",
              "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "gatedgcn",
              "mind", "bert4rec", "xdeepfm", "dlrm-mlperf",
              "list-dual-encoder"}
    assert expect <= set(port_configs.arch_ids())
    assert port_configs.arch_ids() == ref_configs.arch_ids()
    for a in expect:
        assert len(port_configs.get_shapes(a)) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal(arch):
    got, want = port_configs.get_config(arch), ref_configs.get_config(arch)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(port_configs.reduced(got)) == \
        dataclasses.asdict(ref_configs.reduced(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_equal(arch):
    got = port_configs.get_shapes(arch)
    want = ref_configs.get_shapes(arch)
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    for s in want:
        assert dataclasses.asdict(port_configs.get_shape(arch, s.name)) == \
            dataclasses.asdict(s)


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if ref_configs.get_config(a).family == "lm"])
def test_lm_helpers(arch):
    got, want = port_configs.get_config(arch), ref_configs.get_config(arch)
    assert got.pattern() == want.pattern()
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params()
    assert got.is_moe == want.is_moe


def test_shape_tables():
    for full in (False, True):
        assert [dataclasses.asdict(s) for s in
                port_base.lm_shapes("x", full_attention_only=full)] == \
            [dataclasses.asdict(s) for s in
             ref_base.lm_shapes("x", full_attention_only=full)]
    for name in ("GNN_SHAPES", "REC_SHAPES"):
        assert [dataclasses.asdict(s) for s in getattr(port_base, name)] == \
            [dataclasses.asdict(s) for s in getattr(ref_base, name)]


def test_list_dual_encoder_unchanged():
    """The LIST path's config is the same dataclass and values as before
    the registry grew, and SERVE_QUERIES is its serve_queries cell."""
    cfg = port_configs.get_config("list-dual-encoder")
    assert type(cfg) is port_base.DualEncoderConfig
    assert cfg == port_base.DualEncoderConfig()
    assert port_configs.SERVE_QUERIES == dict(
        query_batch=4096, n_objects=2_849_754, n_clusters=300, topk=20)


def test_unknown_arch_and_shape_raise():
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.get_config("nope")
    with pytest.raises(KeyError, match="no shape"):
        port_configs.get_shape("qwen2-7b", "nope")


def test_reduced_rejects_unknown_config():
    with pytest.raises(TypeError):
        port_configs.reduced(object())
