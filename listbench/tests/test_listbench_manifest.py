"""``BENCHMARK.json`` against the rules its files follow: names and units
of the allowed characters, each per-layer metric's ``moves`` reported in
its cells, every cell's files found by name, and no result without a
card."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from listbench import manifest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(MAN) == TOP_KEYS
    assert MAN["paths"] == ["listbench"]
    assert 1 <= MAN["run_seconds"] <= 51


def all_names():
    out = [c["name"] for c in MAN["configs"]]
    for w in MAN["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    for c in MAN["configs"]:
        out += c["reduced"]
    return out


@pytest.mark.parametrize("name", all_names())
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_unit_better_and_source(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    allowed = ({"host_clock", "device_trace"} if "bound" in metric else
               {"device_trace", "program_span", "program_counter",
                "host_clock"})
    assert metric["source"] in allowed


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_in_every_listed_cell(metric):
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric["workloads"]:
        moved = e2e[metric["moves"]]
        assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_its_files(cell):
    man = manifest.load()
    cfg = manifest.config(man, cell)
    assert cfg["name"] == cell["config"]
    traffic = manifest.traffic(cell)
    assert traffic["k"] > 0 and traffic["cr"] <= cfg["n_clusters"]
    mix = manifest.generator(traffic)
    for fn in ("make", "first", "warm", "window", "sample", "answered_ids"):
        assert callable(getattr(mix, fn)), fn
    lim = manifest.limits(cell)
    assert lim["limits"]["placement_mismatch"] == 0
    assert lim["limits"]["bad_answers"] == 0
    assert cell["chips"] == 1
    e2e = manifest.metrics_of(man, cell["name"], "end_to_end")
    per_layer = manifest.metrics_of(man, cell["name"], "per_layer")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer
    for m in e2e + per_layer:
        reader = manifest.reader(m["name"])
        assert callable(reader.read)
        assert getattr(reader, "MOVES", None) == m.get("moves")


def test_config_files_state_their_cuts():
    for c in MAN["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["assumed"]
        assert not any(k.endswith(("_dim", "_rank", "_size")) and
                       k != "vocab_size" for k in c["reduced"])


def test_files_under_paths_are_named_from_name_characters():
    bench = ROOT / "listbench"
    for p in bench.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = str(p.relative_to(ROOT))
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_run_without_a_card_prints_no_result():
    """Here torch has no CUDA: the run must fail, not fall back."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "listbench" / "run.py"), "--workload",
         "bf16-route2", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert proc.returncode != 0
    assert not proc.stdout.strip()
