"""``BENCHMARK.json`` and the files it names, found by name:

* ``configs[].file``: the configuration, as run;
* ``listbench/traffic/<traffic>.json``: the cell's traffic mix, a data
  file whose ``generator`` names its generator;
* ``listbench/generators/<generator>.py``: one module per kind of traffic,
  with ``make``, ``first``, ``warm``, ``window``, ``sample`` and
  ``answered_ids`` (``generators/offline.py`` says what each does);
* ``listbench/workloads/<cell>.json``: the cell's correctness limits and
  judge sample;
* ``listbench/metrics/<metric>.py``: one reader per metric, end to end
  and per layer, with ``read(ctx) -> float | None``.

Adding a configuration, a mix, a cell or a metric adds files and entries;
nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, cell_: dict, root: Path = ROOT) -> dict:
    for c in man["configs"]:
        if c["name"] == cell_["config"]:
            return _json(root / c["file"])
    raise KeyError(f"no config {cell_['config']!r} in BENCHMARK.json")


def traffic(cell_: dict) -> dict:
    return _json(BENCH / "traffic" / f"{cell_['traffic']}.json")


def limits(cell_: dict) -> dict:
    return _json(BENCH / "workloads" / f"{cell_['name']}.json")


def applies(metric: dict, cell_name: str, e2e_of_cell) -> bool:
    """A metric is read in a cell its ``workloads`` list names; without
    the list, an end-to-end metric in every cell and a per-layer one in
    every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def metrics_of(man: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries read in a cell."""
    e2e = [m["name"] for m in man["end_to_end"]
           if applies(m, cell_name, ())]
    return [m for m in man[kind] if applies(m, cell_name, e2e)]


def _module(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"listbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The reader module of metric ``name``."""
    return _module("metrics", name)


def generator(traffic_: dict):
    """The generator module a traffic mix names."""
    return _module("generators", traffic_["generator"])
