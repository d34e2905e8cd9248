"""The dry-run: every (arch × shape) cell's work on the production meshes,
counted on meta tensors (reference: ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 256 / 512 forced host
devices and reads XLA's memory, cost and HLO analyses. The port plans
each cell on ``launch.mesh.abstract_production_mesh`` (axis names and
sizes, no devices) and runs ``plan.fn`` once on the plan's meta args
under ``analysis.op_cost.count``: nothing is allocated on any device,
and the kernel twins record their declared work (``kernels.meta``). The
work does not depend on the mesh, so one count serves every mesh asked
for; a cell whose arguments the mesh pads (the mining corpus, the
retrieval candidates) is counted again on the mesh that changes them.
Per mesh the record holds:

* ``flops_per_chip`` / ``bytes_per_chip``: the whole call's count
  (``flops`` / ``bytes``, aten ops and kernels, ``op_cost``'s rules)
  split evenly over the cards: the port has no SPMD partitioner to say
  otherwise;
* ``argument_size_in_bytes``: exact from the specs, each argument's
  bytes over the sizes of the mesh axes its spec names;
  ``output_size_in_bytes`` likewise through ``out_shardings``, an output
  without one counted whole;
* ``collectives``: the parameters' gradient reductions and data-parallel
  all-gathers from the spec trees (``op_cost.plan_collectives``), split
  within and beyond an 8-card node; the activations' tensor-parallel
  collectives are not counted (``not_counted``): the port runs no
  tensor-parallel forward;
* ``roofline``: ``analysis.roofline.roofline_terms`` at the H100's peaks;
* ``kernels``: each twin's launches and declared work.

Left out of the reference's record: ``xla_flops_once`` and
``xla_bytes_once`` (XLA's cost analysis, which visits each computation
once; there is no XLA here), ``temp_size_in_bytes`` and
``generated_code_size_in_bytes`` (a compiled executable's scratch and
code; nothing is compiled). ``compile_s`` is the seconds to plan the
cell and count its work. No sharding rules are bound while counting:
``constrain`` is the identity, and the MoE's expert-parallel path needs
a ``DeviceMesh``'s process groups, so the MoE runs its local path, which
does the same global work. A failing cell is a result (``FAIL`` with its
error).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k [--multi-pod] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        [--jobs 4] --out dryrun.json
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, List, Optional

NOT_COUNTED = ("the activations' tensor-parallel collectives (the port "
               "runs no tensor-parallel forward: sharding.constrain is the "
               "identity), the dispatch's all-to-all and a sharded top-k's "
               "merge")
SPLIT = "flops and bytes: the whole call's, split evenly over the cards"


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _signature(plan) -> tuple:
    """What the count depends on besides ``fn``: every argument tensor's
    shape and dtype, and the plan's notes."""
    import torch
    from repro_torch.analysis.op_cost import tensor_leaves
    sig = []
    for arg in plan.args:
        leaves = (list(arg.parameters()) + list(arg.buffers())
                  if isinstance(arg, torch.nn.Module) else tensor_leaves(arg))
        sig.extend((tuple(t.shape), t.dtype) for t in leaves)
    return tuple(sig), plan.notes


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, dims: Optional[dict] = None,
             cache: Optional[dict] = None, mesh=None) -> dict:
    """One cell on the (16, 16) or (2, 16, 16) abstract mesh (or ``mesh``)
    → its record. ``dims`` replaces entries of the shape's dims
    (``steps.plan_cell``); ``cache``, a dict shared between calls, keeps
    a cell's count for the next mesh."""
    from repro_torch.analysis import op_cost
    from repro_torch.analysis import roofline as rl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    if mesh is None:
        mesh = mesh_lib.abstract_production_mesh(multi_pod=multi_pod)
        name = mesh_name(multi_pod)
    else:
        name = "x".join(map(str, mesh_lib.axis_sizes(mesh).values()))
    rec = {"arch": arch, "shape": shape_name, "mesh": name}
    chips = mesh_lib.mesh_chips(mesh)
    t0 = time.time()
    try:
        plan = steps.plan_cell(arch, shape_name, mesh, dims=dims)
        if plan.skip:
            rec["status"] = "SKIP"
            rec["reason"] = plan.skip
            return rec
        cache = {} if cache is None else cache
        key = (arch, shape_name, repr(sorted((dims or {}).items())),
               _signature(plan))
        if key not in cache:
            cache[key] = op_cost.count(plan.fn, *plan.args,
                                       return_output=True)
        work, out = cache[key]
        per = op_cost.per_card(work, plan, mesh)
        flops, nbytes, coll = per["flops"], per["bytes"], per["coll"]
        terms = rl.roofline_terms(flops, nbytes, coll)
        rec.update({
            "status": "OK",
            "chips": chips,
            "compile_s": round(time.time() - t0, 1),
            "flops_per_chip": flops,
            "bytes_per_chip": nbytes,
            "collectives": {k: v for k, v in coll.items() if v},
            "roofline": terms,
            "notes": plan.notes,
            "argument_size_in_bytes": int(op_cost.argument_bytes(plan,
                                                                 mesh)),
            "output_size_in_bytes": int(op_cost.output_bytes(out, plan,
                                                             mesh)),
            "flops": work["flops"],
            "bytes": work["bytes"],
            "kernels": work["kernels"],
            "split": SPLIT,
            "not_counted": NOT_COUNTED,
        })
        if dims:
            rec["dims"] = dict(dims)
        if verbose:
            print(f"[{name}] {arch} × {shape_name}: OK  "
                  f"flops/chip={flops:.3e}  bytes/chip={nbytes:.3e}  "
                  f"coll={coll['total']:.3e}B  "
                  f"bottleneck={terms['bottleneck']}  "
                  f"({rec['compile_s']}s)", flush=True)
    except Exception as e:  # noqa: BLE001 — a failing cell is a result
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[{name}] {arch} × {shape_name}: FAIL {rec['error']}",
                  flush=True)
    return rec


def all_cells():
    from repro_torch.configs import arch_ids, get_shapes
    for arch in arch_ids():
        for shape in get_shapes(arch):
            yield arch, shape.name


def cell_records(arch: str, shape: str, meshes, verbose: bool = True
                 ) -> List[dict]:
    """One cell on each of ``meshes`` (``multi_pod`` flags), counted once
    where the meshes agree."""
    cache: Dict = {}
    return [run_cell(arch, shape, multi_pod=mp, verbose=verbose,
                     cache=cache) for mp in meshes]


def _no_device() -> None:
    """A worker process sees no GPU: the dry-run touches none."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _cost_order(cell) -> int:
    """Train cells first, then prefill and the rest: the longest counts
    start first across the workers."""
    _, shape = cell
    return (0 if "train" in shape else 1 if "prefill" in shape
            or "mine" in shape else 2)


def run(cells, meshes, *, jobs: int = 1, verbose: bool = True
        ) -> List[dict]:
    """Every cell on every mesh → the records, cells in order, each
    cell's meshes in order. With ``jobs > 1`` the cells are counted in
    that many worker processes (spawned, each with no GPU visible; all
    joined before this returns)."""
    cells = list(cells)
    if jobs <= 1:
        return [r for a, s in cells for r in cell_records(a, s, meshes,
                                                          verbose)]
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    order = sorted(range(len(cells)), key=lambda i: _cost_order(cells[i]))
    with ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn"),
                             initializer=_no_device) as pool:
        futs = {i: pool.submit(cell_records, *cells[i], meshes, verbose)
                for i in order}
        return [r for i in range(len(cells)) for r in futs[i].result()]


def summary(results: List[dict]) -> Dict[str, Dict[str, int]]:
    """``{mesh: {"OK": n, "SKIP": n, "FAIL": n}}``."""
    out: Dict[str, Dict[str, int]] = {}
    for r in results:
        s = out.setdefault(r["mesh"], {"OK": 0, "SKIP": 0, "FAIL": 0})
        s[r["status"]] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes counting cells side by side")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_shapes
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = list(all_cells())
    else:
        assert args.arch, "--arch or --all required"
        if args.shape:
            cells = [(args.arch, args.shape)]
        else:
            cells = [(args.arch, s.name) for s in get_shapes(args.arch)]
    t0 = time.time()
    results = run(cells, meshes, jobs=args.jobs)
    ok = sum(r["status"] == "OK" for r in results)
    skip = sum(r["status"] == "SKIP" for r in results)
    fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n=== dry-run: {ok} OK, {skip} SKIP, {fail} FAIL "
          f"of {len(results)} cells ({time.time() - t0:.1f} s) ===")
    for name, s in summary(results).items():
        print(f"    {name}: {s['OK']} OK, {s['SKIP']} SKIP, {s['FAIL']} FAIL")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 0 if fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
