"""The readings the correctness limits are set from, at a cell's own size
(not run by the benchmark's runs):

    python3 listbench/calibrate.py --workload bf16-route2 \\
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3

For each ``--seeds`` seed, one run of the cell (``run.run_cell``) and the
judge's numbers: the program's readings, whose largest is a limit's lower
reading. For each ``--control-seeds`` seed, the control
(``reference/control.py``: the reference one precision below the
configuration) answers the first ``sample`` queries of the cell's traffic
in the program's place and is judged the same way: its smallest reading
is the upper one. One JSON line per run on standard output, and in
``--out`` when given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from listbench import judge, manifest, run  # noqa: E402


def control_queries(cfg, traffic, seed, n):
    """The first ``n`` queries of a cell's traffic for ``seed``."""
    mix = manifest.generator(traffic)
    gen = mix.make(cfg, traffic, seed,
                   max(n / traffic.get("rate_qps", 1.0), 1.0))
    return mix.first(gen, n)


def control_readings(workload: str, seed: int, *, device="cuda",
                     overrides=None) -> dict:
    """The judge's numbers of the control's answers for one seed."""
    man = manifest.load()
    cell = manifest.cell(man, workload)
    over = overrides or {}
    cfg = {**manifest.config(man, cell), **over.get("cfg", {})}
    traffic = {**manifest.traffic(cell), **over.get("traffic", {})}
    lim = {**manifest.limits(cell), **over.get("limits", {})}
    ref = judge.Reference(cfg, seed, device)
    tok, msk, loc = control_queries(cfg, traffic, seed, lim["sample"])
    k, cr = traffic["k"], traffic["cr"]
    ids, scores = judge.control_answers(ref, tok, msk, loc, k=k, cr=cr)
    return judge.judge_answers(ref, tok, msk, loc, ids, scores, k=k, cr=cr,
                               route_tol=lim["limits"].get("route_gap", 0.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.cache_dirs()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for kind, seed in ([("program", s) for s in seeds]
                           + [("control", s) for s in controls]):
            t0 = time.perf_counter()
            if kind == "program":
                res = run.run_cell(args.workload, seed, args.seconds, False,
                                   t_start=t0)
                line = res["line"]
                rec = {"correct": line["correct"], "numbers": res["numbers"],
                       "metrics": line["metrics"], "failed": line["failed"]}
            else:
                rec = {"numbers": control_readings(args.workload, seed)}
            rec.update(kind=kind, workload=args.workload, seed=seed,
                       seconds=time.perf_counter() - t0)
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
