"""Run one cell of the port's benchmark once.

    python3 listbench/run.py --workload bf16-route2 --seed 7 --seconds 10 --trace 0

From the root of a checkout. Builds the cell's index with the port
(``repro_torch``) from the seed, warms every shape the cell's traffic
uses, measures for ``--seconds``, has the plain reference judge the
answers, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics from a profiled window),
``device``, with ``--trace 1`` ``breakdown``, and ``checks``: each
number compared, with its limit, also printed as the last lines of
standard error. Exits non-zero, printing no result, without enough CUDA
devices, without the port, if a traced run leaves a per-layer metric of
the cell without a reading, or if jax, jaxlib, flax or the JAX package is
loaded after the window. The cell's traffic mix names the generator
(``listbench/generators/``) that warms the system, offers the load and
draws the answers to judge.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HOST_THREADS = 4


def _paths(root: Path = ROOT) -> None:
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its CUDA libraries under ``build/kernels``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a JAX one, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"listbench: {msg}", file=sys.stderr, flush=True)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class NothingToRead(RuntimeError):
    """A traced run in which a per-layer metric of the cell read nothing."""


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float = T_START, root: Path = ROOT,
             overrides=None) -> dict:
    """One run of a cell: → ``{"line": the result line, "numbers": every
    reading of the judge, "errors": the first errors of failed calls or
    requests}``. ``overrides`` (``{"cfg", "traffic", "limits"}`` dicts
    merged over the cell's files) are for the tests, which run cells at a
    small size on the CPU. Raises ``NothingToRead`` where a traced run
    leaves a per-layer metric of the cell without a reading."""
    import torch
    from listbench import judge, manifest, system
    from listbench import trace as trace_lib

    man = manifest.load(root)
    cell = manifest.cell(man, workload)
    cfg = manifest.config(man, cell, root)
    traffic = manifest.traffic(cell)
    lim = manifest.limits(cell)
    over = overrides or {}
    cfg = {**cfg, **over.get("cfg", {})}
    traffic = {**traffic, **over.get("traffic", {})}
    lim = {**lim, **over.get("limits", {})}
    mix = manifest.generator(traffic)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.set_num_threads(HOST_THREADS)
    k, cr = traffic["k"], traffic["cr"]

    t0 = time.perf_counter()
    searcher = system.build_searcher(cfg, seed, dev)
    _sync(dev)
    log(f"index built in {time.perf_counter() - t0:.2f} s "
        f"({time.perf_counter() - t_start:.2f} s since start)")
    gen = mix.make(cfg, traffic, seed, seconds)
    state = mix.warm(searcher, gen, traffic, seconds)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s")

    traced = trace_lib.Traced(trace)
    recorder = system.RouteRecorder() if trace else None
    with traced, (recorder.recording() if recorder is not None
                  else contextlib.nullcontext()):
        win = mix.window(state, gen, traffic, seconds, traced)
        _sync(dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    from repro_torch.kernels import fused_topk_score
    src = Path(fused_topk_score.__file__).parent / "csrc" / \
        "fused_topk_score.cu"
    ctx = {"cfg": cfg, "traffic": traffic, "cell": cell, "seconds": seconds,
           "setup_s": setup_s, "window": win, "trace": traced.summary,
           "server": win["counters"], "chunks": win["chunks"],
           "scans": (recorder.scans() if recorder is not None
                     and recorder.calls else None),
           "scan_kernels": (trace_lib.kernel_names(src.read_text())
                            if src.exists() else set())}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    wanted = manifest.metrics_of(man, workload, kind)
    for m in wanted:
        v = manifest.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    silent = [m["name"] for m in wanted if m["name"] not in metrics]
    if trace and silent:
        summary = traced.summary or {}
        raise NothingToRead(
            f"per-layer metrics of {workload} read nothing: {silent} "
            f"(device busy_s {summary.get('busy_s')}; "
            f"{len(recorder.calls)} scans recorded at "
            f"repro_torch.core.engine._routed_topk; "
            f"{len(ctx['scan_kernels'])} scan kernels named in {src})")

    buffers = searcher.snapshot.buffers
    sample = mix.sample(win, gen, lim["sample"], seed)
    all_ids = mix.answered_ids(win)
    del searcher, state, win["answers"]
    t0 = time.perf_counter()
    ref = judge.Reference(cfg, seed, dev, placement=buffers["ids"])
    t1 = time.perf_counter()
    numbers = judge.judge_answers(
        ref, *sample, k=k, cr=cr,
        route_tol=lim["limits"].get("route_gap", 0.0))
    numbers["bad_answers"] += judge.structural_bad(ref, all_ids, cr)
    _sync(dev)
    t2 = time.perf_counter()
    numbers["placement_mismatch"] = ref.placement_mismatch(buffers)
    _sync(dev)
    log(f"window {win['window_s']:.2f} s, judged in "
        f"{time.perf_counter() - t0:.2f} s (index "
        + ", ".join(f"{n} {v:.2f}" for n, v in ref.times.items())
        + f"; answers {t2 - t1:.2f}; placement {time.perf_counter() - t2:.2f})")
    del buffers, ref
    ok, checks = judge.verdict(numbers, lim["limits"], win["failed"])

    dev_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(ok), "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics,
           "device": dev_rec}
    if trace and traced.summary is not None:
        s = traced.summary
        dev_rec["busy_s"] = s["busy_s"]
        dev_rec["window_s"] = s["window_s"]
        out["breakdown"] = {"device_ops": s["device_ops"],
                            "idle_gaps": s["idle_gaps"]}
    out["checks"] = checks
    return {"line": out, "numbers": {n: float(v) for n, v in numbers.items()},
            "errors": win["errors"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    cache_dirs()
    import torch
    from listbench import manifest
    cell = manifest.cell(manifest.load(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell[
            "chips"]:
        print(f"listbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))["line"]
    except NothingToRead as e:
        print(f"listbench: {e}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"listbench: JAX modules loaded in the measuring process: "
              f"{found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
