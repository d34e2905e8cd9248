"""The top operations of one cell's call: the counterpart of
``repro/analysis/hlo_top.py`` (``analyze`` :28).

    PYTHONPATH=src python -m repro_torch.analysis.op_top \\
        --arch list-dual-encoder --shape serve_queries [--batch 256] [--top 20]
    PYTHONPATH=src python -m repro_torch.analysis.op_top --device meta \\
        --arch kimi-k2-1t-a32b --shape train_4k [--multi-pod]

The reference prints the collectives and the largest tensors written of a
compiled HLO module, with no clock on its CPU. The port has a clock:

* **On the card** (the default) one call of the cell runs through
  ``plan_cell`` on ``make_host_mesh()`` (a world of one; a process group
  is made if none exists, and destroyed after), its meta arguments drawn
  on the card from a seed (floats normal, integers below the config's
  vocabulary, a graph's below its node count, labels below the classes,
  masks all set), at the cell's batch (``--batch`` to start lower),
  halved on ``torch.OutOfMemoryError`` until it fits. After one warm-up
  call a second runs under ``torch.profiler``: the top device operations
  (kernels, copies, fills) by time, grouped by name, and their sum; the
  top writers, aten operations by the device bytes they allocated; and each kernel twin under its own name
  (``twin::<name>``, ``kernels.meta.launch_range``) with its launches,
  beside the launches ``kernels.ops.launch_counts()`` gained.
* ``--device cpu`` runs the same on the CPU (host times; the twins run
  their plain versions, so none appears).
* ``--device meta`` prints the static table instead: the cell on the
  production mesh (``--multi-pod`` for the 2x16x16 one) counted by
  ``analysis.op_cost`` (every aten op and kernel by FLOPs and by bytes)
  and the parameters' collectives per card.

Without a card the default raises; ``--device meta`` and ``cpu`` need
none.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional

BATCH_KEYS = ("global_batch", "batch", "query_batch", "batch_nodes")
SEED = 0


def _time_attr(evt, prefix: str) -> float:
    """An event's self (``prefix`` "self_") or total (``prefix`` "") device
    time in µs, under the name this torch gives it."""
    for name in (f"{prefix}device_time_total", f"{prefix}cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _mem_attr(evt, cuda: bool) -> int:
    """The bytes an event's own operation allocated, on the card or the
    host."""
    names = (("self_device_memory_usage", "self_cuda_memory_usage") if cuda
             else ("self_cpu_memory_usage",))
    for name in names:
        if hasattr(evt, name):
            return int(getattr(evt, name))
    return 0


def _int_high(key: str, cfg, shape, t) -> int:
    """The bound below which an integer argument is drawn."""
    dims = shape.dims
    if key == "labels":
        return dims.get("n_classes", 2)
    if key == "graph_ids":
        return dims.get("batch", 1)
    if key == "mlm_pos":
        return cfg.seq_len
    for attr in ("vocab_size", "n_items", "vocab_per_field"):
        if hasattr(cfg, attr):
            return int(getattr(cfg, attr))
    if hasattr(cfg, "table_sizes"):
        return int(min(cfg.table_sizes))
    return int(dims.get("n_nodes", t.shape[0] if t.dim() else 1))


def materialize(tree, dev, gen, high, key: str = "", zeros: bool = False):
    """A plan argument's meta tensors drawn on ``dev`` (module docstring);
    ``zeros`` for an optimizer state; ``high(key, tensor)`` bounds an
    integer tensor. A module is moved with ``to_empty`` and its
    parameters filled."""
    import torch
    if isinstance(tree, torch.nn.Module):
        tree = tree.to_empty(device=dev)
        with torch.no_grad():
            for p in tree.parameters():
                if p.dim() >= 2:
                    p.normal_(0.0, 0.02, generator=gen)
                else:
                    p.fill_(1.0)
        return tree
    if isinstance(tree, dict):
        return {k: materialize(v, dev, gen, high, k, zeros)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [materialize(v, dev, gen, high, key, zeros) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if not isinstance(tree, torch.Tensor):
        return tree
    if zeros or tree.dim() == 0:
        return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)
    if tree.dtype == torch.bool:
        return torch.ones(tree.shape, dtype=torch.bool, device=dev)
    if tree.dtype.is_floating_point:
        return torch.randn(tree.shape, generator=gen, device=dev).to(
            tree.dtype)
    return torch.randint(0, max(1, high(key, tree)), tree.shape,
                         generator=gen, device=dev, dtype=tree.dtype)


def _host_mesh(device: str):
    """``make_host_mesh`` over a world of one, made here if none exists
    → ``(mesh, made)``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    made = None
    if device == "cuda":
        import torch
        torch.cuda.set_device(torch.cuda.current_device())
    if not dist.is_initialized():
        made = tempfile.TemporaryDirectory()
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            init_method=f"file://{made.name}/store", world_size=1, rank=0)
    return make_host_mesh(device_type=device), made


def _call(arch, shape_name, mesh, dev, batch: Optional[int]):
    """``(plan, args)``: the plan at ``batch`` and its arguments drawn on
    ``dev``."""
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import steps
    shape = get_shape(arch, shape_name)
    dims = ({k: batch for k in BATCH_KEYS if k in shape.dims}
            if batch else None)
    plan = steps.plan_cell(arch, shape_name, mesh, dims=dims)
    if plan.skip:
        raise ValueError(f"{arch} × {shape_name} is skipped: {plan.skip}")
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    train = len(plan.args) == 3 and isinstance(plan.args[1], dict) \
        and "step" in plan.args[1]

    def high(key, t):
        return _int_high(key, cfg, shape, t)

    args = tuple(materialize(a, dev, gen, high, zeros=train and i == 1)
                 for i, a in enumerate(plan.args))
    if train:
        graph = args[2]
        nodes = graph.get("x") if isinstance(graph, dict) else None
        if nodes is not None and "edge_src" in graph:
            n = nodes.shape[0]
            for k in ("edge_src", "edge_dst"):
                graph[k] = torch.randint(0, n, graph[k].shape, generator=gen,
                                         device=dev, dtype=graph[k].dtype)
    return plan, args


def profile(arch: str, shape_name: str, *, device: str = "cuda",
            batch: Optional[int] = None, top: int = 20) -> dict:
    """One call of the cell on ``device`` under ``torch.profiler`` (module
    docstring) → ``{"batch", "device_ms", "top", "writers", "twins",
    "launches"}``: ``top`` rows ``(name, calls, ms)`` by self device time
    (host time on the CPU), ``writers`` rows ``(name, calls, bytes)``,
    ``twins`` ``{name: {"launches", "device_ms"}}`` from the trace and
    ``launches`` what ``kernels.ops.launch_counts()`` gained in the
    profiled call."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from repro_torch.kernels import meta as kmeta
    from repro_torch.kernels import ops as kops
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("op_top profiles on the card: no CUDA device "
                           "here (--device meta or cpu runs without one)")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    mesh, made = _host_mesh(device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    try:
        b = batch
        while True:
            try:
                plan, args = _call(arch, shape_name, mesh, dev, b)
                plan.fn(*args)
                sync()
                break
            except torch.OutOfMemoryError:
                plan = args = None
                torch.cuda.empty_cache()
                b = (b or _batch_of(arch, shape_name)) // 2
                if b < 1:
                    raise
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        before = kops.launch_counts()
        with torch.profiler.profile(activities=acts,
                                    profile_memory=True) as prof:
            plan.fn(*args)
            sync()
        after = kops.launch_counts()
    finally:
        if made is not None:
            dist.destroy_process_group()
            made.cleanup()
    events = prof.key_averages()
    what = "device" if cuda else "cpu"

    def t_self(e):
        return (_time_attr(e, "self_") if cuda
                else float(e.self_cpu_time_total))

    # on the card the device's own events (kernels, copies, fills): an
    # aten op's self device time is its kernels', counted once there
    kind = DeviceType.CUDA if cuda else DeviceType.CPU
    timed = sorted((e for e in events if e.device_type == kind
                    and t_self(e) > 0
                    and not e.key.startswith(kmeta.RANGE_PREFIX)),
                   key=lambda e: -t_self(e))
    twins = {e.key[len(kmeta.RANGE_PREFIX):]: {
        "launches": int(e.count),
        "device_ms": (_time_attr(e, "") if cuda else 0.0) / 1e3}
        for e in events if e.key.startswith(kmeta.RANGE_PREFIX)}
    writers = sorted((e for e in events if _mem_attr(e, cuda) > 0),
                     key=lambda e: -_mem_attr(e, cuda))
    return {"arch": arch, "shape": shape_name, "device": what,
            "batch": b, "device_ms": sum(t_self(e) for e in timed) / 1e3,
            "top": [(e.key, int(e.count), t_self(e) / 1e3)
                    for e in timed[:top]],
            "writers": [(e.key, int(e.count), _mem_attr(e, cuda))
                        for e in writers[:top]],
            "twins": twins,
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}}


def _batch_of(arch, shape_name) -> int:
    from repro_torch.configs import get_shape
    dims = get_shape(arch, shape_name).dims
    return next(dims[k] for k in BATCH_KEYS if k in dims)


def static(arch: str, shape_name: str, *, multi_pod: bool = False,
           top: int = 20) -> dict:
    """The cell on the production mesh counted on meta tensors →
    ``{"flops", "bytes", "coll", "by_flops", "by_bytes"}`` (whole call;
    the collectives per card)."""
    from repro_torch.analysis import op_cost
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    mesh = mesh_lib.abstract_production_mesh(multi_pod=multi_pod)
    plan = steps.plan_cell(arch, shape_name, mesh)
    if plan.skip:
        raise ValueError(f"{arch} × {shape_name} is skipped: {plan.skip}")
    work = op_cost.count(plan.fn, *plan.args, by_op=True)
    return {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "flops": work["flops"], "bytes": work["bytes"],
            "coll": op_cost.plan_collectives(plan, mesh),
            "by_flops": [(k, r) for k, r in op_cost.top(
                work["by_op"], "flops", top) if r["flops"]],
            "by_bytes": op_cost.top(work["by_op"], "bytes", top)}


def report(r: dict) -> str:
    """The printed table of :func:`profile` or :func:`static`."""
    lines = []
    if "by_flops" in r:
        lines.append(f"=== {r['arch']} × {r['shape']} [{r['mesh']}], "
                     f"counted on meta ===")
        lines.append(f"flops={r['flops']:.3e}  bytes={r['bytes']:.3e} "
                     f"(whole call)  coll/chip={r['coll']['total']:.3e}B")
        lines.append("\n-- top FLOPs --")
        for name, row in r["by_flops"]:
            lines.append(f"  {row['flops'] / 1e12:12.3f} TFLOP  "
                         f"{row['calls']:6d}×  {name}")
        lines.append("\n-- top bytes (inputs + outputs, unfused) --")
        for name, row in r["by_bytes"]:
            lines.append(f"  {row['bytes'] / 1e9:12.3f} GB  "
                         f"{row['calls']:6d}×  {name}")
        return "\n".join(lines)
    lines.append(f"=== {r['arch']} × {r['shape']} at batch {r['batch']} "
                 f"[{r['device']}] ===")
    lines.append(f"{r['device']} time {r['device_ms']:.3f} ms")
    lines.append(f"\n-- top {r['device']} operations --")
    for name, calls, ms in r["top"]:
        lines.append(f"  {ms:10.3f} ms  {calls:6d}×  {name[:90]}")
    lines.append(f"\n-- top writers ({r['device']} bytes allocated) --")
    for name, calls, nbytes in r["writers"]:
        lines.append(f"  {nbytes / 1e9:10.3f} GB  {calls:6d}×  {name[:90]}")
    lines.append("\n-- kernel twins --")
    for name, t in sorted(r["twins"].items()):
        lines.append(f"  {t['device_ms']:10.3f} ms  {t['launches']:6d}×  "
                     f"{name} (launch counter: "
                     f"{r['launches'].get(name, 0)})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    choices=("cuda", "cpu", "meta"))
    ap.add_argument("--batch", type=int, default=None)
    a = ap.parse_args(argv)
    if a.device == "meta":
        r = static(a.arch, a.shape, multi_pod=a.multi_pod, top=a.top)
    else:
        r = profile(a.arch, a.shape, device=a.device, batch=a.batch,
                    top=a.top)
    print(report(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
