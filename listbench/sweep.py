"""The open loop's rate sweep (not run by the benchmark's runs): one
served index, then for each rate an untraced window (latencies, how late
the generator sent, the answered rate) and a traced one (the device's
idle share).

    python3 listbench/sweep.py --workload bf16-serve-open --seed 5 \\
        --rates 2400,2500,2600,2700 --seconds 10

A rate is sustained where the server answers at least ``SUSTAINED`` of
it: requests over the window from the window's start to the last answer.
A queue that grows leaves the last answers late, and the answered rate
falls below the offered one. Near capacity a 10 s window swings (a rate
can read sustained above one that did not), so the knee is the highest
rate up to which every swept rate is sustained, the rates taken in
rising order; the cell's rate, ``rate_qps`` in its traffic file, is
about 0.8 of it. One JSON line per rate, then one with the knee.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

import numpy as np  # noqa: E402

from listbench import manifest, run, system  # noqa: E402
from listbench import trace as trace_lib  # noqa: E402

SUSTAINED = 0.97     # answered over offered rate; a 10 s window's last
                     # answer lands a latency (~0.1 s) after its last due


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    run.cache_dirs()
    import torch
    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    cfg = manifest.config(man, cell)
    traffic = manifest.traffic(cell)
    mix = manifest.generator(traffic)
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.set_num_threads(run.HOST_THREADS)
    searcher = system.build_searcher(cfg, args.seed, dev)
    server = mix.warm(searcher, mix.make(cfg, traffic, args.seed, 1.0),
                      traffic, 1.0)
    knee, below = None, True
    for i, rate in enumerate(sorted(float(r) for r in args.rates.split(","))):
        rec = {"rate_qps": rate}
        for traced_on in (False, True):
            mixed = dict(traffic, rate_qps=rate)
            gen = mix.make(cfg, mixed, args.seed + 1000 * i + traced_on,
                           args.seconds)
            server.stats = type(server.stats)()
            traced = trace_lib.Traced(traced_on)
            with traced:
                win = mix.window(server, gen, mixed, args.seconds, traced)
                torch.cuda.synchronize()
            lat = win["latency_ms"]
            if traced_on:
                s = traced.summary
                rec["idle_share"] = 100 * (1 - s["busy_s"] / s["window_s"])
                rec["traced_p95_ms"] = float(np.percentile(lat, 95))
                continue
            m = win["counters"]
            answered = len(lat) / win["window_s"]
            rec.update(
                requests=int(win["attempted"]), failed=int(win["failed"]),
                answered_qps=answered,
                sustained=bool(answered >= SUSTAINED * rate),
                p50_ms=float(np.percentile(lat, 50)),
                p95_ms=float(np.percentile(lat, 95)),
                p99_ms=float(np.percentile(lat, 99)),
                late_p95_ms=float(np.percentile(win["late_ms"], 95)),
                batch_fill=m["batch_fill"], flushes=m["flushes"],
                engine_batches=m["engine_batches"])
        below = below and rec["sustained"]
        if below:
            knee = rate
        print(json.dumps(rec), flush=True)
        time.sleep(0.5)
    print(json.dumps({"knee_qps": knee,
                      "cell_rate_qps": None if knee is None else 0.8 * knee}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
