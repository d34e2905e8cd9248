"""Generator ``open_loop``: single distinct requests to ``Searcher.serve``
(``ServerConfig(batch_size, k, cr, max_delay_ms)``) arriving at
``rate_qps`` with exponential gaps (Poisson), whatever the server does.
The gaps are the exponential distribution's quantiles at ``(i + ½) / n``,
in an order drawn from the seed: every seed offers the same set of gaps.

A request is sent when it falls due, and timed from then, however late
the generator was (the event loop blocks while the server flushes); the
window ends with the last answer, and waits at most ``LATE_S`` past the
last due time. Queries as in ``offline``; set-up serves
``warmup_requests`` others.
"""
from __future__ import annotations

import asyncio
import time

import numpy as np

from listbench import inputs as inputs_lib
from listbench import judge

LATE_S = 60.0


class Requests:
    """``n = rate · seconds`` requests: ``due`` offsets (s) from the
    window's start, and their rows."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, seconds: float):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        rate = float(traffic["rate_qps"])
        n = max(int(round(rate * seconds)), 1)
        u = (np.arange(n) + 0.5) / n
        gaps = -np.log1p(-u) / rate
        gaps = inputs_lib.rng(seed, inputs_lib.STREAM_ARRIVALS).permutation(
            gaps)
        self.due = np.cumsum(gaps)
        self.tok, self.mask, self.loc, self.lengths = inputs_lib.queries(
            cfg, traffic, seed, inputs_lib.STREAM_QUERIES, 0, n)


def make(cfg: dict, traffic: dict, seed: int, seconds: float) -> Requests:
    return Requests(cfg, traffic, seed, seconds)


def first(gen: Requests, n: int):
    """The first ``n`` requests: ``(tokens, mask, loc)``."""
    return gen.tok[:n], gen.mask[:n], gen.loc[:n]


def warm(searcher, gen: Requests, traffic: dict, seconds: float):
    """The server, warmed and given ``warmup_requests`` other requests;
    its counters start at nought."""
    from repro_torch.core.server import ServerConfig
    server = searcher.serve(ServerConfig(
        batch_size=traffic["batch_size"], k=traffic["k"], cr=traffic["cr"],
        max_delay_ms=traffic["max_delay_ms"]))
    server.warmup()
    tok, msk, loc, _ = inputs_lib.queries(
        gen.cfg, traffic, gen.seed, inputs_lib.STREAM_WARMUP, 0,
        traffic["warmup_requests"])
    server.serve_all(tok, msk, loc)
    server.stats = type(server.stats)()
    return server


async def _open_loop(server, gen, traced):
    n = len(gen.due)
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    answers = [None] * n
    errors = []

    async def one(i, due):
        try:
            res = await server.submit(gen.tok[i], gen.mask[i], gen.loc[i],
                                      t_arrival=due)
        except Exception as e:                         # noqa: BLE001
            errors.append(repr(e))
            return
        done[i] = time.perf_counter()
        answers[i] = res

    tasks = []
    t0 = time.perf_counter() + 0.01
    with traced.window():
        for i in range(n):
            due = t0 + gen.due[i]
            delay = due - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            sent[i] = time.perf_counter()
            tasks.append(asyncio.ensure_future(one(i, due)))
        close = t0 + gen.due[-1]
        left = close + LATE_S - time.perf_counter()
        _, pending = await asyncio.wait(tasks, timeout=max(left, 0.0))
        for t in pending:
            t.cancel()
        t_end = np.nanmax(done) if np.isfinite(done).any() else close
    return {"t0": t0, "sent": sent, "done": done, "answers": answers,
            "errors": errors, "window_s": float(t_end - t0),
            "due": t0 + gen.due}


def window(server, gen: Requests, traffic: dict, seconds: float,
           traced) -> dict:
    r = asyncio.run(_open_loop(server, gen, traced))
    ok = np.isfinite(r["done"])
    lat_ms = (r["done"][ok] - r["due"][ok]) * 1e3
    late_ms = (r["sent"] - r["due"]) * 1e3
    n = len(r["due"])
    counters = server.metrics()
    return {"window_s": r["window_s"], "latency_ms": lat_ms,
            "late_ms": late_ms[np.isfinite(late_ms)],
            "answered": np.flatnonzero(ok), "answers": r["answers"],
            "attempted": n, "failed": int(n - ok.sum()),
            "chunks": counters["engine_batches"], "counters": counters,
            "errors": r["errors"][:5]}


def sample(win: dict, gen: Requests, n: int, seed: int):
    """``n`` answered requests drawn from the seed: ``(tokens, mask, loc,
    ids, scores)``."""
    answered = win["answered"]
    pick = answered[judge.sample_indices(len(answered), n, seed)]
    ids = np.stack([win["answers"][i][0] for i in pick])
    sc = np.stack([win["answers"][i][1] for i in pick])
    return gen.tok[pick], gen.mask[pick], gen.loc[pick], ids, sc


def answered_ids(win: dict) -> np.ndarray:
    """Every answer's ids, ``(answered, k)``."""
    return np.stack([win["answers"][i][0] for i in win["answered"]])
