"""Generator ``offline``: back-to-back ``Searcher.query`` calls of
``call_queries`` fresh queries each, with ``batch``, ``k`` and ``cr``,
until ``seconds`` have passed. The window ends with its last call, so the
rate is every query answered over all the time taken.

Queries have ``len_min..len_max`` tokens, evenly, and uniform locations
(``inputs.queries``). Every call is distinct. ``pregen_qps`` sizes the
calls made in set-up, so the window makes none.

A generator module exports ``make``, ``first``, ``warm``, ``window``,
``sample`` and ``answered_ids``; ``run.py`` calls the one its mix names
under ``generator``.
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np

from listbench import inputs as inputs_lib
from listbench import judge, system


class Calls:
    """The calls of one run, made on demand and kept: ``call(i)`` →
    ``(tokens, mask, loc, lengths)``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.n = traffic["call_queries"]
        self._calls = {}

    def call(self, i: int):
        if i not in self._calls:
            self._calls[i] = inputs_lib.queries(
                self.cfg, self.traffic, self.seed,
                inputs_lib.STREAM_QUERIES, i, self.n)
        return self._calls[i]

    def warmup(self):
        return inputs_lib.queries(self.cfg, self.traffic, self.seed,
                                  inputs_lib.STREAM_WARMUP, 0, self.n)


def make(cfg: dict, traffic: dict, seed: int, seconds: float) -> Calls:
    return Calls(cfg, traffic, seed)


def first(gen: Calls, n: int):
    """The first ``n`` queries of the traffic: ``(tokens, mask, loc)``."""
    parts, i = [], 0
    while sum(p[0].shape[0] for p in parts) < n:
        parts.append(gen.call(i))
        i += 1
    return tuple(np.concatenate([p[j] for p in parts])[:n] for j in range(3))


def warm(searcher, gen: Calls, traffic: dict, seconds: float):
    """Every scan ``auto`` may pick for these shapes, one call as the
    window makes it, and the window's calls made ahead."""
    tok, msk, loc, _ = gen.warmup()
    system.warm_backends(searcher, tok, msk, loc, k=traffic["k"],
                         cr=traffic["cr"], batch=traffic["batch"])
    for i in range(math.ceil(seconds * traffic["pregen_qps"] / gen.n)):
        gen.call(i)
    return searcher


def window(searcher, gen: Calls, traffic: dict, seconds: float,
           traced) -> dict:
    k, cr, batch = traffic["k"], traffic["cr"], traffic["batch"]
    answers, lengths, failed, errors = [], [], 0, []
    with traced.window():
        t0 = time.perf_counter()
        i = 0
        while True:
            tok, msk, loc, ln = gen.call(i)
            try:
                ids, sc = searcher.query(tok, msk, loc, k=k, cr=cr,
                                         batch=batch)
                answers.append((i, ids, sc))
                lengths.append(ln)
            except Exception as e:                     # noqa: BLE001
                failed += tok.shape[0]
                errors.append(repr(e))
                print(f"listbench: call {i} failed: {e!r}", flush=True,
                      file=sys.stderr)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
    return {"window_s": t1 - t0, "answers": answers,
            "lengths": np.concatenate(lengths) if lengths else np.zeros(0),
            "attempted": i * gen.n, "failed": failed,
            "chunks": sum(math.ceil(ids.shape[0] / batch)
                          for _, ids, _ in answers),
            "counters": None, "errors": errors[:5]}


def sample(win: dict, gen: Calls, n: int, seed: int):
    """``n`` answered queries drawn from the seed: ``(tokens, mask, loc,
    ids, scores)``."""
    rows = [(i, r) for i, ids, _ in win["answers"]
            for r in range(ids.shape[0])]
    pick = judge.sample_indices(len(rows), n, seed)
    by_call = {i: (ids, sc) for i, ids, sc in win["answers"]}
    tok, msk, loc, ids, sc = [], [], [], [], []
    for j in pick:
        i, r = rows[j]
        t, m, lq, _ = gen.call(i)
        tok.append(t[r])
        msk.append(m[r])
        loc.append(lq[r])
        ids.append(by_call[i][0][r])
        sc.append(by_call[i][1][r])
    return (np.stack(tok), np.stack(msk), np.stack(loc), np.stack(ids),
            np.stack(sc))


def answered_ids(win: dict) -> np.ndarray:
    """Every answer's ids, ``(answered, k)``."""
    return np.concatenate([ids for _, ids, _ in win["answers"]])
