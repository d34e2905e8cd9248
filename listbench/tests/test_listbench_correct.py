"""``correct`` at a small size on the CPU: a sound run of each cell is
judged correct; the control (the reference one precision below the
configuration) and each fault planted in the timed path are not.

The limits here are set for this size from its own readings (sound runs
read ≤ 0.02 on every number, the control ≥ 0.1 on score_gap and
miss_gap); the cells' limits at their own size are in
``listbench/workloads`` and ``PERF.md``."""
import numpy as np
import pytest
import torch

from listbench import calibrate, run
from listbench.tests import tiny

CELLS = ["bf16-route2", "int8-exhaustive", "bf16-serve-open"]
LIMITS = {"placement_mismatch": 0, "bad_answers": 0, "route_gap": 0.005,
          "score_gap": 0.04, "miss_gap": 0.06}
SEED = 3_000_000_019


def _limits(cell):
    lim = dict(LIMITS)
    if cell == "int8-exhaustive":
        lim.pop("route_gap")
    return lim


def _run(cell, seed=SEED):
    return run.run_cell(cell, seed, 0.5, False, device="cpu",
                        overrides=tiny.overrides(cell, _limits(cell)))["line"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", ["bf16-route2", "int8-exhaustive"])
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_control_is_not_correct(cell, seed):
    got = calibrate.control_readings(
        cell, seed, device="cpu", overrides=tiny.overrides(cell))
    lim = _limits(cell)
    over = [n for n in lim if n in got and got[n] > lim[n]]
    assert over, got
    assert got["score_gap"] > 3 * lim["score_gap"] / 2


# --- faults planted in the timed path ------------------------------------

def _wrap_scan(monkeypatch, fn):
    from repro_torch.core import engine
    orig = engine._routed_topk

    def wrapped(*a, **kw):
        ids, scores = orig(*a, **kw)
        return fn(ids, scores)

    monkeypatch.setattr(engine, "_routed_topk", wrapped)


def altered_answer(ids, scores):
    """One id of every 16th answer changed where the scan produces it."""
    ids = ids.clone()
    ids[::16, 0] = (ids[::16, 0] + 1) % tiny.TINY_CFG["n_objects"]
    return ids, scores


def half_batch_left_out(ids, scores):
    """Every second query of the chunk left out: it gets its neighbour's
    answer."""
    ids, scores = ids.clone(), scores.clone()
    ids[1::2], scores[1::2] = ids[0::2], scores[0::2]
    return ids, scores


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [altered_answer, half_batch_left_out],
                         ids=lambda f: f.__name__)
def test_fault_in_the_answers_is_caught(monkeypatch, cell, fault):
    _wrap_scan(monkeypatch, fault)
    out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_rows_left_out_is_caught(monkeypatch, cell):
    """The scan skips every second slot of each cluster."""
    from repro_torch.core import engine
    orig = engine._routed_topk

    def wrapped(q_emb, q_loc, w, top_c, buffers, *a, **kw):
        ids = buffers["ids"].clone()
        ids[:, 1::2] = -1
        return orig(q_emb, q_loc, w, top_c, dict(buffers, ids=ids), *a, **kw)

    monkeypatch.setattr(engine, "_routed_topk", wrapped)
    out = _run(cell)
    assert not out["correct"], out["checks"]
    assert out["checks"]["miss_gap"]["value"] > LIMITS["miss_gap"]


@pytest.mark.parametrize("cell", ["bf16-route2", "bf16-serve-open"])
def test_wrong_route_is_caught(monkeypatch, cell):
    """Each query's last route replaced by its router's worst cluster."""
    from repro_torch.core import index as index_lib
    orig = index_lib.route_queries

    def wrapped(index, feats, *, cr=1):
        top_c, top_p = orig(index, feats, cr=cr)
        worst = index_lib.cluster_logits(index, feats).argmin(-1)
        top_c = top_c.clone()
        top_c[:, -1] = worst.to(top_c.dtype)
        return top_c, top_p

    monkeypatch.setattr(index_lib, "route_queries", wrapped)
    out = _run(cell)
    assert not out["correct"], out["checks"]
    assert out["checks"]["route_gap"]["value"] > LIMITS["route_gap"]


@pytest.mark.parametrize("cell", ["bf16-route2", "int8-exhaustive"])
def test_misplaced_rows_are_caught(monkeypatch, cell):
    from repro_torch.core import index as index_lib
    orig = index_lib.build_cluster_buffers

    def wrapped(*a, **kw):
        buf = orig(*a, **kw)
        buf["loc"] = buf["loc"].clone()
        buf["loc"][0, :3] = buf["loc"][0, :3].flip(0)
        return buf

    monkeypatch.setattr(index_lib, "build_cluster_buffers", wrapped)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["placement_mismatch"]["value"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_sound_small_run_on_the_card(cell):
    """The card's path (the CUDA scans) at this size: correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run.run_cell(cell, SEED, 0.5, True, device="cuda",
                       overrides=tiny.overrides(cell, _limits(cell)))["line"]
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert np.isfinite(out["device"]["memory_peak_bytes"])


@pytest.mark.parametrize("cell", ["bf16-route2", "bf16-serve-open"])
def test_traced_run_with_nothing_to_read_prints_no_result(cell):
    """Without a device trace the per-layer metrics read nothing: the run
    refuses rather than print a line that lacks them."""
    with pytest.raises(run.NothingToRead):
        run.run_cell(cell, SEED, 0.5, True, device="cpu",
                     overrides=tiny.overrides(cell, _limits(cell)))


def test_route_sets_take_a_near_tie_the_answer_shows_nothing_of():
    """An answer whose ids all come from the best cluster may have been
    scanned over the third-best one where it ties the second."""
    from listbench import judge
    best = np.array([4, 1, 2, 0, 3])
    lg = np.zeros(5)
    lg[best] = [0.0428, 0.04169, 0.04165, 0.0396, 0.0381]
    sets = judge.route_sets([4], best, lg, 2, 0.001)
    assert sets == [[4, 1], [4, 2]]
    assert judge.route_sets([4], best, lg, 2, 0.0) == [[4, 1]]
    assert judge.route_sets([4, 2], best, lg, 2, 0.001) == [[4, 2]]
