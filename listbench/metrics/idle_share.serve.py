"""idle_share.serve (%): share of the traced served window in which no
operation ran on the device (torch.profiler's device events, their
union)."""
MOVES = "serve_p95_ms"
READS = "device trace: busy time and the window's length"


def read(ctx):
    t = ctx["trace"]
    if not t or t["busy_s"] is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
