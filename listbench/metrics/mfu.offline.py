"""mfu.offline (%): the offline window's model FLOPs over the traced
window's seconds at the H100's bf16 peak. Counted from shapes
(listbench/work.py): the tower over each query's unpadded tokens, the
mixing weights and the router per query, and 2·d per (query, live row of
a routed cluster) from the recorded routes."""
from listbench import work

MOVES = "qps"
READS = "device trace: window length; query lengths; the scans' routes"


def read(ctx):
    t, scans = ctx["trace"], ctx["scans"]
    if not t or t["busy_s"] is None or not scans or t["window_s"] <= 0:
        return None
    cfg = ctx["cfg"]
    flops = work.queries_flops(ctx["window"]["lengths"], cfg)
    flops += sum(work.scan_flops(pair_rows, cfg) for _, pair_rows, _ in scans)
    return 100.0 * flops / (t["window_s"] * work.PEAK_BF16_FLOPS)
