"""scan_roofline.offline (%): the scans' least time over the device time
of the scan's kernels (fused_topk_score.cu's, by name). The least time of
a chunk is its bytes at HBM's rate or its products at the bf16 tensor-core
rate (listbench/work.py), counted from its routes: the live rows of the
distinct routed clusters read once, 2·d per (query, live row of a routed
cluster). The count does not depend on the backend that ran."""
from listbench import work
from listbench.trace import function_name, is_copy

MOVES = "qps"
READS = "device trace: scan kernel time; the scans' routes and cluster loads"


def read(ctx):
    t, scans = ctx["trace"], ctx["scans"]
    if not t or t["busy_s"] is None or not scans or not ctx["scan_kernels"]:
        return None
    cfg, k = ctx["cfg"], ctx["traffic"]["k"]
    cr = ctx["traffic"]["cr"]
    bound = sum(work.scan_bound_s(pairs // cr, pairs, pair_rows, distinct, k,
                                  cfg)
                for pairs, pair_rows, distinct in scans)
    spent = sum(s for n, s in t["device_s_by_name"].items()
                if not is_copy(n) and function_name(n) in ctx["scan_kernels"])
    if spent <= 0:
        return None
    return 100.0 * bound / spent
