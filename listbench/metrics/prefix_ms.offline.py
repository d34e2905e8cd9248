"""prefix_ms.offline (ms): device milliseconds per query chunk in kernels
that are not the scan's own (the kernels of fused_topk_score.cu, by
name): the encoder, the route, auto's route pass and the fold."""
from listbench.trace import function_name, is_copy

MOVES = "qps"
READS = "device trace: kernel time by name; the scan source's kernel names"


def read(ctx):
    t = ctx["trace"]
    if not t or t["busy_s"] is None or not ctx["chunks"] or not ctx["scan_kernels"]:
        return None
    other = sum(s for n, s in t["device_s_by_name"].items()
                if not is_copy(n) and function_name(n) not in ctx["scan_kernels"])
    return 1e3 * other / ctx["chunks"]
