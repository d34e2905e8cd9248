"""gen_late_p95_ms.serve (ms): 95th percentile of how late the load
generator sent each request after it fell due: the time the event loop
was held by the server (its flushes) or the host."""
import numpy as np

MOVES = "serve_p95_ms"
READS = "the harness's due and send times of each request"


def read(ctx):
    late = ctx["window"].get("late_ms")
    if late is None or not len(late):
        return None
    return float(np.percentile(late, 95))
