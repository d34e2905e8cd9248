"""serve_p95_ms (ms): 95th percentile of the open loop's latencies, each
timed from when the request fell due, over every request answered."""
import numpy as np

MOVES = None
READS = "the harness's due and answer times of each request"


def read(ctx):
    lat = ctx["window"].get("latency_ms")
    if lat is None or not len(lat):
        return None
    return float(np.percentile(lat, 95))
