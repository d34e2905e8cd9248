"""batch_fill.serve (%): rows of real requests over the rows of the
engine batches the server ran (StreamingServer.metrics()["batch_fill"])."""
MOVES = "serve_p95_ms"
READS = "program counter: StreamingServer.metrics() after the window"


def read(ctx):
    m = ctx["server"]
    if not m or not m.get("engine_batches"):
        return None
    return 100.0 * m["batch_fill"]
