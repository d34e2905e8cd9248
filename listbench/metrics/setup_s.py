"""setup_s (s): from the start of the run's process to the first timed
query, by the host's clock: imports, CUDA start, the kernel library's
build where none is cached, weights, objects, placement and warm-up."""
MOVES = None
READS = "the harness's clock at start and at the window's start"


def read(ctx):
    return ctx["setup_s"]
