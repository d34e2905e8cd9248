"""kernels_per_chunk.offline (count): device kernels launched in the
traced window per query chunk of the engine's batch."""
MOVES = "qps"
READS = "device trace: kernel count; the harness's chunk count"


def read(ctx):
    t = ctx["trace"]
    if not t or t["busy_s"] is None or not ctx["chunks"] or not t["n_kernels"]:
        return None
    return t["n_kernels"] / ctx["chunks"]
