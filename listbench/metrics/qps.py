"""qps (queries/s): every query answered in the offline window over the
window's seconds, by the host's clock. Moves with every layer."""
MOVES = None
READS = "the harness's window: queries answered and its length"


def read(ctx):
    win = ctx["window"]
    if win["window_s"] <= 0:
        return None
    return (win["attempted"] - win["failed"]) / win["window_s"]
