"""update_s: device seconds a round of the operations launched inside
the benchmark's ``bench.update`` range, which wraps every call of the
algorithm's ``step`` (the update graph: PPO forward, M backward pulls,
Gram, MGDA, Adam, critics)."""

RANGE = "bench.update"


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace["ranges_s"].get(RANGE) or None
