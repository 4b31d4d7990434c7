"""rollout_s: device seconds a round of the operations launched inside
the benchmark's ``bench.rollout`` range, which wraps every call of the
engine's ``rollout_batch`` (generation: prefill and the decode graph;
the rewards; the frozen reference's logprobs).  CUDA-graph replays count
for the range that launched them."""

RANGE = "bench.rollout"


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace["ranges_s"].get(RANGE) or None
