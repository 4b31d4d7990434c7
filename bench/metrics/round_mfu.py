"""round_mfu: the model FLOPs of a round (``yardstick.flops.round_flops``,
a frozen function of the configuration and the traffic) over the
window's seconds per round, against the H100's 989 TFLOP/s (bf16,
dense).  In a traced run the window's profiled rounds are left out."""


def read(ctx):
    flops = ctx.flops.round_flops(ctx.cfg, ctx.traffic)
    return 100.0 * flops / (ctx.round_s * ctx.peaks.FLOPS["bf16"])
