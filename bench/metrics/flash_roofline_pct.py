"""flash_roofline_pct: the least time the chip needs for the attention
work a round asks of the flash kernels (forward at the prefill, the
reference forward and the PPO forward; backward in each of the M pulls;
``yardstick.flops.flash_calls``, priced by the frozen copy of the
kernels' bytes and operations), over the device seconds of the
operations named below in the profiled rounds."""

KERNELS = ("flash_fwd", "flash_bwd")


def read(ctx):
    if ctx.trace is None:
        return None
    dev = sum(s for name, s in ctx.trace["ops_s"].items()
              if any(k in name for k in KERNELS))
    calls = ctx.flops.flash_calls(ctx.cfg, ctx.traffic)
    if not dev or not calls:
        return None
    f = ctx.traffic["firm"]
    least = f["n_clients"] * f["local_steps"] * ctx.flops.least_seconds(
        calls, "flash", ctx.peaks)
    return 100.0 * least / dev
