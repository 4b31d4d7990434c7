"""ssd_roofline_pct: the least time the chip needs for the SSD scans a
round asks of the SSD kernels (forward at the prefill, the reference
forward and the PPO forward; backward in each of the M pulls of the
layers after the first adapter; ``yardstick.flops.ssd_calls``), over the
device seconds of the operations named below in the profiled rounds."""

KERNELS = ("ssd_scan_kernel", "ssd_bwd_")


def read(ctx):
    if ctx.trace is None:
        return None
    dev = sum(s for name, s in ctx.trace["ops_s"].items()
              if any(k in name for k in KERNELS))
    calls = ctx.flops.ssd_calls(ctx.cfg, ctx.traffic)
    if not dev or not calls:
        return None
    f = ctx.traffic["firm"]
    least = f["n_clients"] * f["local_steps"] * ctx.flops.least_seconds(
        calls, "ssd", ctx.peaks)
    return 100.0 * least / dev
