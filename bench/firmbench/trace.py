"""Whole rounds under ``torch.profiler``, reduced to what the per-layer
metrics read.

Each device operation is attributed through its correlation id to the
host call that launched it (a kernel launch, a copy, or the launch of a
CUDA graph, whose kernels all carry that launch's id), and so to the
benchmark's ``bench.*`` ranges (``program.Probe``) that were open on the
host at that moment.  Nothing synchronises between the parts of a round.
The reduction keeps, per profiled round: the device seconds attributed to
each range, the device seconds of each operation name, the busy seconds
(the union of the operations' intervals), the ten operations that took
most time and the ten longest idle gaps, each named by the innermost
range the host was in when it launched the operation that ended the gap.
"""
from __future__ import annotations

import time

import torch


def profile(run_rounds) -> tuple:
    """(events, host seconds) of ``run_rounds()`` under the profiler; it
    must end with the device idle (a round ends in a copy to the host)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_rounds()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    return prof, host_s


def reduce(prof, host_s: float, rounds: int) -> dict:
    """The per-round reduction of a profile (see the module's text)."""
    on_card = torch.autograd.DeviceType.CUDA
    dev, launches, ranges = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == on_card:
            if name.startswith("bench."):
                continue            # the range's own span on the device
            dev.append((e.start_ns(), e.duration_ns(), name,
                        e.correlation_id()))
        elif name.startswith("bench."):
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           name))
        elif name.startswith("cu") and e.correlation_id():
            # a runtime or driver call that launched device work
            launches[e.correlation_id()] = e.start_ns()
    del prof
    ranges.sort()
    dev.sort()
    by_range, by_name, attributed = {}, {}, 0.0
    owner = [None] * len(dev)
    # sweep the launches in time order through the (nested) ranges
    order = sorted((launches[c], i) for i, (_, _, _, c) in enumerate(dev)
                   if c in launches)
    active, nxt = [], 0
    for t, i in order:
        while nxt < len(ranges) and ranges[nxt][0] <= t:
            active.append(ranges[nxt])
            nxt += 1
        active = [r for r in active if r[1] >= t]
        if not active:
            continue
        s = dev[i][1] * 1e-9
        for _, _, rname in active:
            by_range[rname] = by_range.get(rname, 0.0) + s
        owner[i] = max(active)[2]           # the latest to open
        attributed += s
    for _, dur, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-9
    busy, gaps, end = 0.0, [], None
    for (start, dur, _, _), inner in zip(dev, owner):
        if end is not None and start > end:
            gaps.append(((start - end) * 1e-9, inner or "outside"))
        if end is None or start > end:
            busy += dur * 1e-9
            end = start + dur
        elif start + dur > end:
            busy += (start + dur - end) * 1e-9
            end = start + dur
    total = sum(by_name.values())
    per = 1.0 / max(rounds, 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "rounds": rounds,
        "ranges_s": {k: v * per for k, v in by_range.items()},
        "ops_s": {k: v * per for k, v in by_name.items()},
        "busy_s": busy * per,
        "window_s": host_s * per,
        "attributed_share": attributed / total if total else 0.0,
        "n_ops": len(dev),
        "device_ops": [[k, v * per] for k, v in top],
        "idle_gaps": [[name, s] for s, name in
                      sorted(gaps, key=lambda g: -g[0])[:10]],
    }
