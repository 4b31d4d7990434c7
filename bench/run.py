"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A cell (``BENCHMARK.json``'s
``workloads``) is a configuration and a traffic mix.  Set-up: the
weights drawn from the seed on the card, the trainer through the
system's front door (``plan(RunSpec(...)).build``, its own draws seeded
from the seed), then rounds 1 and 2, whose outputs the comparison
judges, with every draw injected.  The window then runs whole
``run_round`` calls, each with its round's prompts drawn from the seed
and its sampling noise and codec offsets from the system's own
generators, until ``--seconds`` have passed.  With ``--trace 1`` the
window's first two rounds run under the profiler.  After the window the
system is freed and the plain reference works rounds 1 and 2 out again
(``firmbench.check``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with a trace
``breakdown``), then ``checks``, each number compared with its limit.
The run fails, printing no result, without a card, or if JAX or the
JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILED_ROUNDS = 2


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def caches() -> None:
    """Every kernel and build cache at a fixed place in the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Context:
    """What the metric readers (``bench/metrics/*.py``) read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def main(argv=None) -> int:
    args = parse(argv)
    caches()
    sys.path.insert(0, str(ROOT / "bench"))
    from firmbench.loader import Layout
    layout = Layout(ROOT)
    cell = layout.workload(args.workload)
    cfg_file = layout.config(cell["config"])
    traffic = layout.traffic(cell["traffic"])
    limits = layout.limits(cell["name"])
    wanted = layout.metrics(cell["name"], bool(args.trace))
    readers = {m["name"]: layout.reader(m["name"]) for m in wanted}

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(2)
    from firmbench import check, harness, trace
    from firmbench.yardstick import flops, peaks

    # ------------------------------------------------------------ set-up
    run = harness.Run(cfg_file, traffic, args.seed, torch.device("cuda", 0))
    outputs = run.judged_rounds()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    # ------------------------------------------------------------ window
    # what set-up cached but the window never uses leaves the peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    attempted = failed = 0
    r = check.ROUNDS
    tr = None
    timed_n = 0
    times = []

    def one_round() -> None:
        nonlocal attempted, failed, r
        attempted += 1
        t = time.perf_counter()
        try:
            if not harness.finite_summary(run.round(r)):
                failed += 1
        except Exception as exc:           # a failed round is counted
            print(f"round {r + 1} raised {exc!r}", file=sys.stderr)
            failed += 1
        times.append(time.perf_counter() - t)
        r += 1

    t0 = time.perf_counter()
    if args.trace:
        run.probe.ranges = True
        prof, host_s = trace.profile(
            lambda: [one_round() for _ in range(PROFILED_ROUNDS)])
        run.probe.ranges = False
    t1 = time.perf_counter()
    while True:
        one_round()
        timed_n += 1
        if failed or time.perf_counter() - t0 >= args.seconds:
            break
    window_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_reserved()
    peak_alloc = torch.cuda.max_memory_allocated()
    round_s = window_s / timed_n
    if args.trace:
        tr = trace.reduce(prof, host_s, PROFILED_ROUNDS)
        del prof

    # -------------------------------------------------- the comparison
    run.free()
    t_ref = time.perf_counter()
    nums = run.compare(outputs, run.reference_weights())
    ref_s = time.perf_counter() - t_ref
    correct = check.verdict(nums, limits) and failed == 0

    bad = forbidden_modules()
    if bad:
        print(f"the run loaded JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3

    ctx = Context(cfg=cfg_file["model"], traffic=traffic, round_s=round_s,
                  setup_s=setup_s, peak_bytes=peak, trace=tr, flops=flops,
                  peaks=peaks, rounds=timed_n)
    metrics = {}
    for m in wanted:
        v = readers[m["name"]](ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
        print(f"trace: {tr['n_ops']} device operations over "
              f"{PROFILED_ROUNDS} rounds, {tr['attributed_share']:.4f} of "
              f"their time attributed to a range; ranges "
              f"{json.dumps(tr['ranges_s'])}", file=sys.stderr)
    print(f"set-up {setup_s:.3f} s, window {window_s:.3f} s over "
          f"{timed_n} rounds, reference {ref_s:.3f} s; peak reserved "
          f"{peak} B, allocated {peak_alloc} B; rounds (s) "
          f"{json.dumps([round(t, 4) for t in times])}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": limits.get(k)}
                        for k, v in nums.items()}
    for k, v in nums.items():
        print(f"check {k} {v!r} limit {limits.get(k)!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
