#!/usr/bin/env python3
"""The dry-run's host seconds for one (arch, shape, mesh) pair at cut
sequence lengths: what each token of a recurrence costs the traced step.

    PYTHONPATH=src python3 scripts/dryrun_host_cost.py \\
        --arch xlstm-125m --shape train_4k --mesh multi --seq-len 256 512

``PYTHONPATH`` names the tree that is timed: the ``src`` of another
commit's checkout times that commit's port (without ``scan_on_shards``,
its own path).

Runs ``launch.dryrun.run_pair`` once a length, the shape's sequence cut to
that length (the batch and everything else as the shape has them), in
this process, after one warm-up pair at the first length.  ``--path``
picks how the scans run: ``replayed`` (the port's: on the shards, the
middle steps replayed under the counter), ``shards`` (on the shards,
every step run: ``launch.replay.counted_scan`` replaced by the plain
loop) or ``per-op`` (the loop of DTensor operations:
``launch.rules.scan_on_shards`` replaced by one that never applies); a
tree without ``scan_on_shards`` runs its own path.  Prints one JSON line
a length: ``trace_s``, the counter's
totals, and ``s_per_token_layer``, the seconds between two lengths over
the tokens between them times the sLSTM layers (the recurrences that
run a step a token), so the fixed cost of the step drops out.  The
numbers are this host's, on the CPU: torch's ``fake`` process group runs
no collective and the shards are ``meta`` tensors.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

if importlib.util.find_spec("repro_torch") is None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import FIRMConfig  # noqa: E402
from repro_torch.launch import dryrun, rules  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="multi", choices=["single", "multi"])
    ap.add_argument("--seq-len", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--path", default="replayed",
                    choices=["replayed", "shards", "per-op"])
    args = ap.parse_args(argv)
    if args.path == "per-op" and hasattr(rules, "scan_on_shards"):
        rules.scan_on_shards = lambda *a, **k: None
    if args.path == "shards" and hasattr(rules, "replay"):
        from repro_torch.models import common
        rules.replay.counted_scan = (
            lambda counter, *a: common.scan_loop(*a))
    fc = FIRMConfig(n_objectives=2, local_steps=2)
    layers = get_config(args.arch).pattern.count("slstm") * \
        get_config(args.arch).n_periods
    full = INPUT_SHAPES[args.shape]
    last = None
    for i, n in enumerate([args.seq_len[0]] + list(args.seq_len)):
        INPUT_SHAPES[args.shape] = dataclasses.replace(full, seq_len=n)
        rec = dryrun.run_pair(args.arch, args.shape, args.mesh == "multi",
                              fc)
        if i == 0:
            continue                      # the warm-up pair
        out = {"arch": args.arch, "shape": args.shape, "mesh": rec["mesh"],
               "seq_len": n, "path": args.path,
               "status": rec["status"], "trace_s": rec.get("trace_s")}
        for k in ("flops_per_device", "bytes_per_device",
                  "collective_bytes_per_device", "kernel_calls"):
            out[k] = rec.get(k)
        if last is not None and layers:
            out["s_per_token_layer"] = ((rec["trace_s"] - last[1])
                                        / ((n - last[0]) * layers))
        last = (n, rec.get("trace_s"))
        print(json.dumps(out), flush=True)
    INPUT_SHAPES[args.shape] = full
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
