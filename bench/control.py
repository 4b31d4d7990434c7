"""Readings for the comparison's limits: the system over many seeds, and
on some of them the control and the planted faults.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3] [--out readings.jsonl]

For each seed, in one process: the cell's weights, the system's judged
rounds (``harness.Run``), then the float32 reference; the numbers of
``check.ORDER`` are the sound run's readings.  On a control seed also,
each a reference run put in the system's place on the same tokens and
scored by ``check.judge`` as the system is:

* ``control``: the reference computed with fp8 operands in every base
  weight product (the precision below the configuration's bf16); its
  sampled tokens are those the fp8 reference puts first at each
  position of the system's tokens;
* ``fault_token``: the system with one generated token a client-step
  altered where it is produced (the next id);
* ``fault_half``: the update from half the batch, the mean taken over
  the rest;
* ``fault_unchanged`` (a step that returns its state unchanged) reads 1
  on ``grad_gap``, ``delta_gap`` and ``change_gap`` by their definition
  and is not run.

Each reading is one JSON line on standard output (and in ``--out``),
with ``verdict``: whether it passes the cell's limits as they stand in
``bench/limits/`` (the control and the faults must not).  It does not
run in the benchmark's timed runs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _altered(tokens, p: int, vocab: int):
    t = tokens[:, p:].clone()
    mid = t.shape[1] // 2
    t[0, mid] = (t[0, mid] + 1) % vocab
    return t


def readings(cfg_file, traffic, seed, device, control: bool,
             base_dtype=None) -> list:
    """The (kind, numbers) readings of one seed."""
    import torch
    from firmbench import check, harness, weights
    run = harness.Run(cfg_file, traffic, seed, device,
                      base_dtype=base_dtype or weights.BF16)
    out = run.judged_rounds()
    run.free()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wq = run.reference_weights("fp8") if control else None
    w32 = run.reference_weights()
    dr = run.judged_draws()
    cfg, p, d = run.cfg, traffic["prompt_len"], sum(run.sizes)

    def judge(outputs, ref, cand=0):
        return check.judge(cfg, traffic, outputs, ref, dr, run.sizes, cand)

    def reference(outputs, **kw):
        return check.run_reference(cfg, traffic, kw.pop("w", w32), run.paths,
                                   run.lora0, dr, outputs, **kw)

    if not control:
        return [("sound", judge(out, reference(out)))]
    ctl = reference(out, w=wq, quant="fp8")
    del wq
    cands = [[[[c["picks"], _altered(prog["tokens"], p, cfg["vocab"])]
               for c, prog in zip(cs, ps)]
              for cs, ps in zip(rc["clients"], ro["clients"])]
             for rc, ro in zip(ctl["rounds"], out["rounds"])]
    ref = reference(out, candidates=cands)
    b = traffic["firm"]["batch_size"]
    half = reference(out, rows=torch.arange(b // 2, device=run.device))
    return [("sound", judge(out, ref)),
            ("control", judge(check.as_outputs(ctl, out, traffic, d), ref,
                              cand=1)),
            ("fault_token", judge(out, ref, cand=2)),
            ("fault_half", judge(check.as_outputs(half, out, traffic, d),
                                 ref))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "bench"))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from firmbench.loader import Layout, LayoutError
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    layout = Layout(ROOT)
    cell = layout.workload(args.workload)
    cfg_file = layout.config(cell["config"])
    traffic = layout.traffic(cell["traffic"])
    from firmbench import check
    try:
        limits = layout.limits(cell["name"])
    except LayoutError:
        limits = None
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            for kind, nums in readings(cfg_file, traffic, seed, "cuda",
                                       seed in args.control_seeds):
                line = json.dumps({
                    "workload": cell["name"], "seed": seed, "kind": kind,
                    "nums": nums, "verdict": None if limits is None
                    else check.verdict(nums, limits),
                    "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
