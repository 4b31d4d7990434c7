"""Set a cell's comparison limits from its readings.

    python3 bench/set_limits.py <readings.jsonl> [...] [--write]

The readings are ``control.py``'s lines.  For each number of
``check.ORDER``:

* the lower reading is the largest a sound run gives (over a dozen
  seeds or more);
* the upper reading is the least of: the control's smallest reading,
  where that is three times the lower or more; each planted fault's
  smallest reading, where that is ten times the lower or more (a step
  that returns its state unchanged reads 1 on ``grad_gap``,
  ``delta_gap`` and ``change_gap`` by their definition, and counts at
  three times);
* a number that reads 0 on every sound run is an exact comparison:
  limit 0;
* a number with an upper reading gets the limit 60% of the way from the
  lower to the upper reading on a log scale, rounded to two digits;
* a number with neither is not compared, and is listed with its
  readings.

Then every reading is held to the limits: each control and fault
reading has to fail them (``check.verdict`` false) and each sound one
pass them (on the numbers it has), or the script exits with 1.  ``--write`` writes
``bench/limits/<cell>.json``; without it the table is only printed.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
UNCHANGED = ("grad_gap", "delta_gap", "change_gap")


def _round2(x: float) -> float:
    digits = 1 - int(math.floor(math.log10(x)))
    return round(x, digits)


def limits(rows: list, order) -> tuple:
    """(limits, table rows) of one cell's readings."""
    by = {}
    for r in rows:
        by.setdefault(r["kind"], []).append(r["nums"])
    out, table = {}, []
    for name in order:
        sound = [n[name] for n in by.get("sound", []) if name in n]
        if not sound:
            continue
        lower = max(sound)
        ups = []
        ctl = [n[name] for n in by.get("control", []) if name in n]
        if ctl and lower > 0 and min(ctl) >= 3 * lower:
            ups.append(("control", min(ctl)))
        for kind in by:
            if not kind.startswith("fault_"):
                continue
            vals = [n[name] for n in by[kind] if name in n]
            if vals and lower > 0 and min(vals) >= 10 * lower:
                ups.append((kind, min(vals)))
        if name.split(".")[-1] in UNCHANGED and 0 < lower <= 1 / 3:
            ups.append(("fault_unchanged", 1.0))
        if lower == 0:
            limit, why = 0.0, "exact"
        elif ups:
            src, upper = min(ups, key=lambda u: u[1])
            limit = _round2(math.exp(0.4 * math.log(lower)
                                     + 0.6 * math.log(upper)))
            why = f"upper {upper:.4g} ({src})"
        else:
            limit, why = None, "no upper reading: not compared"
        if limit is not None:
            out[name] = limit
        table.append((name, len(sound), lower, min(ctl) if ctl else None,
                      limit, why))
    return out, table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("readings", nargs="+")
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    from firmbench.check import ORDER, verdict
    rows = [json.loads(line) for path in args.readings
            for line in Path(path).read_text().splitlines() if line.strip()]
    status = 0
    for cell in sorted({r["workload"] for r in rows}):
        lim, table = limits([r for r in rows if r["workload"] == cell],
                            ORDER)
        print(f"{cell}: {len({r['seed'] for r in rows if r['workload'] == cell})} seeds")
        for name, n, lower, ctl, limit, why in table:
            print(f"  {name:17s} n={n:2d} lower {lower:.4g} control "
                  f"{'-' if ctl is None else f'{ctl:.4g}'} limit {limit} "
                  f"({why})")
        passed = [(r["seed"], r["kind"]) for r in rows
                  if r["workload"] == cell and r["kind"] != "sound"
                  and verdict(r["nums"], lim)]
        failed_sound = [r["seed"] for r in rows if r["workload"] == cell
                        and r["kind"] == "sound" and not verdict(
                            r["nums"], {k: v for k, v in lim.items()
                                        if k in r["nums"]})]
        print(f"  control and faults passing the limits: {passed or 'none'}"
              f"; sound runs failing them: {failed_sound or 'none'}")
        status |= bool(passed or failed_sound)
        if args.write:
            path = BENCH / "limits" / f"{cell}.json"
            path.write_text(json.dumps(lim, indent=2) + "\n")
    return status


if __name__ == "__main__":
    sys.exit(main())
