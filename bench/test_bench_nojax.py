"""Nothing a benchmark run loads is JAX or the JAX package: the run's
modules imported in a fresh process leave no module whose top-level name
is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (``repro_torch`` is the
system, not ``repro``)."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROGRAM = """
import sys
sys.path[:0] = [{bench!r}, {src!r}]
import run
from firmbench import check, harness, loader, program, trace
"""


def test_run_modules_load_no_jax():
    code = PROGRAM.format(bench=str(ROOT / "bench"), src=str(ROOT / "src"))
    code += """
from repro_torch.fed import api, engine
from repro_torch.rlhf import sampling, update_graph
lay = loader.Layout(run.ROOT)
for m in lay.spec["per_layer"] + lay.spec["end_to_end"]:
    lay.reader(m["name"])
bad = run.forbidden_modules()
assert "repro_torch" in sys.modules and not bad, bad
sys.modules["repro.core"] = sys.modules["sys"]
assert run.forbidden_modules() == ["repro.core"]
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
