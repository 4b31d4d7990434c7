"""The harness takes a new cell as data: the loader finds a new
configuration, traffic mix and metric by name in a copy of the layout,
and refuses names and units with other characters; the benchmark's
weight layout is the system's parameter tree."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from firmbench import loader, weights  # noqa: E402


def _copy(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    (root / "bench").mkdir(parents=True)
    shutil.copy(BENCH.parent / "BENCHMARK.json", root)
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(BENCH / sub, root / "bench" / sub)
    return root


def test_new_cell_is_data(tmp_path):
    root = _copy(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "zamba2-1.2b.json").read_text())
    cfg["name"] = "zamba2-1.2b-wide_v2"
    (root / "bench/configs/zamba2-1.2b-wide_v2.json").write_text(
        json.dumps(cfg))
    (root / "bench/traffic/short.mix-1.json").write_text(json.dumps(
        {"name": "short.mix-1", "prompt_len": 16, "max_new": 8}))
    (root / "bench/metrics/decode_tok.s.py").write_text(
        "def read(ctx):\n    return ctx.round_s * 2\n")
    (root / "bench/limits/zamba2-1.2b-wide_v2.short.mix-1.json").write_text(
        json.dumps({"prompts": 0}))
    spec["configs"].append({"name": "zamba2-1.2b-wide_v2", "source": "x",
                            "file": "bench/configs/zamba2-1.2b-wide_v2.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "zamba2-1.2b-wide_v2.short.mix-1",
                              "config": "zamba2-1.2b-wide_v2",
                              "traffic": "short.mix-1", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "decode_tok.s", "unit": "tokens/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "rollout", "moves": "round_s",
                              "workloads": ["zamba2-1.2b-wide_v2.short.mix-1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    lay = loader.Layout(root)
    name = "zamba2-1.2b-wide_v2.short.mix-1"
    cell = lay.workload(name)
    assert lay.config(cell["config"])["name"] == "zamba2-1.2b-wide_v2"
    assert lay.traffic(cell["traffic"])["prompt_len"] == 16
    assert lay.limits(name) == {"prompts": 0}
    traced = [m["name"] for m in lay.metrics(name, trace=True)]
    assert "decode_tok.s" in traced and "ssd_roofline_pct" not in traced
    assert "decode_tok.s" not in [m["name"] for m in lay.metrics(
        "zamba2-1.2b.long_prompt", trace=True)]
    assert [m["name"] for m in lay.metrics(name, trace=False)] == \
        ["round_s", "setup_s"]

    class Ctx:
        round_s = 1.5
    assert lay.reader("decode_tok.s")(Ctx()) == 3.0


@pytest.mark.parametrize("bad", ["has space", "a/b", "x,y", "", ".hidden",
                                 "é", "a" * 65])
def test_bad_names_refused(tmp_path, bad):
    root = _copy(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"][0]["name"] = bad
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(loader.LayoutError):
        loader.Layout(root)
    with pytest.raises(loader.LayoutError):
        loader.check_name(bad)


@pytest.mark.parametrize("bad", ["tokens per s", "µs", "", "a" * 17])
def test_bad_units_refused(tmp_path, bad):
    root = _copy(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"][0]["unit"] = bad
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(loader.LayoutError):
        loader.Layout(root)


def test_missing_pieces_refused(tmp_path):
    root = _copy(tmp_path)
    lay = loader.Layout(root)
    with pytest.raises(loader.LayoutError):
        lay.workload("no-such.cell")
    with pytest.raises(loader.LayoutError):
        lay.traffic("no_such_mix")
    with pytest.raises(loader.LayoutError):
        lay.reader("no_such_metric")


def test_every_declared_piece_resolves():
    lay = loader.Layout(BENCH.parent)
    for cell in lay.spec["workloads"]:
        assert lay.config(cell["config"])["name"] == cell["config"]
        assert lay.traffic(cell["traffic"])["name"] == cell["traffic"]
        assert lay.limits(cell["name"])
        for trace in (False, True):
            for m in lay.metrics(cell["name"], trace):
                assert callable(lay.reader(m["name"]))


@pytest.mark.parametrize("name", ["zamba2-1.2b", "mixtral-8x7b"])
def test_weight_layout_is_the_system_tree(name):
    from repro_torch.models import transformer
    from firmbench import program
    cfg_file = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    want = transformer.init_params(program.model_config(cfg_file),
                                   generator=torch.Generator(),
                                   device="meta")
    got = weights.leaves(weights.layout(cfg_file["model"]))
    flat = []

    def walk(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            flat.append((path, (tuple(t.shape), t.dtype)))
    walk(want)
    assert [(p, (tuple(s), d)) for p, (s, d) in got] == flat


def test_config_files_are_the_system_configs():
    """Each configuration file's model is the system's own config of that
    name, but for the keys its ``reduced`` lists."""
    from repro_torch.configs import get_config
    from firmbench import program
    import dataclasses
    for name in ("zamba2-1.2b", "mixtral-8x7b"):
        cfg_file = json.loads((BENCH / "configs" / f"{name}.json")
                              .read_text())
        mine = dataclasses.asdict(program.model_config(cfg_file))
        ref = dataclasses.asdict(get_config(name))
        diff = {k for k in ref if mine[k] != ref[k]}
        assert diff == set(cfg_file["reduced"]), diff
