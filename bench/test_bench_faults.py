"""The comparison fails a broken round.  At a tiny size of each cell, the
rest of a run is driven (the judged set-up rounds, the system freed, the
reference, the verdict under the cell's own limits) with the system's
timed path broken underneath: a step that returns its state unchanged,
half of the batch left out with the mean taken over the rest, a token
altered where it is produced.  The sound run passes; each fault does
not.  The control (the reference with fp8 products put in the system's
place) and the faults as ``control.py`` reads them on the chip are kept
here at the same size: scored by the same ``check.judge``, the sound
system passes the cell's limits and each of them fails."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from firmbench import check, harness, tiny  # noqa: E402

CELLS = [("zamba2-1.2b", "long_prompt"), ("mixtral-8x7b", "long_answer")]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _limits(config, traffic):
    return json.loads((BENCH / "limits" / f"{config}.{traffic}.json")
                      .read_text())


def _verdict(config, traffic, seed=424242):
    cfg, tr = tiny.cell(config, traffic)
    run = harness.Run(cfg, tr, seed, "cpu", base_dtype=torch.float32)
    out = run.judged_rounds()
    run.free()
    nums = run.compare(out, run.reference_weights())
    return check.verdict(nums, _limits(config, traffic)), nums


def _unchanged(orig):
    def step(cfg, fc, state, frozen, batch, *a, **kw):
        _, metrics = orig(cfg, fc, state, frozen, batch, *a, **kw)
        return state, metrics
    return step


def _half(orig):
    def step(cfg, fc, state, frozen, batch, *a, **kw):
        b = batch.tokens.shape[0] // 2
        return orig(cfg, fc, state, frozen, type(batch)(*(t[:b] for t in
                                                         batch)), *a, **kw)
    return step


def _token(orig):
    calls = [0]

    def categorical(logits, noise):
        nxt = orig(logits, noise)
        calls[0] += 1
        if calls[0] == 2:                  # the second decode step
            nxt = nxt.clone()
            nxt[0] = (nxt[0] + 1) % logits.shape[-1]
        return nxt
    return categorical


@pytest.mark.parametrize("config,traffic", CELLS)
def test_sound_run_is_correct(config, traffic):
    ok, nums = _verdict(config, traffic)
    assert ok, nums


@pytest.mark.parametrize("config,traffic", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "token"])
def test_fault_is_not_correct(config, traffic, fault, monkeypatch):
    from repro_torch.rlhf import local, sampling
    if fault == "token":
        monkeypatch.setattr(sampling, "categorical",
                            _token(sampling.categorical))
    else:
        wrap = _unchanged if fault == "unchanged" else _half
        monkeypatch.setattr(local, "firm_local_step",
                            wrap(local.firm_local_step))
    ok, nums = _verdict(config, traffic)
    assert not ok, nums


@pytest.mark.parametrize("config,traffic", CELLS)
def test_control_and_faults_fail_the_limits(config, traffic):
    """``control.readings`` at the tiny size: the sound system passes the
    cell's limits; the fp8 control, the altered token and half the batch,
    each scored by ``check.judge``, fail them."""
    sys.path.insert(0, str(BENCH))
    import control
    cfg, tr = tiny.cell(config, traffic)
    lines = dict(control.readings(cfg, tr, 515151, "cpu", True,
                                  base_dtype=torch.float32))
    limits = _limits(config, traffic)
    assert check.verdict(lines["sound"], limits), lines["sound"]
    for kind in ("control", "fault_token", "fault_half"):
        assert not check.verdict(lines[kind], limits), (kind, lines[kind])
