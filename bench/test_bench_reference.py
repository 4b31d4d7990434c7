"""The plain reference against one round of the system's CPU path, at a
tiny size of each configuration, on every layer the comparison covers:
the sampler and decode, the teacher-forced forward, the rewards, the
update (losses, Gram, lambda, Adam's first gradient), the codec, FedAvg
and the wire bytes."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from firmbench import check, harness, tiny  # noqa: E402


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


EXACT = ("prompts", "reward_gap", "kl_coef_gap", "codec_gap", "comm_bytes")


@pytest.mark.parametrize("config", ["zamba2-1.2b", "mixtral-8x7b"])
@pytest.mark.parametrize("traffic", ["long_prompt", "long_answer"])
def test_reference_follows_the_system(config, traffic):
    """In float32 weights the system and the reference agree to rounding
    over both judged rounds (round 2 with the KL, the critics, Adam's
    moments, lambda's smoothing and the codec's error feedback acting),
    but for the system's bf16 decode cache (the behaviour logprobs, and
    through the PPO ratio the losses and gradients)."""
    cfg, tr = tiny.cell(config, traffic)
    run = harness.Run(cfg, tr, 20260101, "cpu", base_dtype=torch.float32)
    out = run.judged_rounds()
    run.round(check.ROUNDS)
    run.free()
    nums = run.compare(out, run.reference_weights())
    assert set(nums) == set(check.ORDER), nums
    for r in range(1, check.ROUNDS + 1):
        for name in check.ROUND:
            v = nums[f"r{r}.{name}"]
            if name in EXACT:
                assert v == 0.0, (r, name, nums)
            elif name == "ref_logprob_gap":
                assert v < 1e-4, (r, name, nums)
            elif name != "token_rank":
                assert v < 0.05, (r, name, nums)
    assert nums["r2.critic_gap"] < 0.05 and nums["r2.delta_gap"] < 0.05


def test_reference_imports_nothing_of_the_system():
    for path in list((BENCH / "firmbench" / "reference").glob("*.py")) + \
            list((BENCH / "firmbench" / "yardstick").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro",
                                                  "jax", "jaxlib", "flax"), \
                    (path.name, name)
