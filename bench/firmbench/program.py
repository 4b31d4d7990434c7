"""The system under test, driven through its front door.

``build`` turns a configuration file and a traffic mix into the
system's ``RunSpec`` and the trainer that ``plan(spec).build`` gives, on
the benchmark's weights.  ``Probe`` puts thin wrappers around the calls
between the round's layers (module functions of the engine, the
sampler, the rewards, and the trainer's own stages): each opens a
profiler range named ``bench.<layer>`` while ``ranges`` is on, and
keeps what the call returned while ``keep`` is on.  The wrappers pass
every argument and result through unchanged; ``close`` puts the
originals back.
"""
from __future__ import annotations

import contextlib

import torch

# profiler range names: the benchmark's layers
ROUND, ROLLOUT, UPDATE = "bench.round", "bench.rollout", "bench.update"


def model_config(cfg_file: dict):
    """The system's ModelConfig of a configuration file's ``model``."""
    from repro_torch.configs.base import LoRAConfig, MoEConfig, ModelConfig
    m = dict(cfg_file["model"])
    m["pattern"] = tuple(m["pattern"])
    m["lora"] = LoRAConfig(**m["lora"]) if m.get("lora") else None
    m["moe"] = MoEConfig(**m["moe"]) if m.get("moe") else None
    return ModelConfig(**m)


def build(cfg_file: dict, traffic: dict, params, device, seed: int):
    """(trainer, plan) of the cell through ``plan(RunSpec(...)).build``;
    ``seed`` seeds the system's own draws."""
    from repro_torch.configs.base import FIRMConfig
    from repro_torch.fed import api
    if traffic.get("temperature", 1.0) != 1.0:
        raise ValueError("the system samples at temperature 1")
    cfg = model_config(cfg_file)
    fc = FIRMConfig(**traffic["firm"])
    ec = api.EngineConfig(prompt_len=traffic["prompt_len"],
                          max_new=traffic["max_new"],
                          uplink_codec=traffic["uplink_codec"],
                          downlink_codec=traffic["downlink_codec"],
                          seed=int(seed))
    plan = api.plan(api.RunSpec(model=cfg, firm=fc, engine=ec))
    return plan.build(device=device, params=params), plan


class Probe:
    """Ranges and keeps around the round's layers of ``trainer``."""

    def __init__(self, trainer):
        from repro_torch.fed import engine
        from repro_torch.models import transformer
        from repro_torch.rlhf import rewards, sampling
        self.ranges = False
        self.keep = False
        self.kept = {"rollout": [], "update": [], "uplink": []}
        self._undo = []
        self._patch(engine, "rollout_batch", ROLLOUT, "rollout")
        self._patch(engine, "generate", "bench.generate")
        self._patch(engine, "_ref_logprobs", "bench.ref_logprobs")
        self._patch(rewards, "score_batch_banded", "bench.rewards")
        self._patch(transformer, "prefill", "bench.prefill")
        self._patch(sampling, "decode", "bench.decode")
        self._patch(trainer.algorithm, "step", UPDATE, "update",
                    instance=True)
        for name, label in (("_broadcast", "broadcast"),
                            ("_delta_flat", "delta"),
                            ("_aggregate_flat", "aggregate"),
                            ("_record", "record")):
            self._patch(trainer, name, f"bench.{label}", instance=True)
        self._patch(trainer, "_uplink", "bench.uplink", "uplink",
                    instance=True)

    def _patch(self, owner, attr, range_name, keep_as=None, instance=False):
        orig = getattr(owner, attr)
        probe = self

        def wrapped(*args, **kwargs):
            with (torch.profiler.record_function(range_name) if probe.ranges
                  else contextlib.nullcontext()):
                out = orig(*args, **kwargs)
            if keep_as and probe.keep:
                probe.kept[keep_as].append((args, kwargs, out))
            return out

        setattr(owner, attr, wrapped)
        if instance:
            self._undo.append(lambda: delattr(owner, attr))
        else:
            self._undo.append(lambda: setattr(owner, attr, orig))

    def close(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()
        self.kept = {k: [] for k in self.kept}

    @contextlib.contextmanager
    def round_range(self):
        with (torch.profiler.record_function(ROUND) if self.ranges
              else contextlib.nullcontext()):
            yield
