"""One cell's system, set up from the seed, and its comparison.

``Run`` holds the weights, the trainer and its probe.  ``judged_rounds``
runs rounds 1 and 2 with every draw injected (prompts, sampling noise,
codec offsets: the reference needs them) and keeps what the comparison
judges; ``round`` runs a later round as a user's job runs it: the
prompts injected, the sampling noise and the codec's offsets from the
system's own generators, seeded from the run's seed through
``EngineConfig.seed``.  ``free`` drops the system (its trainer, its
graphs and their memory pools); ``compare`` then runs the plain
reference on the weights alone and returns the numbers of
``check.ORDER``.
"""
from __future__ import annotations

import gc
import math

import torch

from firmbench import check, draws, program, weights
from firmbench.reference import round as ref_round


class Run:
    def __init__(self, cfg_file: dict, traffic: dict, seed: int, device,
                 base_dtype=weights.BF16):
        self.cfg_file, self.traffic, self.seed = cfg_file, traffic, seed
        self.cfg = cfg_file["model"]
        self.device = torch.device(device)
        self.params = weights.make(self.cfg, seed, self.device, base_dtype)
        self.paths = ref_round.trainable_paths(self.params)
        self.lora0 = [ref_round.get(self.params, p).clone()
                      for p in self.paths]
        self.sizes = [t.numel() for t in self.lora0]
        self.trainer, self.plan = program.build(cfg_file, traffic,
                                                self.params, self.device,
                                                seed)
        self.probe = program.Probe(self.trainer)
        self.clients = list(range(traffic["firm"]["n_clients"]))
        self.d = self.plan.d_trainable

    def draw(self, r: int, noise: bool = True) -> dict:
        return draws.draw(self.traffic, self.cfg["vocab"], self.d,
                          self.seed, r, self.device, noise=noise)

    def round(self, r: int, inject: bool = False) -> dict:
        """Round r + 1; with ``inject`` every draw injected, else the
        prompts alone."""
        dr = self.draw(r, noise=inject)
        with self.probe.round_range():
            return self.trainer.run_round(self.clients, **dr)

    def judged_rounds(self) -> dict:
        """Rounds 1 and 2, with what the comparison judges kept."""
        rounds, sent = [], 0
        for r in range(check.ROUNDS):
            self.probe.keep = True
            try:
                summary = self.round(r, inject=True)
            finally:
                self.probe.keep = False
            rounds.append(check.collect(
                self.probe, self.trainer, summary, self.paths,
                self.traffic["firm"]["local_steps"], sent))
            sent = int(summary["comm_bytes"])
            self.probe.kept = {k: [] for k in self.probe.kept}
        return {"rounds": rounds}

    def judged_draws(self) -> list:
        return [self.draw(r) for r in range(check.ROUNDS)]

    def free(self) -> None:
        """Drop the system and its device memory; the weights stay."""
        from repro_torch.rlhf import sampling
        self.probe.close()
        self.trainer = self.plan = self.probe = None
        gc.collect()
        sampling._LAST_GRAPHS.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_weights(self, quant=None) -> dict:
        """The weights as the reference reads them (float32, or with fp8
        base matrices); ``quant`` None also drops the bf16 copy."""
        w = ref_round.to_f32(self.params, quant)
        if quant is None:
            self.params = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        return w

    def compare(self, outputs: dict, w32: dict) -> dict:
        """The numbers of ``check.ORDER`` for the judged rounds."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dr = self.judged_draws()
        ref = check.run_reference(self.cfg, self.traffic, w32, self.paths,
                                  self.lora0, dr, outputs)
        return check.judge(self.cfg, self.traffic, outputs, ref, dr,
                           self.sizes)


def finite_summary(s: dict) -> bool:
    vals = [float(v) for v in list(s["rewards"]) + list(s["lam_mean"])]
    return all(math.isfinite(v) for v in vals + [s["kl"], s["param_drift"]])
