"""Tiny same-family versions of the benchmark's cells, for the CPU tests:
the cells' configuration and traffic files with every size cut (the
layer kinds, the LoRA placement, the MoE routing, the codecs and the
vocabulary kept, so that a token's rank means what it means at full
size)."""
from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

SIZES = {
    "zamba2-1.2b": dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                        d_ff=128, vocab=32000, n_layers=8, n_periods=2,
                        pattern=["mamba2", "mamba2", "shared_attn",
                                 "mamba2"],
                        ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                        lora={"rank": 4, "alpha": 32.0}),
    "mixtral-8x7b": dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                         d_ff=96, vocab=32000, n_layers=2, n_periods=2,
                         sliding_window=8, lora={"rank": 4, "alpha": 32.0},
                         moe={"n_experts": 4, "top_k": 2,
                              "capacity_factor": 1.0,
                              "router_aux_weight": 0.01}),
}


def cell(config: str, traffic: str = "long_answer", prompt_len: int = 8,
         max_new: int = 4, batch: int = 4):
    """(configuration file, traffic) of a tiny version of a cell."""
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["model"].update(SIZES[config])
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    tr.update(prompt_len=prompt_len, max_new=max_new)
    tr["firm"]["batch_size"] = batch
    return cfg, tr
