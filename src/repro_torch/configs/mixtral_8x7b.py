"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.  [arXiv:2401.04088]
SWA(4096) makes decode sub-quadratic -> eligible for long_500k.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    pattern=("moe_swa",),
    n_periods=32,
    rope_theta=1000000.0,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2),
    source="arXiv:2401.04088",
    subquadratic=True,
)
