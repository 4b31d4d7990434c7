"""mixtral-8x22b [moe] — 8 experts top-2, SWA.  [arXiv:2401.04088]

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    pattern=("moe_swa",),
    n_periods=56,
    rope_theta=1000000.0,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2),
    source="arXiv:2401.04088",
    subquadratic=True,
)
