"""zamba2-1.2b [hybrid] — Mamba2 blocks + one shared attention block.

38L d_model=2048 32H (kv=32) d_ff=8192 ssm_state=64.  [arXiv:2411.15242]
Pattern: 5 Mamba2 blocks then the (single, shared-parameter) attention
block, repeated; 38 layers ~ 6 periods of (5 mamba + shared attn) + 2.
We use 6 periods of (5x mamba2 + shared_attn) + 2 extra mamba = 38 layers,
expressed as pattern len 19 x 2 periods.
"""
from repro_torch.configs.base import ModelConfig

_PERIOD = ("mamba2",) * 5 + ("shared_attn",) + ("mamba2",) * 5 + \
    ("shared_attn",) + ("mamba2",) * 5 + ("shared_attn",) + ("mamba2",)

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    pattern=_PERIOD,             # 19 slots
    n_periods=2,                 # 38 layers
    rope_theta=10000.0,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    source="arXiv:2411.15242",
    subquadratic=True,
)
