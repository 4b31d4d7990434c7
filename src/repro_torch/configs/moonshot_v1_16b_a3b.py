"""moonshot-v1-16b-a3b [dense/MoE] — kimi/moonlight MoE 64e top-6.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840.
[hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="dense",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    pattern=("moe",),
    n_periods=48,
    rope_theta=50000.0,
    moe=MoEConfig(n_experts=64, top_k=6),
    source="hf:moonshotai/Moonlight-16B-A3B",
    subquadratic=False,
)
