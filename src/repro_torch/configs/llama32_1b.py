"""llama-3.2-1b — the paper's own experimental model (Sec. 5).

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B-Instruct]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    pattern=("attn",),
    n_periods=16,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-1B-Instruct",
    subquadratic=False,
)
