"""llama-3.2-vision-90b [vlm] — cross-attn image layers.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
[hf:meta-llama/Llama-3.2-11B-Vision] (90B scale-up per assignment).
Cross-attention layers are interleaved every 5th layer; the vision encoder
is a stub — ``input_specs`` supplies precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    pattern=("attn", "attn", "attn", "attn", "cross"),
    n_periods=20,
    rope_theta=500000.0,
    n_vision_tokens=1601,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    subquadratic=False,
)
