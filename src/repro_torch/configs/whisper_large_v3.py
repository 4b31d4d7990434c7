"""whisper-large-v3 [audio] — encoder-decoder, conv frontend stubbed.

32L (decoder) d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.
[arXiv:2212.04356].  ``input_specs`` provides precomputed mel/conv frame
embeddings; the 32-layer encoder + 32-layer decoder transformer is real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    pattern=("cross",),          # decoder blocks: self + cross to encoder
    n_periods=32,
    rope_theta=10000.0,
    encoder_layers=32,
    encoder_len_ratio=1,
    decoder_len_ratio=4,
    is_encoder_decoder=True,
    source="arXiv:2212.04356",
    subquadratic=False,
)
