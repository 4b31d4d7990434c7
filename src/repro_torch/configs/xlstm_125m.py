"""xlstm-125m [ssm] — sLSTM + mLSTM blocks.  [arXiv:2405.04517]

12L d_model=768 4H (kv=4) d_ff=0 vocab=50304.  d_ff=0 per the assignment:
blocks use the xLSTM projection structure instead of a SwiGLU MLP.
Pattern: 2 mLSTM blocks then 1 sLSTM block (roughly the paper's 7:1-ish
mix at this scale), repeated 4x.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=("mlstm", "mlstm", "slstm"),
    n_periods=4,
    rope_theta=10000.0,
    mlstm_chunk=128,                # chunkwise-parallel mLSTM (EXPERIMENTS
                                    # §Perf hillclimb #1; 0 = naive recurrence)
    lora=None,                      # no attention projections to adapt; FIRM
                                    # runs full-parameter here (see DESIGN §4)
    source="arXiv:2405.04517",
    subquadratic=True,
)
