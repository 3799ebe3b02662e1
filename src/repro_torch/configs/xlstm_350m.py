"""xlstm-350m [arXiv:2405.04517; unverified]: sLSTM + mLSTM blocks.

24L d_model=1024 4H (kv=4) d_ff=0 (gated projection inside blocks)
vocab=50304; blocks alternate mLSTM/sLSTM.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
)
