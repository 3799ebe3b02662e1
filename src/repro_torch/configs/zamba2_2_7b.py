"""zamba2-2.7b [arXiv:2411.15242; hf]: Mamba2 backbone + shared attn block.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64; the
single shared attention+MLP block runs every 6 Mamba blocks (9 sites).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
)
