"""kimi-k2-1t-a32b [arXiv:2501.kimi2; unverified, paper-table]: 1T MoE.

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 experts top-8, 1 shared expert, first layer dense
(DeepSeek-V3-style layout).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=18432,           # dense (first) layer FFN, DSv3-style
    vocab_size=163840,
    head_dim=112,
    num_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    num_shared_experts=1,
    first_dense_layers=1,
)
