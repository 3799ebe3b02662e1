"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=163840,
MoE 64 experts top-6, shared experts=2, first layer dense.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=11264,           # dense (first) layer FFN
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
    num_shared_experts=2,
    first_dense_layers=1,
)
