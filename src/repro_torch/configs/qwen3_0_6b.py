"""qwen3-0.6b [hf:Qwen/Qwen3-8B family; hf]: qk_norm, GQA kv=8, tied embed.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; head_dim=128 (Qwen3
uses a fixed 128 head_dim).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
)
