"""seamless-m4t-medium [arXiv:2308.11596; hf]: enc-dec, multimodal.

12L (encoder) + 12L (decoder) d_model=1024 16H (kv=16) d_ff=4096
vocab=256206.  Speech frontend STUB: (B, S, 1024) precomputed frame
embeddings (DESIGN.md §5).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    audio_dim=1024,
)
