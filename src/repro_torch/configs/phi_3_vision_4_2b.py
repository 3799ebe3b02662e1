"""phi-3-vision-4.2b: phi3-mini backbone + CLIP frontend stub.

[hf:microsoft/Phi-3-vision-128k-instruct; hf]  32L d_model=3072 32H
(GQA kv=32) d_ff=8192 vocab=32064.  The CLIP ViT frontend is a STUB:
input_specs deliver (B, 144, 1024) precomputed patch embeddings, projected
1024 -> 3072 and prepended to the token sequence (DESIGN.md §5).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    vision_patches=144,
    vision_dim=1024,
)
