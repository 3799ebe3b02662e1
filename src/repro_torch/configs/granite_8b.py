"""granite-8b [arXiv:2405.04324; hf]: llama-arch, code model.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
)
