"""Model / run configuration for the architecture pool (the reference's
`models/config.py`, as data).

One frozen dataclass covers every family (dense / MoE / SSM / hybrid /
enc-dec / VLM / audio); family-specific fields default to "off".  The
`rope_policy` knob is the paper-analogue recompute-vs-load switch (DESIGN.md
§5): `on_the_fly` recomputes the position tables in-graph (paper Alg. 3
analogue), `precomputed` streams them from HBM (paper Alg. 2 analogue).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = ["ModelConfig", "ShapeCase", "SHAPE_CASES", "reduced_config"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // num_heads

    # transformer options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_policy: str = "on_the_fly"      # "on_the_fly" | "precomputed"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2

    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0           # hybrid: shared attention block period
    ssm_chunk: int = 256
    ssm_score_dtype: str = "float32"   # "bfloat16": §Perf traffic lever

    # xLSTM
    xlstm_slstm_every: int = 2    # every k-th block is sLSTM (rest mLSTM)

    # enc-dec
    encoder_layers: int = 0

    # modality frontends (stubs; see DESIGN.md §5)
    vision_patches: int = 0
    vision_dim: int = 0
    audio_dim: int = 0

    # numerics / execution
    dtype: str = "bfloat16"
    remat: str = "full"           # "none" | "full" | "dots"
    scan_group: int = 0           # >1: two-level (sqrt-style) remat scan
    attn_chunk: int = 1024

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so embeddings/head shard
        across TP (odd vocabs like seamless's 256206 otherwise force a
        replicated (B, S, V) logits buffer — 62 GB/device at 4k)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCase:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPE_CASES = {
    "train_4k": ShapeCase("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524_288, 1, "decode"),
}


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (shapes only shrink)."""
    kw = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.family == "hybrid" else 2),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 2,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16 if cfg.head_dim else 0,
        attn_chunk=16,
        ssm_chunk=8,
        remat="none",
    )
    if cfg.is_moe:
        kw.update(num_experts=4, experts_per_token=2, moe_d_ff=32,
                  first_dense_layers=min(cfg.first_dense_layers, 1),
                  num_shared_experts=cfg.num_shared_experts,
                  capacity_factor=4.0)  # determinism for consistency tests
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=8,
                  attn_every=2 if cfg.attn_every else 0)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2)
    if cfg.vision_patches:
        kw.update(vision_patches=8, vision_dim=32)
    if cfg.audio_dim:
        kw.update(audio_dim=32)
    return cfg.replace(**kw)
