"""Model registry: family -> model class (the reference's
`models/registry.py`).

The port runs the dense, MoE and VLM families (`DecoderLM`) and the hybrid
family (`HybridLM`).  Every other family raises,
naming the slice of ROADMAP Queue 1, item 5 that brings it; `configs.get`
refuses no family, so this is where an unported one stops.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.transformer import DecoderLM

__all__ = ["build_model", "FAMILIES", "PENDING"]

FAMILIES = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM,
            "hybrid": HybridLM}

# family -> where ROADMAP Queue 1, item 5 ports it
PENDING = {
    "ssm": "slice 6 (xLSTM)",
    "audio": "slice 7 (enc-dec/audio)",
}


def build_model(cfg: ModelConfig, device=None):
    """The family's model with uninitialised parameters on `device` (the
    CUDA device unless the caller names another; raises without one)."""
    if cfg.family not in FAMILIES:
        where = PENDING.get(cfg.family, "no slice yet")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"Queue 1, item 5, {where})")
    return FAMILIES[cfg.family](cfg, device=device)
