"""Model registry: family -> model class (the reference's
`models/registry.py`).

The port runs every family the reference's registry has: the dense, MoE
and VLM families (`DecoderLM`), the hybrid family (`HybridLM`), the xLSTM
family ("ssm", `XLSTMLM`) and the enc-dec/audio family (`EncDecLM`).  A
family the registry lacks raises; `configs.get` refuses no family, so this
is where an unknown one stops.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.xlstm_model import XLSTMLM

__all__ = ["build_model", "FAMILIES", "PENDING"]

FAMILIES = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM,
            "hybrid": HybridLM, "ssm": XLSTMLM, "audio": EncDecLM}

# family -> the slice of ROADMAP Queue 1, item 5 that ports it: none left
PENDING: dict = {}


def build_model(cfg: ModelConfig, device=None):
    """The family's model with uninitialised parameters on `device` (the
    CUDA device unless the caller names another; raises without one)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not in the registry "
            f"({sorted(FAMILIES)})")
    return FAMILIES[cfg.family](cfg, device=device)
