"""Logit projection (the reference's `models/losses.py`, serving part).

The vocabulary is padded to a multiple of 256 (`ModelConfig.padded_vocab`);
the padded entries are masked to -1e30 so they are never sampled.
`chunked_ce` comes with the training slice.
"""

from __future__ import annotations

import torch

__all__ = ["project_logits"]


def project_logits(x: torch.Tensor, embed_params, head_params,
                   real_vocab: int) -> torch.Tensor:
    """Hidden -> masked float32 logits (tied transpose or separate head);
    the product runs in x's dtype."""
    if head_params is not None:
        lg = torch.matmul(x, head_params["w"].to(x.dtype))
        if "b" in head_params:
            lg = lg + head_params["b"].to(x.dtype)
    else:
        lg = torch.matmul(x, embed_params["table"].to(x.dtype).t())
    lg = lg.float()
    if lg.shape[-1] > real_vocab:     # mask vocab padding
        lg[..., real_vocab:] = -1e30
    return lg
