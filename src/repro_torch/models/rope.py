"""Rotary position embeddings with the paper-analogue recompute policy (the
reference's `models/rope.py`).

RoPE sin/cos tables are *fixed per position* — the LM-side "geometric
factors" (DESIGN.md §5).  Two policies:

  * ``on_the_fly``  — recompute sin/cos in float32 from the position ids
    inside the layer (paper Algorithm 3 analogue: the tables never exist in
    memory).
  * ``precomputed`` — a (max_seq, Dh/2, 2) table made once and gathered
    from device memory in every layer (paper Algorithm 2 analogue).

Both produce identical rotations; tests assert equivalence.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rope_table", "apply_rope"]


def _freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(theta, expo)   # a host scalar: no copy to the card


def rope_table(max_seq: int, head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """Precompute the (max_seq, half, 2) cos/sin table (policy=precomputed)."""
    pos = torch.arange(max_seq, dtype=torch.float32, device=device)
    ang = pos[:, None] * _freqs(head_dim, theta, device)[None, :]
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)


def _sincos(positions: torch.Tensor, head_dim: int, theta: float,
            table: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    if table is not None:
        sc = table[positions]                     # gather from the table
        return sc[..., 0], sc[..., 1]
    ang = positions[..., None].float() * _freqs(head_dim, theta,
                                                positions.device)
    return torch.cos(ang), torch.sin(ang)         # recomputed


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               theta: float, table: Optional[torch.Tensor] = None):
    """Rotate q, k: (..., S, H, Dh); positions: (..., S).  In float32,
    rounded back to each input's dtype."""
    dh = q.shape[-1]
    cos, sin = _sincos(positions, dh, theta, table)   # (..., S, Dh/2)
    cos = cos[..., None, :].float()
    sin = sin[..., None, :].float()

    def rot(x):
        x32 = x.float()
        x1, x2 = x32[..., : dh // 2], x32[..., dh // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.to(x.dtype)

    return rot(q), rot(k)
