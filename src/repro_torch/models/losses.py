"""Loss utilities: the logit projection and sequence-chunked next-token
cross-entropy (the reference's `models/losses.py`).

Materialising (B, S, V) float32 logits is the largest training buffer of a
big-vocabulary model.  `chunked_ce` walks the sequence in chunks so only a
(B, chunk, V) block lives at a time, and masks the padded vocabulary: it is
padded to a multiple of 256 (`ModelConfig.padded_vocab`), and the padded
entries are masked to -1e30 so they are never sampled or scored.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["chunked_ce", "project_logits"]


def project_logits(x: torch.Tensor, embed_params, head_params,
                   real_vocab: int) -> torch.Tensor:
    """Hidden -> masked float32 logits (tied transpose or separate head);
    the product runs in x's dtype.  The mask is written in place, so the
    masked columns pass no gradient back."""
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


def _chunk_ce_sum(xc, tc, valid, embed_params, head_params, real_vocab):
    """Summed CE of one (B, chunk) block, rows at or past `valid` zeroed."""
    lg = project_logits(xc, embed_params, head_params, real_vocab)
    ce = -torch.gather(F.log_softmax(lg, dim=-1), -1, tc[..., None])[..., 0]
    ce = torch.where(valid[None, :], ce, 0.0)
    return ce.sum()


def chunked_ce(x: torch.Tensor, targets: torch.Tensor, embed_params,
               head_params, real_vocab: int, chunk: int = 512) -> torch.Tensor:
    """Mean next-token CE over (B, S, D) hiddens and (B, S-1) targets.

    x[:, :-1] scores targets (the standard shift).  The sequence is padded
    to a multiple of `chunk`, the pad rows masked, and the sum divided by
    B * (S-1), as the reference's scan does.  Each chunk runs under a
    non-reentrant `torch.utils.checkpoint`, so its logits are not kept for
    the backward but made again there, one chunk at a time: a single
    (B, chunk, V) float32 block is alive in the backward, which is what the
    reference's scan promises.  Recomputing changes no number.
    """
    xs = x[:, :-1]
    b, s, _ = xs.shape
    pad = (-s) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
    targets = targets.long()
    positions = torch.arange(xs.shape[1], device=x.device)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, xs.shape[1], chunk):
        total = total + checkpoint(
            _chunk_ce_sum, xs[:, c0:c0 + chunk], targets[:, c0:c0 + chunk],
            positions[c0:c0 + chunk] < s, embed_params, head_params,
            real_vocab, use_reentrant=False)
    return total / torch.full_like(total, b * s)   # one rounding on the card
