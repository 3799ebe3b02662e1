"""Chunked linear attention with per-step decay, the shared SSM engine (the
reference's `models/ssd.py`).

One algebraic core serves Mamba-2 (SSD: a_t = exp(A * dt_t)) and, with the
xLSTM slice, the mLSTM (a_t = sigmoid(f_t)):

    H_t = a_t H_{t-1} + beta_t k_t v_t^T        (state: (N, P) per head)
    y_t = q_t^T H_t

computed chunk-parallel: an intra-chunk masked (L x L) block plus an
inter-chunk state carried from chunk to chunk.  The reference's `lax.scan`
over chunks is a Python loop over the chunk axis here (16 chunks at seq
4096, chunk 256).  The numerics are the reference's: the exp of
cumulative log-decays, -inf put into the masked decay matrix before its exp
(so the backward meets no inf * 0), float32 state passing.

Shapes: q, k: (B, S, H, N); v: (B, S, H, P); log_a, beta: (B, S, H).
Returns y: (B, S, H, P) in q's dtype and the final float32 state
(B, H, N, P).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["chunked_decay_attention", "decay_attention_step"]

_SCORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def chunked_decay_attention(q, k, v, log_a, beta, chunk: int = 256,
                            h0: Optional[torch.Tensor] = None,
                            score_dtype: str = "float32",
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """score_dtype="bfloat16" (`ModelConfig.ssm_score_dtype`) rounds the
    (B, C, H, L, L) intra-chunk blocks to bf16, each product accumulated
    in float32 and rounded once, as the reference's
    `preferred_element_type=float32` does; state passing stays float32."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    if s % chunk:  # pad the tail with identity steps (log_a = 0, beta = 0)
        pad = chunk - s % chunk
        y, h_t = chunked_decay_attention(
            *(F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v)),
            *(F.pad(a, (0, 0, 0, pad)) for a in (log_a, beta)), chunk, h0,
            score_dtype)
        return y[:, :s], h_t
    sd = _SCORE_DTYPES[score_dtype]
    c = s // chunk
    f32 = torch.float32

    def to_chunks(x):
        return x.reshape(b, c, chunk, *x.shape[2:]).to(f32)

    def in_sd(x):
        """x rounded to the score dtype, held in float32 for a product."""
        return x.to(sd).to(f32)

    qc, kc, vc = to_chunks(q), to_chunks(k), to_chunks(v)
    la, bc = to_chunks(log_a), to_chunks(beta)

    cum = torch.cumsum(la, dim=2)                 # inclusive cumulative logs
    total = cum[:, :, -1]                         # (B, C, H)
    # decay from step j (exclusive) to step i (inclusive): cum_i - cum_j
    decay_mat = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,C,L,L,H)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()
    decay_mat = torch.where(mask[None, None, :, :, None], decay_mat,
                            float("-inf"))
    # intra-chunk: scores (B, C, H, L, L)
    scores = torch.einsum("bclhn,bcmhn->bchlm", in_sd(qc), in_sd(kc)).to(sd)
    gated = scores * torch.exp(decay_mat).permute(0, 1, 4, 2, 3).to(sd)
    gated = gated * bc.permute(0, 1, 3, 2)[:, :, :, None, :].to(sd)
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", gated.to(f32), in_sd(vc))

    # per-chunk state contribution: sum_j exp(total - cum_j) beta_j k_j v_j^T
    carry_w = torch.exp(total[:, :, None] - cum) * bc            # (B,C,L,H)
    chunk_state = torch.einsum("bclh,bclhn,bclhp->bchnp", carry_w, kc, vc)
    # query-side decay of the inter-chunk term: exp(cum_i)
    q_decay = torch.exp(cum)                                     # (B,C,L,H)
    decay_total = torch.exp(total)                               # (B,C,H)

    h_state = (torch.zeros((b, h, n, p), dtype=f32, device=q.device)
               if h0 is None else h0.to(f32))
    y_inter = []
    for ci in range(c):
        # y_inter_i = q_i . H_in * exp(cum_i)
        y_inter.append(torch.einsum(
            "blhn,bhnp->blhp", qc[:, ci] * q_decay[:, ci, ..., None],
            h_state))
        h_state = (h_state * decay_total[:, ci, :, None, None]
                   + chunk_state[:, ci])
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(b, s, h, p).to(q.dtype), h_state


def decay_attention_step(q, k, v, log_a, beta, h_prev
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence (decode). q/k: (B, H, N); v: (B, H, P);
    log_a/beta: (B, H); h_prev: (B, H, N, P).  Returns (y (B, H, P) in q's
    dtype, the float32 state)."""
    f32 = torch.float32
    a = torch.exp(log_a.to(f32))[..., None, None]
    h_new = h_prev.to(f32) * a + (beta.to(f32)[..., None, None]
                                  * k.to(f32)[..., :, None]
                                  * v.to(f32)[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", q.to(f32), h_new)
    return y.to(q.dtype), h_new
