"""GQA attention: chunked-causal (flash-style) for prefill, cached decode
(the reference's `models/attention.py`, in stock PyTorch ops).

The chunked path walks KV blocks with an online-softmax accumulator so peak
memory is O(S * chunk) instead of O(S^2); the decode path walks the cache
the same way (flash-decode) when it is long and a whole number of chunks.
The reference's scans are Python loops here.  Which path runs, and where
each result is rounded, follows the reference exactly: the paths round
differently.  GQA heads are kv-major: query head h reads KV head
h // (H / KV).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["causal_attention", "decode_attention", "full_attention"]

_NEG = -1e30


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, Dh) -> (B, S, KV*groups, Dh) for GQA, kv-major."""
    if groups == 1:
        return k
    b, s, kv, dh = k.shape
    return k[:, :, :, None].expand(b, s, kv, groups, dh).reshape(
        b, s, kv * groups, dh)


def full_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Reference O(S^2)-memory attention. q: (B,Sq,H,Dh); k/v: (B,Sk,KV,Dh)."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(dh)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = torch.where(ki <= qi, scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def causal_attention(q, k, v, chunk: int = 1024,
                     causal: bool = True) -> torch.Tensor:
    """Chunked self-attention (prefill path), causal or bidirectional.

    Walks KV in `chunk`-sized blocks with online softmax so peak memory is
    O(S*chunk); with causal=True the mask is applied per block (fully
    masked future blocks still run, as in the reference).
    """
    b, s, h, dh = q.shape
    if s <= chunk:
        return full_attention(q, k, v, causal=causal)
    valid = s
    if s % chunk:  # pad to a chunk multiple
        pad = chunk - s % chunk
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                   for a in (q, k, v))
        s = q.shape[1]
    kvh = k.shape[2]
    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)
    scale = 1.0 / math.sqrt(dh)
    qi = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b, h, s), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, s, h, dh), dtype=torch.float32, device=q.device)
    for blk in range(s // chunk):
        kc = k[:, blk * chunk:(blk + 1) * chunk]
        vc = v[:, blk * chunk:(blk + 1) * chunk]
        sc = torch.einsum("bqhd,bkhd->bhqk", q, kc).float() * scale
        ki = blk * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = (ki <= qi) if causal else (ki < valid)
        sc = torch.where(mask, sc, _NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, vc.float())
        m = m_new
    out = o / l.transpose(1, 2)[..., None]
    return out[:, :valid].to(q.dtype)


def decode_attention(q, k_cache, v_cache,
                     length: Optional[torch.Tensor] = None,
                     chunk: int = 4096) -> torch.Tensor:
    """Single-token decode vs a (B, S, KV, Dh) cache (memory-bound matvecs).

    Flash-decode style when S is a multiple of `chunk` above it: the cache
    is walked in `chunk` blocks with an online-softmax accumulator, so
    per-step temporaries are O(B*chunk), not O(B*S); otherwise one pass.
    `length` (B,) masks positions >= length (ragged serving).
    """
    b, sq, h, dh = q.shape
    s = k_cache.shape[1]
    kvh = k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dh)
    scale = 1.0 / math.sqrt(dh)

    def masked(sc, pos):
        if length is None:
            return sc
        mask = pos[None, :] < length[:, None]
        return torch.where(mask[:, None, None, None, :], sc, _NEG)

    if s <= chunk or s % chunk:
        sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float() * scale
        sc = masked(sc, torch.arange(s, device=q.device))
        p = torch.softmax(sc, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype), v_cache)
        return out.reshape(b, sq, h, dh)

    m = torch.full((b, kvh, g, sq), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, kvh, g, sq, dh), dtype=torch.float32, device=q.device)
    for blk in range(s // chunk):
        kc = k_cache[:, blk * chunk:(blk + 1) * chunk]
        vc = v_cache[:, blk * chunk:(blk + 1) * chunk]
        sc = torch.einsum("bqkgd,bskd->bkgqs", qg, kc).float() * scale
        sc = masked(sc, blk * chunk + torch.arange(chunk, device=q.device))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                               vc.float())
        m = m_new
    out = o / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)
