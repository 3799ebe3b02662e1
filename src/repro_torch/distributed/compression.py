"""The halo codecs of the neighbour exchange (the reference's
`distributed.compression.quantize_int8`, `dequantize_int8`,
`halo_compress` and `halo_decompress`).

A codec turns one send buffer of interface partials into the parts that
travel: ("bf16") one bfloat16 cast; ("int8") symmetric int8 codes and an
fp32 scale for every dof.  The arithmetic is the reference's, in fp32
(`x32 / scale`, rounded half to even), so the codes and the decoded values
come out bitwise the reference's.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["quantize_int8", "dequantize_int8", "halo_compress",
           "halo_decompress"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8: (codes, scale), one scale a row for tensors of two
    or more axes (the last axis shares it), one for the whole of a 1-D
    tensor; an all-zero row takes scale 1."""
    x32 = x.to(torch.float32)
    if x.ndim >= 2:
        amax = x32.abs().amax(dim=-1, keepdim=True)
    else:
        amax = x32.abs().max() if x32.numel() else x32.new_zeros(())
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.round(x32 / scale).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def halo_compress(vals: torch.Tensor, method: str) -> Tuple[torch.Tensor, ...]:
    """Encode one send buffer (M[, c]) for the wire: the tuple of tensors
    that travel, each its own message.  Strictly per dof: a 1-D buffer
    quantizes with a scale per element, an (M, c) one with a scale per row,
    so a dof encodes the same whichever pair table, or the shard's own
    self-rounding pass, slices it.  Padding lanes are zeroed upstream
    (`gather_scatter.shared_contrib`), so they code to 0 with scale 1."""
    if method == "bf16":
        return (vals.to(torch.bfloat16),)
    if method == "int8":
        if vals.ndim == 1:
            q, s = quantize_int8(vals[:, None])
            return q[:, 0], s[:, 0]
        return quantize_int8(vals)
    raise ValueError(f"unknown halo compress method {method!r}")


def halo_decompress(parts: Tuple[torch.Tensor, ...], method: str,
                    dtype: torch.dtype) -> torch.Tensor:
    """Decode the wire parts of `halo_compress` back to `dtype` partials."""
    if method == "bf16":
        return parts[0].to(dtype)
    if method == "int8":
        return dequantize_int8(*parts).to(dtype)
    raise ValueError(f"unknown halo compress method {method!r}")
