"""Primitive layers (functional over parameter trees): RMSNorm, linear,
embedding, logits — the reference's `models/layers.py`.

A parameter tree is a `params.ParamTree` (or a dict of the same names).
"""

from __future__ import annotations

import torch

from repro_torch.models.params import ParamSpec

__all__ = ["rms_norm", "rms_norm_spec", "linear", "linear_spec",
           "embedding_spec", "embed", "logits"]


def rms_norm_spec(dim: int):
    return {"scale": ParamSpec((dim,), (None,), init_scale=-1.0)}


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalised in float32, rounded back to x's dtype once."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def linear_spec(d_in: int, d_out: int, axes=("fsdp", "model"), bias=False,
                dtype=torch.float32, scale: float = 1.0):
    spec = {"w": ParamSpec((d_in, d_out), axes, dtype=dtype, init_scale=scale)}
    if bias:
        spec["b"] = ParamSpec((d_out,), (axes[-1],), dtype=dtype)
    return spec


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """x @ w with w stored (d_in, d_out), in x's dtype."""
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding_spec(vocab: int, dim: int, dtype=torch.float32):
    return {"table": ParamSpec((vocab, dim), ("vocab", "fsdp"), dtype=dtype)}


def embed(p, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["table"].to(dtype)[tokens]


def logits(p_embed, x: torch.Tensor, head=None) -> torch.Tensor:
    """Output head: tied embedding transpose or a separate projection."""
    if head is not None:
        return linear(head, x)
    return torch.matmul(x, p_embed["table"].to(x.dtype).t())
