"""Mamba-2 (SSD) block: the chunk-parallel training form and the recurrent
decode step (the reference's `models/mamba2.py`).

The decay factors exp(A * dt) are recomputed from scalars at every position
(`models.ssd`).  The softplus of dt, the exp of a_log and the d_skip term
are float32, as in the reference; the conv state is kept in the model's
dtype and the ssm state in float32.

The depthwise causal conv is a cross-correlation over time (no flip), as
the reference's `lax.conv_general_dilated` is.  It is written as K shifted
products summed in float32 and rounded once: elementwise ops and sums,
whose backward on the card is deterministic (a restarted training run
repeats the uninterrupted one bit for bit).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import ssd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamSpec

__all__ = ["mamba_spec", "mamba_apply", "mamba_step", "mamba_cache_spec"]


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def mamba_spec(cfg: ModelConfig, dtype):
    d = cfg.d_model
    d_inner, n_heads, conv_dim = _dims(cfg)
    proj_out = 2 * d_inner + 2 * cfg.ssm_state + n_heads
    return {
        "in_proj": {"w": ParamSpec((d, proj_out), ("fsdp", "model"),
                                   dtype=dtype)},
        "conv_w": ParamSpec((conv_dim, cfg.ssm_conv), ("model", None),
                            dtype=dtype),
        "conv_b": ParamSpec((conv_dim,), ("model",), dtype=dtype),
        "a_log": ParamSpec((n_heads,), ("model",)),
        "d_skip": ParamSpec((n_heads,), ("model",), init_scale=-1.0),
        "dt_bias": ParamSpec((n_heads,), ("model",)),
        "norm": {"scale": ParamSpec((d_inner,), ("model",), init_scale=-1.0)},
        "out_proj": {"w": ParamSpec((d_inner, d), ("model", "fsdp"),
                                    dtype=dtype)},
    }


def _split(p, x, cfg: ModelConfig):
    d_inner, _, conv_dim = _dims(cfg)
    proj = torch.matmul(x, p["in_proj"]["w"].to(x.dtype))
    z, xbc, dt = torch.split(proj, [d_inner, conv_dim,
                                    proj.shape[-1] - d_inner - conv_dim],
                             dim=-1)
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: (B, S, C); w: (C, K):
    out_t = sum_k w[:, k] x_{t+k-K+1} (zeros before the start)."""
    s, k = xbc.shape[1], w.shape[1]
    xp = F.pad(xbc, (0, 0, k - 1, 0)).float()
    w32 = w.to(xbc.dtype).float()
    acc = xp[:, 0:s] * w32[:, 0]
    for j in range(1, k):
        acc = acc + xp[:, j:j + s] * w32[:, j]
    return acc.to(xbc.dtype) + b.to(xbc.dtype)


def _ssm_inputs(p, xbc_conv, dt_raw, cfg: ModelConfig):
    d_inner, n_heads, _ = _dims(cfg)
    n = cfg.ssm_state
    xs, b_in, c_in = torch.split(xbc_conv, [d_inner, n, n], dim=-1)
    bsz, s = xs.shape[0], xs.shape[1]
    v = xs.reshape(bsz, s, n_heads, cfg.ssm_head_dim)
    k = b_in[:, :, None, :].expand(bsz, s, n_heads, n)
    q = c_in[:, :, None, :].expand(bsz, s, n_heads, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    log_a = -torch.exp(p["a_log"].float()) * dt                   # (B,S,H)
    return q, k, v, log_a, dt


def mamba_apply(p, x: torch.Tensor, cfg: ModelConfig, h0=None, conv0=None,
                return_state: bool = False):
    """x: (B, S, D).  Optionally resume from (h0, conv0) and return
    (out, (the float32 ssm state, the last K-1 inputs of the conv))."""
    d_inner = _dims(cfg)[0]
    z, xbc, dt_raw = _split(p, x, cfg)
    if conv0 is not None:
        xbc_ext = torch.cat([conv0.to(xbc.dtype), xbc], dim=1)
        xbc_conv = _causal_conv(xbc_ext, p["conv_w"],
                                p["conv_b"])[:, conv0.shape[1]:]
    else:
        xbc_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xbc_conv = F.silu(xbc_conv)
    q, k, v, log_a, dt = _ssm_inputs(p, xbc_conv, dt_raw, cfg)
    chunk = min(cfg.ssm_chunk, x.shape[1])
    y, h_t = ssd.chunked_decay_attention(q, k, v, log_a, dt, chunk=chunk,
                                         h0=h0,
                                         score_dtype=cfg.ssm_score_dtype)
    y = y + p["d_skip"].float()[None, None, :, None] * v.float()
    y = y.reshape(x.shape[0], x.shape[1], d_inner).to(x.dtype)
    y = rms_norm(p["norm"], y * F.silu(z), eps=cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"]["w"].to(x.dtype))
    if return_state:
        return out, (h_t, xbc[:, -(cfg.ssm_conv - 1):])
    return out


def mamba_cache_spec(cfg: ModelConfig, batch: int, dtype):
    """{"ssm": (B, H, N, P) float32, "conv": (B, K-1, C) dtype} as meta
    tensors."""
    _, n_heads, conv_dim = _dims(cfg)
    return {
        "ssm": torch.empty((batch, n_heads, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device="meta"),
        "conv": torch.empty((batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=dtype, device="meta"),
    }


def mamba_step(p, x: torch.Tensor, cache, cfg: ModelConfig):
    """Single-token decode. x: (B, 1, D); cache: {"ssm", "conv"}.  Returns
    (out, the new {"ssm", "conv"}); `cache` is not written."""
    d_inner = _dims(cfg)[0]
    z, xbc, dt_raw = _split(p, x, cfg)
    conv_in = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)  # (B,K,C)
    w = p["conv_w"].to(x.dtype).float()                              # (C,K)
    xbc_conv = (conv_in.float() * w.t()).sum(dim=1).to(x.dtype) + \
        p["conv_b"].to(x.dtype)
    xbc_conv = F.silu(xbc_conv)[:, None, :]
    q, k, v, log_a, dt = _ssm_inputs(p, xbc_conv, dt_raw, cfg)
    y, h_new = ssd.decay_attention_step(
        q[:, 0], k[:, 0], v[:, 0], log_a[:, 0], dt[:, 0], cache["ssm"])
    y = y + p["d_skip"].float()[None, :, None] * v[:, 0].float()
    y = y.reshape(x.shape[0], 1, d_inner).to(x.dtype)
    y = rms_norm(p["norm"], y * F.silu(z), eps=cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"]["w"].to(x.dtype))
    return out, {"ssm": h_new, "conv": conv_in[:, 1:]}
