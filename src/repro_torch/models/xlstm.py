"""xLSTM blocks: the mLSTM (matrix memory, chunk-parallel) and the sLSTM
(scalar memory, step recurrence) -- the reference's `models/xlstm.py`.

The mLSTM reuses the shared decay-attention engine (`models.ssd`) with a
value channel augmented by ones, which carries the normaliser n_t
(v' = [v, 1]):

    C_t = f_t C_{t-1} + i_t k_t v_t'^T,   h_t = o_t * (q C)_v / max(|q C|_n, 1)

so its state is (B, H, dh, dh + 1) float32.  The input gate is a clamped
exponential, exp(min(i, 8)), and the forget gate's log is log_sigmoid(f),
both float32; the scores run in float32 (the reference passes no
`ssm_score_dtype` here).  The sLSTM uses the exponential-gating stabiliser
m_t and a per-head block-diagonal recurrent matrix; its state is (c, n, h,
m), each (B, D) float32, m starting at -1e9.  Its input product
x @ w_in runs in float32 for every position at once, and the reference's
`lax.scan` over time is a Python loop over the time steps here.  `r`, the
bias and the mLSTM's gate weights are float32 parameters.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import ssd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamSpec

__all__ = ["mlstm_spec", "mlstm_apply", "mlstm_step", "mlstm_cache_spec",
           "slstm_spec", "slstm_apply", "slstm_step", "slstm_cache_spec"]

_IGATE_CLAMP = 8.0
# the sLSTM stabiliser's start
_M0 = -1e9


# ---------------------------------------------------------------- mLSTM ----

def mlstm_spec(cfg: ModelConfig, dtype):
    d, h = cfg.d_model, cfg.num_heads
    return {
        "qkv": {"w": ParamSpec((d, 3 * d), ("fsdp", "model"), dtype=dtype)},
        "gates": {"w": ParamSpec((d, 2 * h), ("fsdp", None))},   # i, f (fp32)
        "ogate": {"w": ParamSpec((d, d), ("fsdp", "model"), dtype=dtype)},
        "norm": {"scale": ParamSpec((d,), ("model",), init_scale=-1.0)},
        "out": {"w": ParamSpec((d, d), ("model", "fsdp"), dtype=dtype)},
    }


def _mlstm_inputs(p, x, cfg: ModelConfig):
    b, s, d = x.shape
    h = cfg.num_heads
    dh = d // h
    qkv = torch.matmul(x, p["qkv"]["w"].to(x.dtype))
    q, k, v = torch.split(qkv, d, dim=-1)
    # divided by sqrt(dh) in x's dtype, rounded once on every device
    q = q.reshape(b, s, h, dh)
    q = q / torch.full_like(q, math.sqrt(dh))
    k = k.reshape(b, s, h, dh)
    v = v.reshape(b, s, h, dh)
    gates = torch.matmul(x.float(), p["gates"]["w"].float())
    i_raw, f_raw = torch.split(gates, h, dim=-1)                  # (B,S,H)
    log_a = F.logsigmoid(f_raw)
    beta = torch.exp(torch.clamp_max(i_raw, _IGATE_CLAMP))
    v_aug = torch.cat([v.float(), torch.ones(v.shape[:-1] + (1,),
                                             dtype=torch.float32,
                                             device=x.device)], dim=-1)
    return q, k, v_aug, log_a, beta


def _mlstm_out(p, x, y_aug, cfg: ModelConfig):
    b, s, d = x.shape
    dh = d // cfg.num_heads
    y_num, y_den = y_aug[..., :dh], y_aug[..., dh]
    y = y_num / torch.clamp_min(y_den.abs(), 1.0)[..., None]
    y = y.reshape(b, s, d).to(x.dtype)
    o = torch.sigmoid(torch.matmul(x, p["ogate"]["w"].to(x.dtype)))
    y = rms_norm(p["norm"], y * o, eps=cfg.norm_eps)
    return torch.matmul(y, p["out"]["w"].to(x.dtype))


def mlstm_apply(p, x: torch.Tensor, cfg: ModelConfig, h0=None,
                return_state: bool = False):
    """x: (B, S, D).  Optionally resume from the (B, H, dh, dh + 1)
    float32 state h0 and return (out, the final state)."""
    q, k, v_aug, log_a, beta = _mlstm_inputs(p, x, cfg)
    chunk = min(cfg.attn_chunk, x.shape[1], 256)
    y_aug, h_t = ssd.chunked_decay_attention(
        q.float(), k.float(), v_aug, log_a, beta, chunk=chunk, h0=h0)
    out = _mlstm_out(p, x, y_aug, cfg)
    if return_state:
        return out, h_t
    return out


def mlstm_cache_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """The (B, H, dh, dh + 1) float32 state as a meta tensor."""
    dh = cfg.d_model // cfg.num_heads
    return torch.empty((batch, cfg.num_heads, dh, dh + 1),
                       dtype=torch.float32, device="meta")


def mlstm_step(p, x: torch.Tensor, h_prev, cfg: ModelConfig):
    """Single-token decode. x: (B, 1, D); h_prev: (B, H, dh, dh + 1).
    Returns (out, the new state); `h_prev` is not written."""
    q, k, v_aug, log_a, beta = _mlstm_inputs(p, x, cfg)
    y, h_new = ssd.decay_attention_step(
        q[:, 0].float(), k[:, 0].float(), v_aug[:, 0], log_a[:, 0],
        beta[:, 0], h_prev)
    return _mlstm_out(p, x, y[:, None], cfg), h_new


# ---------------------------------------------------------------- sLSTM ----

def slstm_spec(cfg: ModelConfig, dtype):
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    return {
        "w_in": {"w": ParamSpec((d, 4 * d), ("fsdp", "model"), dtype=dtype)},
        "r": ParamSpec((h, dh, 4 * dh), ("model", None, None)),  # fp32
        "bias": ParamSpec((4 * d,), ("model",)),
        "norm": {"scale": ParamSpec((d,), ("model",), init_scale=-1.0)},
        "out": {"w": ParamSpec((d, d), ("model", "fsdp"), dtype=dtype)},
    }


def _slstm_cell(p, wx_t, state, cfg: ModelConfig):
    """One sLSTM step. wx_t: (B, 4D) precomputed input part, float32;
    state (c, n, h, m)."""
    c, n, hprev, m = state
    b = wx_t.shape[0]
    h, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    rh = torch.einsum("bhd,hde->bhe", hprev.reshape(b, h, dh),
                      p["r"].float()).reshape(b, 4 * cfg.d_model)
    pre = wx_t + rh + p["bias"].float()
    z_r, i_r, f_r, o_r = torch.split(pre, cfg.d_model, dim=-1)
    z = torch.tanh(z_r)
    o = torch.sigmoid(o_r)
    fm = f_r + m
    m_new = torch.maximum(fm, i_r)                      # stabiliser
    i_g = torch.exp(i_r - m_new)
    f_g = torch.exp(fm - m_new)
    c_new = f_g * c + i_g * z
    n_new = f_g * n + i_g
    h_new = o * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, h_new, m_new)


def _slstm_out(p, x, hs, cfg: ModelConfig):
    y = rms_norm(p["norm"], hs.to(x.dtype), eps=cfg.norm_eps)
    return torch.matmul(y, p["out"]["w"].to(x.dtype))


def _slstm_state0(batch: int, d: int, device
                        ) -> Tuple[torch.Tensor, ...]:
    """(c, n, h, m) before the first step: zeros and m = -1e9."""
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return (z, z, z, torch.full((batch, d), _M0, dtype=torch.float32,
                                device=device))


def slstm_apply(p, x: torch.Tensor, cfg: ModelConfig, state0=None,
                return_state: bool = False):
    """x: (B, S, D).  Optionally resume from the state (c, n, h, m) and
    return (out, the final state)."""
    b, _, d = x.shape
    wx = torch.matmul(x.float(), p["w_in"]["w"].float())
    state = _slstm_state0(b, d, x.device) if state0 is None \
        else tuple(state0)
    hs = []
    # unbind: one stack in the backward, not a scatter into wx a step
    for wx_t in wx.unbind(1):
        state = _slstm_cell(p, wx_t, state, cfg)
        hs.append(state[2])
    out = _slstm_out(p, x, torch.stack(hs, dim=1), cfg)
    if return_state:
        return out, state
    return out


def slstm_cache_spec(cfg: ModelConfig, batch: int):
    """(c, n, h, m): four (B, D) float32 meta tensors."""
    return tuple(torch.empty((batch, cfg.d_model), dtype=torch.float32,
                             device="meta") for _ in range(4))


def slstm_step(p, x: torch.Tensor, state, cfg: ModelConfig):
    """Single-token decode. x: (B, 1, D); state (c, n, h, m).  Returns
    (out, the new state); `state` is not written."""
    wx = torch.matmul(x.float(), p["w_in"]["w"].float())[:, 0]
    new = _slstm_cell(p, wx, tuple(state), cfg)
    return _slstm_out(p, x, new[2][:, None], cfg), new
