"""Mixture-of-experts layer (the reference's `models/moe.py`, single
device).

Dispatch is sort-based with a static per-expert capacity, as in the
reference: each token picks its top-k experts, the assignments are sorted
by expert (stably, so a slot within an expert follows token order), an
assignment whose slot is at or past the capacity is dropped, the kept ones
fill an (E, C, D) buffer, the experts run as three batched products, and
each token sums its k gate-weighted expert outputs.  The capacity depends
on the tokens of the call (`capacity_for`), so a decode step at T = slots
does not route as a prefill over the same sequence; the serving engine
runs its empty slots through the dispatch too.  Both are the reference's.

The reference's scatter and gather leave out-of-range slots to XLA (its
scatter drops them, its gather clamps them).  Here every index is in range
by construction: a dropped assignment points at a spare zero row, and an
empty slot at another.  The dispatch and the combine are gathers whose
transposes are gathers too (`_RowGather`), and a token's k values are
added one after another in ascending expert order — the order in which
the reference's sorted scatter adds them — so no sum depends on the order
of atomic adds: forward and backward repeat bitwise on the card.

The reference's all-to-all and psum dispatch over a mesh (`ctx` given)
comes with the mesh (ROADMAP Queue 1, item 5, slice 8).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec

__all__ = ["moe_spec", "moe_apply", "capacity_for"]


def moe_spec(cfg: ModelConfig, dtype):
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    spec = {
        "router": {"w": ParamSpec((d, e), ("fsdp", None))},  # router in fp32
        "experts": {
            "w_gate": ParamSpec((e, d, f), ("experts", "fsdp", None),
                                dtype=dtype),
            "w_up": ParamSpec((e, d, f), ("experts", "fsdp", None),
                              dtype=dtype),
            "w_down": ParamSpec((e, f, d), ("experts", None, "fsdp"),
                                dtype=dtype),
        },
    }
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        spec["shared"] = {
            "w_gate": ParamSpec((d, fs), ("fsdp", "model"), dtype=dtype),
            "w_up": ParamSpec((d, fs), ("fsdp", "model"), dtype=dtype),
            "w_down": ParamSpec((fs, d), ("model", "fsdp"), dtype=dtype),
        }
    return spec


def capacity_for(tokens: int, cfg: ModelConfig) -> int:
    cap = int(tokens * cfg.experts_per_token / cfg.num_experts
              * cfg.capacity_factor)
    return max(4, -(-cap // 4) * 4)   # round up to a multiple of 4


class _Dispatch(NamedTuple):
    """A call's routes, each token's k assignments in ascending expert
    order; slot s = expert * capacity + position."""

    expert: torch.Tensor       # (T, k) expert id per assignment
    gate: torch.Tensor         # (T, k) float32 combine weight
    keep: torch.Tensor         # (T, k) capacity mask
    token_slot: torch.Tensor   # (T, k) slot per assignment; E*C if dropped
    slot_assign: torch.Tensor  # (E*C,) assignment t*k + j per slot; T*k
    #                            if empty


def _pad_row(src: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N + 1, D): a zero row at index N."""
    return torch.cat([src, src.new_zeros((1, src.shape[1]))])


def _sum_in_order(vals: torch.Tensor) -> torch.Tensor:
    """(N, k, D) -> (N, D), added j = 0, 1, ... in turn, each sum rounded
    to the dtype (the reference's scatter-add in its sorted order)."""
    out = vals[:, 0]
    for j in range(1, vals.shape[1]):
        out = out + vals[:, j]
    return out


class _RowGather(torch.autograd.Function):
    """Rows of `src` (N, D) at `index` (any shape; N selects a zero row),
    with `inverse` (N rows of indices into the output's flattened rows,
    their count selecting a zero row) the map back: each source row's
    gradient is gathered through it and, where it names several output
    rows, added in their order along the last index dimension.  Every
    output row names one source row, so the backward's gather is the whole
    transpose."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return _pad_row(src)[index]

    @staticmethod
    def backward(ctx, grad):
        inverse, = ctx.saved_tensors
        g = _pad_row(grad.reshape(-1, grad.shape[-1]))[inverse]
        return (_sum_in_order(g) if inverse.ndim == 2 else g), None, None


def _route(xf: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig,
           capacity: int):
    """Top-k routing and sort-based slot assignment; returns (dispatch,
    float32 probs (T, E), expert ids (T, k))."""
    t, k, e = xf.shape[0], cfg.experts_per_token, cfg.num_experts
    logits = xf.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    # jax.lax.top_k breaks ties to the lower index; torch.topk leaves the
    # order of equal values unspecified (its CPU and CUDA kernels differ),
    # so a stable descending sort picks the k
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = vals[:, :k] / vals[:, :k].sum(dim=-1, keepdim=True)
    expert, perm = torch.sort(ids[:, :k], dim=-1)
    gate = gate_vals.gather(1, perm)
    # a token's experts are distinct, so the stable sort by expert orders
    # each expert's assignments by token, whatever the order within tokens
    flat_e = expert.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    arange = torch.arange(t * k, device=xf.device)
    pos = torch.empty_like(first)
    pos[order] = arange - first
    pos = pos.view(t, k)
    keep = pos < capacity
    n_slots = e * capacity
    token_slot = torch.where(keep, expert * capacity + pos, n_slots)
    # the dropped assignments all land on the spare entry n_slots
    slot_assign = torch.full((n_slots + 1,), t * k, dtype=torch.long,
                             device=xf.device)
    slot_assign[token_slot.reshape(-1)] = arange
    disp = _Dispatch(expert=expert, gate=gate, keep=keep,
                     token_slot=token_slot, slot_assign=slot_assign[:-1])
    return disp, probs, expert


def _fill_buffer(xf: torch.Tensor, disp: _Dispatch, num_experts: int,
                 capacity: int) -> torch.Tensor:
    """Tokens into the (E, C, D) dispatch buffer; empty slots are 0."""
    k = disp.token_slot.shape[1]
    buf = _RowGather.apply(xf, disp.slot_assign // k, disp.token_slot)
    return buf.view(num_experts, capacity, xf.shape[-1])


def _combine(out_buf: torch.Tensor, disp: _Dispatch, t: int) -> torch.Tensor:
    """Each token's k expert outputs, gate-weighted, summed in ascending
    expert order; a dropped assignment adds 0."""
    d = out_buf.shape[-1]
    vals = _RowGather.apply(out_buf.reshape(-1, d), disp.token_slot,
                            disp.slot_assign)            # (T, k, D)
    w = (disp.gate * disp.keep).to(vals.dtype)[..., None]
    return _sum_in_order(vals * w)


def _expert_ffn(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU per expert: buf (E, C, D)."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def _aux_loss(probs: torch.Tensor, expert_ids: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Switch load-balance loss.  The counts are integers in float32, so
    their adds are exact in any order (`bincount` would read its maximum
    back to the host on the card)."""
    e = cfg.num_experts
    flat = expert_ids.reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32, device=probs.device)
    counts.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                          device=probs.device))
    p_sum = probs.sum(dim=0)
    n = probs.shape[0] * cfg.experts_per_token
    frac_tokens = counts / torch.full_like(counts, n)
    frac_probs = p_sum / torch.full_like(p_sum, probs.shape[0])
    return e * torch.sum(frac_tokens * frac_probs)


def _moe_core(xf, router_w, w_gate, w_up, w_down, cfg: ModelConfig,
              capacity: int):
    t = xf.shape[0]
    disp, probs, expert_ids = _route(xf, router_w, cfg, capacity)
    buf = _fill_buffer(xf, disp, cfg.num_experts, capacity)     # (E, C, D)
    out_buf = _expert_ffn(buf, w_gate, w_up, w_down)
    y = _combine(out_buf, disp, t)
    return y, _aux_loss(probs, expert_ids, cfg)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, ctx=None):
    """x: (B, S, D) -> (y, float32 aux loss), on x's device."""
    if ctx is not None:
        raise NotImplementedError(
            "expert parallelism (the all-to-all and psum dispatch) needs the "
            "mesh, which is not ported yet (ROADMAP Queue 1, item 5, slice "
            "8)")
    b, s, d = x.shape
    dt = x.dtype
    ex = p["experts"]
    xf = x.reshape(-1, d)
    y, aux = _moe_core(xf, p["router"]["w"], ex["w_gate"].to(dt),
                       ex["w_up"].to(dt), ex["w_down"].to(dt), cfg,
                       capacity_for(xf.shape[0], cfg))
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + _shared_expert(p["shared"], x, dt)
    return y, aux


def _shared_expert(ps, x, dt):
    h = F.silu(torch.matmul(x, ps["w_gate"].to(dt)))
    h = h * torch.matmul(x, ps["w_up"].to(dt))
    return torch.matmul(h, ps["w_down"].to(dt))
