"""Optimizers: AdamW (float32 state) and 8-bit AdamW (blockwise-quantized
state), the cosine schedule and global-norm clipping (the reference's
`training/optimizer.py`).

Plain functions over trees of tensors (dicts by name; the model's layers a
list of per-layer trees, see `DecoderLM.param_tree`).  The 8-bit variant
keeps the first and second moments as int8 with per-block float32 scales
in the parameter's own shape.  The update writes the parameters and the
moments in place: the parameters are the model's own, which the next loss
reads.

Everything the reference computes in float32 on the device is computed in
float32 on the device here too: the bias corrections `b ** count`, the
schedule, the clip factor.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["adamw_init", "adamw_update", "Schedule", "cosine_schedule",
           "clip_by_global_norm", "QState", "tree_fill", "tree_groups",
           "tree_leaves", "tree_map"]

_BLOCK = 256
_EPS0 = 1e-20


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d rounded once, on every device: the card's kernel divides by a
    Python number through its reciprocal, and `number / tensor` is a
    reciprocal and a product; the reference divides."""
    return a / torch.full_like(a, d)


def tree_groups(tree) -> list:
    """The tensors of a tree as the reference's leaves, in its order: dict
    keys sorted, a `QState`'s fields in turn, and a list of like trees (the
    model's layers) position by position.  Each leaf is a pair (tensors,
    stacked): one tensor a layer with stacked=True where the reference
    stacks them along 'layers', else one tensor."""
    if torch.is_tensor(tree):
        return [([tree], False)]
    if isinstance(tree, dict):
        return [g for k in sorted(tree) for g in tree_groups(tree[k])]
    if isinstance(tree, QState):
        return [g for sub in tree for g in tree_groups(sub)]
    per_layer = [tree_leaves(sub) for sub in tree]
    return [(list(ts), True) for ts in zip(*per_layer)]


def tree_leaves(tree) -> list:
    """The tensors of a tree in the order of `tree_groups`."""
    return [t for ts, _ in tree_groups(tree) for t in ts]


@torch.no_grad()
def tree_fill(tree, arrays) -> None:
    """Copy `arrays` (tensors, one a `tree_groups` leaf, stacked on a
    leading 'layers' axis where the leaf is) into the tree's tensors in
    place; each tensor keeps its device and dtype."""
    groups = tree_groups(tree)
    if len(arrays) != len(groups):
        raise ValueError(f"{len(arrays)} leaves for a tree of {len(groups)}: "
                         f"the tree structure differs")
    for i, ((tensors, stacked), arr) in enumerate(zip(groups, arrays)):
        for t, a in zip(tensors, arr if stacked else [arr]):
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"leaf {i}: shape {tuple(a.shape)}, the "
                                 f"tree's tensor {tuple(t.shape)}")
            t.copy_(a)


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (dicts and lists of tensors); the trees
    in `rest` are read at the same places (their subtrees there are passed
    whole where `tree` has a tensor, as the reference's `flatten_up_to`
    does)."""
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return [tree_map(fn, v, *(r[i] for r in rest))
            for i, v in enumerate(tree)]


class QState(NamedTuple):
    """Blockwise-quantized tensor in the parameter's own shape.

    Linear mode (signed, for m):  deq = q * scale          (lo unused)
    Log mode (non-negative, for v): deq = exp(lo + (q+127) * scale) - EPS0
    Log-space quantization avoids the zero-collapse that makes linear int8
    second moments diverge (Adam's 1/sqrt(v) amplifies flushed-to-zero v).
    """

    q: torch.Tensor
    scale: torch.Tensor
    lo: torch.Tensor


def _blocks(xf: torch.Tensor, shape):
    last = shape[-1] if shape else 1
    bs = min(_BLOCK, last) if last else 1
    pad = (-last) % bs if bs else 0
    if pad:
        xf = F.pad(xf, (0, pad))
    return xf.reshape(tuple(shape[:-1]) + (-1, bs)), bs, pad


def _unblocks(blocks: torch.Tensor, shape, pad: int):
    last = shape[-1] if shape else 1
    out = blocks.reshape(tuple(shape[:-1]) + (last + pad,))
    return out[..., :last] if pad else out


def _quantize(x: torch.Tensor, log: bool = False) -> QState:
    shape = tuple(x.shape)
    xf = x.float()
    if log:
        xf = torch.log(torch.clamp_min(xf, 0.0) + _EPS0)
    blocks, _, pad = _blocks(xf, shape)
    if log:
        lo = blocks.amin(dim=-1)
        span = blocks.amax(dim=-1) - lo
        scale = _div(torch.clamp_min(span, 1e-6), 254.0)
        q = torch.round((blocks - lo[..., None]) / scale[..., None]) - 127.0
    else:
        amax = blocks.abs().amax(dim=-1)
        scale = _div(amax, 127.0)
        lo = torch.zeros_like(scale)
        safe = torch.where(scale > 0, scale, 1.0)
        q = torch.round(blocks / safe[..., None])
    q = _unblocks(q, shape, pad).to(torch.int8)
    return QState(q, scale, lo)


def _dequantize(qs: QState, shape, log: bool = False) -> torch.Tensor:
    blocks, _, pad = _blocks(qs.q.float(), tuple(shape))
    if log:
        out = torch.exp(qs.lo[..., None]
                        + (blocks + 127.0) * qs.scale[..., None]) - _EPS0
        out = torch.clamp_min(out, 0.0)
    else:
        out = blocks * qs.scale[..., None]
    return _unblocks(out, tuple(shape), pad)


def adamw_init(params, *, eight_bit: bool = False):
    """{"mu": a {"m", "v"} a parameter, "count": int32 0}, on the
    parameters' devices."""
    def init_leaf(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if eight_bit:
            return {"m": _quantize(z), "v": _quantize(z, log=True)}
        return {"m": z, "v": z.clone()}

    device = tree_leaves(params)[0].device
    return {"mu": tree_map(init_leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(params, grads, opt_state, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, eight_bit: bool = False):
    """One AdamW step, in place: each parameter becomes
    (p32 - lr * step).to(p.dtype) (no float32 master copy, as in the
    reference), and its moments are written back (re-quantized in 8-bit
    mode).  `lr` is a float32 device scalar.  Returns (params, opt_state),
    the same objects.

    The reference updates a stacked leaf above 2**26 elements one layer
    slice at a time, so that the dequantize-update-requantize chain never
    holds a whole stack's moments in float32; the port's parameters are per
    layer already, so every update here is such a slice.
    """
    count = opt_state["count"] + 1
    cnt = count.float()
    c1 = 1.0 - torch.full_like(cnt, b1) ** cnt
    c2 = 1.0 - torch.full_like(cnt, b2) ** cnt

    def upd(p, g, s):
        g32 = g.float()
        m_prev = _dequantize(s["m"], p.shape) if eight_bit else s["m"]
        v_prev = (_dequantize(s["v"], p.shape, log=True) if eight_bit
                  else s["v"])
        m = b1 * m_prev + (1 - b1) * g32
        v = b2 * v_prev + (1 - b2) * g32 * g32
        step = (m / c1) / (torch.sqrt(torch.clamp_min(v / c2, 0.0)) + eps)
        step = step + weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        if eight_bit:
            s["m"], s["v"] = _quantize(m), _quantize(v, log=True)
        else:
            s["m"].copy_(m)
            s["v"].copy_(v)

    tree_map(upd, params, grads, opt_state["mu"])
    opt_state["count"] = count
    return params, opt_state


# glibc's cosf (sysdeps/ieee754/flt-32/s_cosf.c, __sincosf_table[0]):
# pi/2 and its inverse, and its float64 polynomials for cos and sin
_HPI_INV = float.fromhex("0x1.45f306dc9c883p-1")
_HPI = float.fromhex("0x1.921fb54442d18p0")
_COS = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
        float.fromhex("0x1.55553e1068f19p-5"),
        float.fromhex("-0x1.6c087e89a359dp-10"),
        float.fromhex("0x1.99343027bf8c3p-16"))
_SIN = (float.fromhex("-0x1.555545995a603p-3"),
        float.fromhex("0x1.1107605230bc4p-7"),
        float.fromhex("-0x1.994eb3774cf24p-13"))


def _cosf(y: torch.Tensor) -> torch.Tensor:
    """cos of float32 `y` (|y| < 120), rounded as glibc's cosf rounds it:
    y reduced by pi/2 and a polynomial evaluated in float64, one product
    or sum an op, so the card gives the CPU's bits.  The reference's
    float32 cos is that function on the CPU; `torch.cos` rounds about 5% of
    float32 arguments to another neighbour."""
    x = y.double()
    n = torch.round(x * _HPI_INV)
    small = y.abs() < math.pi / 4
    n = torch.where(small, 0.0, n)
    r = x - n * _HPI
    x2 = r * r
    x4 = x2 * x2
    c = (_COS[0] + x2 * _COS[1]) + x4 * _COS[2] + (x4 * x2) * (
        _COS[3] + x2 * _COS[4])
    k = n.long() & 3
    rs = torch.where((k == 1) | (k == 2), -r, r)
    x3 = rs * x2
    sn = (rs + x3 * _SIN[0]) + (x3 * x2) * (_SIN[1] + x2 * _SIN[2])
    out = torch.where(k % 2 == 1, sn, torch.where(k == 2, -c, c))
    return torch.where(y.abs() < 2.0 ** -12, 1.0, out).float()


class Schedule(NamedTuple):
    base_lr: float
    warmup: int
    total: int
    min_ratio: float = 0.1

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        """The rate at an integer device scalar `step`, in float32."""
        s = step.float()
        warm = torch.clamp_max(_div(s, max(self.warmup, 1)), 1.0)
        prog = torch.clamp(_div(s - self.warmup, max(
            self.total - self.warmup, 1)), 0.0, 1.0)
        cos = 0.5 * (1 + _cosf(math.pi * prog))
        return self.base_lr * warm * (self.min_ratio
                                      + (1 - self.min_ratio) * cos)


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Schedule:
    return Schedule(base_lr, warmup, total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)) in their own
    dtypes, the float32 global norm); the leaves' sums of squares are added
    in tree order."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    factor = torch.clamp_max(torch.full_like(gn, max_norm) / (gn + 1e-9),
                             1.0)
    return tree_map(lambda g: (g.float() * factor).to(g.dtype), grads), gn
