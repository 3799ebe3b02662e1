"""Train step builder: microbatch accumulation, clipping, schedule, optimizer
(the reference's `training/train_loop.py`, single device).

`make_train_step(model, tcfg)` returns `train_step(state, batch) -> (state,
metrics)`.  The state is `init_state(model, tcfg)`: {"params": the model's
own parameters as `DecoderLM.param_tree`, "opt": `adamw_init`'s state,
"step": an int32 device scalar}; a step updates it in place and returns it.
The metrics ("loss", "grad_norm", "lr", "ce", "aux") stay on the device:
nothing in the step reads a value back to the host.

The reference's cross-pod int8 gradient reduction (`compress_crosspod`)
needs a mesh; with none (`ctx=None` there) it takes the plain path, and so
does every step here.  Its `optimization_barrier` on the clipped gradients
is an XLA fence with no counterpart (ROADMAP Queue 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.training import optimizer as opt_mod

__all__ = ["TrainConfig", "init_state", "make_train_step"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    grad_accum: int = 1
    clip_norm: float = 1.0
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eight_bit_optimizer: bool = False
    compress_crosspod: bool = False
    accum_dtype: str = "float32"   # "bfloat16" halves the accumulation
    #                                buffer (required at 1T params/16 GB)


def init_state(model, tcfg: TrainConfig):
    """The train state over `model`'s own parameters, which it switches to
    requires_grad=True."""
    model.requires_grad_(True)
    params = model.param_tree()
    return {
        "params": params,
        "opt": opt_mod.adamw_init(params, eight_bit=tcfg.eight_bit_optimizer),
        "step": torch.zeros((), dtype=torch.int32, device=model.device),
    }


def _split_microbatches(batch: Dict[str, Any], n: int):
    """Contiguous microbatches: each (b, ...) tensor becomes (n, b/n, ...)."""
    def sp(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        return x.reshape((n, b // n) + tuple(x.shape[1:]))
    return {k: sp(v) for k, v in batch.items()}


def make_train_step(model, tcfg: TrainConfig):
    schedule = opt_mod.cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)

    def value_and_grad(params, flat, mb):
        loss, metrics = model.loss(mb)
        grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
        return loss.detach(), metrics, opt_mod.tree_map(
            lambda p: grads[id(p)], params)

    def accumulate(params, batch):
        flat = opt_mod.tree_leaves(params)
        if tcfg.grad_accum == 1:
            return value_and_grad(params, flat, batch)
        mbs = _split_microbatches(batch, tcfg.grad_accum)
        acc_dt = _DTYPES[tcfg.accum_dtype]
        acc_loss = torch.zeros((), dtype=torch.float32, device=model.device)
        acc_grads = opt_mod.tree_map(
            lambda p: torch.zeros(p.shape, dtype=acc_dt, device=p.device),
            params)
        for i in range(tcfg.grad_accum):
            loss, metrics, grads = value_and_grad(
                params, flat, {k: v[i] for k, v in mbs.items()})
            opt_mod.tree_map(lambda a, g: a.add_(g.to(acc_dt)), acc_grads,
                             grads)
            acc_loss = acc_loss + loss
            del grads
        inv = 1.0 / tcfg.grad_accum
        grads = opt_mod.tree_map(lambda g: g.mul_(inv), acc_grads)
        return acc_loss * inv, metrics, grads

    def train_step(state, batch):
        params = state["params"]
        loss, metrics, grads = accumulate(params, batch)
        grads, gnorm = opt_mod.clip_by_global_norm(grads, tcfg.clip_norm)
        lr = schedule(state["step"])
        opt_mod.adamw_update(
            params, grads, state["opt"], lr, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay,
            eight_bit=tcfg.eight_bit_optimizer)
        state["step"] = state["step"] + 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr, **metrics}

    return train_step
