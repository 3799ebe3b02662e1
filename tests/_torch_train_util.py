"""Helpers of the port's training tests: trees as numpy leaves in the
reference's order, and the two-part rule for parameters after an update
(see `tests/test_torch_training.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.training import optimizer as opt

TIGHT = 1e-3
# the share of parameter entries allowed beyond TIGHT: float32 AdamW,
# 8-bit AdamW
FLIP_SHARE = {False: 1e-3, True: 5e-2}


def np_of(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().numpy()


def stacked_leaves(tree):
    """A port tree's leaves as numpy arrays in the reference's order, the
    layers' tensors stacked."""
    return [np.stack([np_of(t) for t in ts]) if stacked else np_of(ts[0])
            for ts, stacked in opt.tree_groups(tree)]


def ref_leaves(tree):
    return [np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                       else a) for a in jax.tree.leaves(tree)]


def to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def two_part(port, ref, lr_sum, eight_bit, what=""):
    """Parameters after updates whose rates sum to `lr_sum`: at most
    FLIP_SHARE[eight_bit] of the entries beyond TIGHT * lr_sum from the
    reference's (an entry whose gradient is near zero can flip sign
    between two correct implementations and move by 2 lr a step; in 8-bit
    a moment one quantization step apart moves it too), none beyond
    2 * lr_sum."""
    d = np.concatenate([np.abs(p.astype(np.float64) - r).ravel()
                        for p, r in zip(port, ref)])
    beyond = float((d > TIGHT * lr_sum).mean())
    assert beyond <= FLIP_SHARE[eight_bit], (what, beyond)
    assert d.max() <= 2 * lr_sum, (what, d.max(), lr_sum)
