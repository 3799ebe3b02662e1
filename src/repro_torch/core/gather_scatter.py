"""Gather-scatter: the actions of Q and Q^T (paper Algorithm 1, gslib role).

Q is the sparse binary global-to-local matrix (Eq. 2); it is never built.
  scatter (Q):   global field (Ng[, d])            -> local (E, N1,N1,N1[, d])
  gather  (Q^T): local  (E, N1,N1,N1[, d])         -> global (Ng[, d]) sum

The reference package leaves these to XLA; the port uses stock
`index_select` and `index_add_`.  On CUDA `index_add_` sums with atomics, so
the order in which the (up to 8) element contributions to a shared dof are
added changes from run to run: the sum is exact to fp32 rounding but not
bitwise reproducible.  The sharded exchange is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["scatter", "gather", "dssum", "multiplicity"]


def scatter(x_global: torch.Tensor, global_ids: torch.Tensor) -> torch.Tensor:
    """Q x: copy global dof values to element-local nodes."""
    return x_global[global_ids]


def gather(y_local: torch.Tensor, global_ids: torch.Tensor,
           n_global: int) -> torch.Tensor:
    """Q^T y: sum element-local values into global dofs.

    `y_local` must be shaped like `global_ids` (scalar field) or like
    `global_ids` plus one trailing component axis (a d-vector field or an
    RHS batch).  Sub-fp32 values are summed in fp32 and rounded once.
    """
    if tuple(y_local.shape[:global_ids.ndim]) != tuple(global_ids.shape):
        raise ValueError(
            f"gather: y_local leading shape {tuple(y_local.shape)} does not "
            f"match global_ids shape {tuple(global_ids.shape)} — expected "
            f"{tuple(global_ids.shape)} (scalar field) or "
            f"{tuple(global_ids.shape)} + (d,) (vector field with one "
            f"trailing component axis)")
    if y_local.ndim > global_ids.ndim + 1:
        raise ValueError(
            f"gather: y_local has {y_local.ndim - global_ids.ndim} trailing "
            f"axes beyond global_ids; vector fields must pack components "
            f"into a single trailing axis (got shape {tuple(y_local.shape)} "
            f"vs ids {tuple(global_ids.shape)})")
    dt = y_local.dtype
    acc_dt = torch.float32 if dt.is_floating_point and \
        torch.finfo(dt).bits < 32 else dt
    trailing = tuple(y_local.shape[global_ids.ndim:])
    vals = y_local.reshape((-1,) + trailing).to(acc_dt)
    out = torch.zeros((n_global,) + trailing, dtype=acc_dt,
                      device=y_local.device)
    out.index_add_(0, global_ids.reshape(-1), vals)
    return out.to(dt)


def dssum(y_local: torch.Tensor, global_ids: torch.Tensor,
          n_global: int) -> torch.Tensor:
    """Direct-stiffness summation: Q Q^T y (Nek's dssum)."""
    return scatter(gather(y_local, global_ids, n_global), global_ids)


def multiplicity(global_ids: torch.Tensor, n_global: int) -> torch.Tensor:
    """Number of elements sharing each global dof (gslib 'vmult')."""
    ones = torch.ones(global_ids.numel(), dtype=torch.float32,
                      device=global_ids.device)
    out = torch.zeros(n_global, dtype=torch.float32, device=global_ids.device)
    return out.index_add_(0, global_ids.reshape(-1), ones)


def _expand_mask(mask: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Broadcast a (Ng,) bool mask against y's trailing batch axes."""
    if y.ndim == mask.ndim:
        return mask
    return mask.reshape(tuple(mask.shape) + (1,) * (y.ndim - mask.ndim))
