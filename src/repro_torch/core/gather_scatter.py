"""Gather-scatter: the actions of Q and Q^T (paper Algorithm 1, gslib role).

Q is the sparse binary global-to-local matrix (Eq. 2); it is never built.
  scatter (Q):   global field (Ng[, d])            -> local (E, N1,N1,N1[, d])
  gather  (Q^T): local  (E, N1,N1,N1[, d])         -> global (Ng[, d]) sum

The reference package leaves the gather to XLA (`segment_sum`), which on
the CPU adds each dof's contributions one after another in ascending
local-node order.  The port sums in that order on every device, so that a
gather gives the same bits in every run, on the card and on the CPU, and
the reference's bits on the CPU: a `GatherPlan`, built once from the
global numbering, groups the dofs by multiplicity m (how many element
nodes share the dof: 1 inside an element, 2 on a face, 4 on an edge, 8 at
a vertex of a box mesh) and lists each dof's m local nodes in ascending
order; the gather reads them with one `torch.gather` and adds each
group's m values left to right (`ordered_sum`) — stock ops, no atomics.
A field with trailing components (d, or an RHS batch) is gathered, and in
the global operator also scattered (`scatter_columns`, `gather_columns`),
column by column from a column-major copy, so that every read and write
of the index gathers runs along contiguous memory: on CUDA, gathering rows
of a few components (`index_select`, indexing, or `torch.gather` with a
broadcast index) ran up to 25x slower (PERF.md).

On a sharded mesh each rank gathers its shard's elements into its local
dof space in the same fixed order (a plan over the shard's `local_ids`
that leaves out the trash slot), then one `all_reduce` of the process
group sums the interface dofs — the shared face, edge and corner dofs of
the partition, never the whole field — in float32 (`exchange_shared`;
the reference's `gather_sharded` is `gather` then `exchange_shared`, which
the shard operator of `nekbone` calls in turn, since a dropped exchange
keeps the partials between them).  See `mesh_gen.partition_elements` for
the index sets.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["GatherPlan", "gather_plan", "ordered_sum", "scatter", "gather",
           "scatter_columns", "gather_columns", "dssum", "multiplicity",
           "shared_contrib", "apply_shared", "exchange_shared"]


class GatherPlan(NamedTuple):
    """The order of the gather's sums, on the device of its tensors.

    perm:    (E N1^3,) local node positions (flat index into global_ids),
             grouped by their dof's multiplicity (ascending), dof after dof
             (ascending) within a group, and ascending within a dof.
    inv:     (Ng,) each dof's row in the groups' concatenated sums.
    classes: ((m, dofs with multiplicity m), ...), ascending m; m = 0 is
             the dofs that gather nothing (a shard's padding slots and its
             trash slot), whose sums are zero.
    """

    perm: torch.Tensor
    inv: torch.Tensor
    classes: tuple


def gather_plan(global_ids, n_global: int, device=None,
                skip: Optional[int] = None) -> GatherPlan:
    """Build the gather's plan from the numbering (numpy, at setup).  The
    contributions to dof `skip` (a shard's trash slot) are left out: its
    sum is zero."""
    ids = np.asarray(global_ids.cpu() if isinstance(global_ids, torch.Tensor)
                     else global_ids).reshape(-1).astype(np.int64)
    if device is None:
        device = global_ids.device if isinstance(global_ids, torch.Tensor) \
            else torch.device("cpu")
    counts = np.bincount(ids, minlength=n_global)
    # stable: equal dofs keep their ascending positions
    by_dof = np.argsort(ids, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    if skip is not None:
        counts[skip] = 0
    perm, order, classes = [], [], []
    for m in np.unique(counts):
        dofs = np.nonzero(counts == m)[0]
        perm.append(by_dof[starts[dofs][:, None] + np.arange(m)].reshape(-1))
        order.append(dofs)
        classes.append((int(m), len(dofs)))
    order = np.concatenate(order)
    inv = np.empty(n_global, dtype=np.int64)
    inv[order] = np.arange(len(order))
    return GatherPlan(torch.as_tensor(np.concatenate(perm), device=device),
                      torch.as_tensor(inv, device=device), tuple(classes))


def _dense(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` in `dtype`, contiguous: one copy where either differs, none
    where neither does."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return torch.empty(t.shape, dtype=dtype, device=t.device).copy_(t)


def ordered_sum(s: torch.Tensor) -> torch.Tensor:
    """Sum the last axis of s left to right: ((s0 + s1) + s2) + ..., the
    gather's order of addition."""
    acc = s[..., 0]
    for j in range(1, s.shape[-1]):
        acc = acc + s[..., j]
    return acc


def scatter(x_global: torch.Tensor, global_ids: torch.Tensor) -> torch.Tensor:
    """Q x: copy global dof values to element-local nodes."""
    return x_global[global_ids]


def scatter_columns(x_global: torch.Tensor,
                    global_ids: torch.Tensor) -> torch.Tensor:
    """Q x for a field of c columns, (Ng, c) -> (E, c, N1,N1,N1): the
    element kernels' layout, each column scattered from a column-major
    copy.  The same values as `scatter` with the column axis moved."""
    cols = x_global.shape[1]
    local = torch.gather(_dense(x_global.t(), x_global.dtype), 1,
                         global_ids.reshape(1, -1).expand(cols, -1))
    return local.view((cols,) + tuple(global_ids.shape)).movedim(0, 1) \
        .contiguous()


def _gather_columns(vals: torch.Tensor, plan: GatherPlan) -> torch.Tensor:
    """(cols, E N1^3) contiguous -> (cols, Ng), in the plan's order."""
    cols = vals.shape[0]
    grouped = torch.gather(vals, 1, plan.perm.expand(cols, -1))
    sums, start = [], 0
    for m, n in plan.classes:
        if m == 0:
            sums.append(vals.new_zeros((cols, n)))
            continue
        sums.append(ordered_sum(grouped[:, start:start + m * n].view(
            cols, n, m)))
        start += m * n
    return torch.gather(torch.cat(sums, 1), 1, plan.inv.expand(cols, -1))


def gather_columns(y_local: torch.Tensor, plan: GatherPlan) -> torch.Tensor:
    """Q^T y for the element kernels' layout, (E, c, N1,N1,N1) -> (Ng, c):
    the same bits as `gather` of y with the column axis moved last."""
    dt = y_local.dtype
    vals = _dense(y_local.movedim(1, 0), _accumulation(dt))
    out = _gather_columns(vals.view(y_local.shape[1], -1), plan)
    return _dense(out.t(), dt)


def _accumulation(dt: torch.dtype) -> torch.dtype:
    """Sub-fp32 floats sum in fp32; other dtypes in themselves."""
    if dt.is_floating_point and torch.finfo(dt).bits < 32:
        return torch.float32
    return dt


def gather(y_local: torch.Tensor, global_ids: torch.Tensor,
           n_global: int, plan: Optional[GatherPlan] = None) -> torch.Tensor:
    """Q^T y: sum element-local values into global dofs, in `plan`'s order
    (built from `global_ids` when not given).

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
    if plan is None:
        plan = gather_plan(global_ids, n_global, y_local.device)
    dt = y_local.dtype
    trailing = tuple(y_local.shape[global_ids.ndim:])
    cols = int(np.prod(trailing))
    # column-major (cols, E N1^3), in the accumulation dtype
    vals = _dense(y_local.reshape(-1, cols).t(), _accumulation(dt))
    out = _gather_columns(vals, plan)
    return _dense(out.t().reshape((n_global,) + trailing), dt)


def dssum(y_local: torch.Tensor, global_ids: torch.Tensor,
          n_global: int) -> torch.Tensor:
    """Direct-stiffness summation: Q Q^T y (Nek's dssum)."""
    return scatter(gather(y_local, global_ids, n_global), global_ids)


def multiplicity(global_ids: torch.Tensor, n_global: int) -> torch.Tensor:
    """Number of elements sharing each global dof (gslib 'vmult').  Small
    integers, exact in any order of addition."""
    ones = torch.ones(global_ids.numel(), dtype=torch.float32,
                      device=global_ids.device)
    out = torch.zeros(n_global, dtype=torch.float32, device=global_ids.device)
    return out.index_add_(0, global_ids.reshape(-1), ones)


def _expand_mask(mask: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Broadcast a (Ng,) bool mask against y's trailing batch axes."""
    if y.ndim == mask.ndim:
        return mask
    return mask.reshape(tuple(mask.shape) + (1,) * (y.ndim - mask.ndim))


def shared_contrib(y_dofs: torch.Tensor, shared_idx: torch.Tensor,
                   shared_present: torch.Tensor) -> torch.Tensor:
    """This shard's partial sums at the interface dofs, zero where absent.

    y_dofs: (L[, c]) the shard's local dof values; shared_idx: (NS,) local
    slots (the trash slot where absent); shared_present: (NS,) bool.
    """
    vals = y_dofs[shared_idx]
    return torch.where(_expand_mask(shared_present, vals), vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))


def apply_shared(y_dofs: torch.Tensor, shared_idx: torch.Tensor,
                 summed: torch.Tensor) -> torch.Tensor:
    """A copy of `y_dofs` with the summed interface values written back into
    their local slots.  Absent interface dofs carry the trash slot, so
    their writes land there (its value is never read unmasked)."""
    out = y_dofs.clone()
    out[shared_idx] = summed.to(y_dofs.dtype)
    return out


def exchange_shared(y_dofs: torch.Tensor, shared_idx: torch.Tensor,
                    shared_present: torch.Tensor, group) -> torch.Tensor:
    """Sum the interface dofs' partials across the ranks of `group`: one
    `all_reduce` of the (NS[, c]) interface buffer — the whole RHS batch
    rides along as its columns.  Sub-fp32 partials are widened to fp32,
    summed and rounded once (the gather's accumulation rule, which also
    keeps bfloat16 off the wire)."""
    contrib = shared_contrib(y_dofs, shared_idx, shared_present)
    buf = _dense(contrib, _accumulation(contrib.dtype))
    dist.all_reduce(buf, group=group)
    return apply_shared(y_dofs, shared_idx, buf)
