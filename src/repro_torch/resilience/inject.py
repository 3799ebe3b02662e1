"""Deterministic solver-level fault injection (the reference's
`resilience.inject`).

A `FaultSpec` pins every coordinate of a fault — what kind, which PCG
iteration, which element, which shard, which RHS column — so a fire is
exactly reproducible.  `wrap_operator` makes an iteration-aware operator that
`core.pcg` calls as ``A(x, it)`` with the loop's counter on the device;
whether it fires is a device comparison with that counter, so the fault
lives inside a captured chunk and strikes on the replay of the chosen
iteration.  A sharded solve strikes inside the shard pipeline of rank
``shard`` instead (`core.nekbone._build_sharded_runner`), with `fault_dof`
taken on that shard's `local_ids`.  Modes:

- ``"nan"``     — overwrite one dof of the operator output with NaN: a
  kernel reading garbage memory.  DIVERGED within one iteration.
- ``"bitflip"`` — multiply one dof of A(p) by finfo(dtype).max ** 0.75: a
  high-exponent-bit flip that stays finite, so CG's step normalisation
  absorbs it and it surfaces as BREAKDOWN or a stall (the "silent data
  corruption" case the structured statuses exist for).
- ``"drop_exchange"`` — one shard keeps its local partial sums on the
  shared dofs for one application, as if the interface exchange had been
  lost.  It does not make ``rr`` non-finite; the true-residual audit of
  `resilience.retry` catches it.  Sharded solves only: wrapping a
  single-device operator with it raises.

The poisoned node is the CENTER node of the chosen element, element-
interior for order >= 2: never masked, never shared.  The initial-residual
application (``it = -1``) and out-of-loop uses of the operator are never
corrupted.

`SimulatedFailure` lives here so the training-side
`training.fault_tolerance.FailureInjector` (host-level, step-keyed) and this
solver-side injector share one failure vocabulary; the training module
re-exports it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["FaultSpec", "SimulatedFailure", "FAULT_MODES", "bitflip_scale",
           "fault_dof", "poison", "wrap_operator"]

FAULT_MODES = ("nan", "bitflip", "drop_exchange")


def bitflip_scale(dtype: torch.dtype) -> float:
    """The bitflip multiplier for `dtype`: far beyond any physical field
    magnitude while the product stays representable, so the fault corrupts
    the iteration, not the arithmetic."""
    return float(torch.finfo(dtype).max) ** 0.75


class SimulatedFailure(RuntimeError):
    """A scheduled, injected failure fired (host-level injectors raise it)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Where, when and how to corrupt a solve.  Frozen and hashable: solves
    key their loops on it.

    ``iteration`` is the PCG loop iteration to fire at (>= 0; the
    initial-residual application is iteration -1 and is never faulted).
    ``element`` is the element slot local to ``shard`` on a sharded solve
    (an index into that shard's element batch), a global element index
    otherwise (``shard`` must then stay 0).  ``column`` selects one RHS column of a block solve (None =
    every column); ignored for single-RHS solves.
    """

    mode: str = "nan"
    iteration: int = 3
    element: int = 0
    shard: int = 0
    column: Optional[int] = None

    def __post_init__(self):
        if self.mode not in FAULT_MODES:
            raise ValueError(
                f"unknown fault mode {self.mode!r}: expected one of "
                f"{FAULT_MODES}")
        if self.iteration < 0:
            raise ValueError(
                "fault.iteration must be >= 0: faults fire on PCG loop "
                "iterations; the initial-residual application (iteration "
                "-1) is never corrupted")


def fault_dof(ids, spec: FaultSpec) -> int:
    """The dof index of the poisoned node: the CENTER node of
    `spec.element` in `ids` (E, N1, N1, N1) — `mesh.global_ids`, or one
    shard's `part.local_ids[shard]` on a sharded solve — element-interior
    for order >= 2.  numpy, at setup."""
    ids = np.asarray(ids)
    n1 = ids.shape[-1]
    if n1 < 3:
        raise ValueError(
            f"fault injection needs order >= 2 (got {n1 - 1}): on order-1 "
            f"elements every node is a vertex, so the poisoned node would "
            f"be a shared/boundary dof and the masking paths could erase "
            f"or double-count the corruption")
    if not 0 <= spec.element < ids.shape[0]:
        raise ValueError(
            f"fault.element {spec.element} out of range for {ids.shape[0]} "
            f"element slots")
    c = n1 // 2
    return int(ids[spec.element, c, c, c])


def poison(y: torch.Tensor, dof: int, fire: torch.Tensor,
           spec: FaultSpec) -> torch.Tensor:
    """A copy of `y` with row `dof` (across any trailing batch axes)
    corrupted where the device boolean `fire` is True; `spec.column`
    restricts the corruption to one slice of the trailing (RHS) axis."""
    row = y[dof]
    if spec.mode == "nan":
        bad = torch.full_like(row, float("nan"))
    else:
        bad = row * bitflip_scale(y.dtype)
    if spec.column is not None and row.ndim >= 1:
        only = row.clone()
        only[..., spec.column] = bad[..., spec.column]
        bad = only
    out = y.clone()
    out[dof] = torch.where(fire, bad, row)
    return out


def wrap_operator(a_op, spec: FaultSpec, global_ids):
    """Wrap a single-device global operator `A(x)` with the fault: an
    iteration-aware operator (``takes_iteration = True``) that fires
    exactly when ``it == spec.iteration``.  Sharded solves do not use it:
    their fault strikes inside the shard pipeline."""
    if spec.mode == "drop_exchange":
        raise ValueError(
            "mode='drop_exchange' needs a sharded solve — there is no "
            "interface exchange to drop on one device; use 'nan' or "
            "'bitflip'")
    if spec.shard != 0:
        raise ValueError(
            f"fault.shard {spec.shard} on an unsharded solve (only shard 0 "
            f"exists)")
    dof = fault_dof(global_ids, spec)

    def apply(x, it):
        return poison(a_op(x), dof, it == spec.iteration, spec)

    apply.takes_iteration = True
    return apply
