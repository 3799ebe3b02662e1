"""Preconditioned conjugate gradients (Nekbone's PCG, Figure 2).

The operator is supplied as a closure `A(x)` over global dofs (gather o
axhelm o scatter).  Preconditioners: none and Jacobi (inverse diagonal).
`pcg_block` solves nrhs stacked right-hand sides (trailing axis) with
per-column alpha/beta and a freeze mask; `refine` is the mixed-precision
solve: fp32 outer residual and correction around reduced-precision inner
`pcg`/`pcg_block` sweeps.

The reference runs the loop as one `jax.lax.while_loop`.  PyTorch runs
eagerly, so the port runs the body as a Python loop whose state stays on
the device: an ``active`` flag — the while_loop's ``cond`` — is computed on
the device at the top of every iteration and gates every update with
``torch.where``, exactly as the reference body gates on ``bad``/``hurt``.
An inactive iteration therefore changes nothing, and a converged solve
reports the same iteration count as the reference.  The host reads the
flag only every ``_CHECK_EVERY`` iterations (one device sync each), so up
to ``_CHECK_EVERY - 1`` gated iterations may run after the solve stops;
they cost operator applications, not correctness.  The loop body has no
host sync and no data-dependent Python branch, so it can later be captured
in a CUDA graph unchanged.

Health monitoring lives INSIDE the loop, on the scalars it already
reduces: the carried ``rr`` going NaN/Inf rolls the step back and flags
DIVERGED, ``p.Ap <= 0`` freezes the iterate and flags BREAKDOWN, and an
optional stagnation window flags STAGNATED (see `resilience.status`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.resilience.status import classify

__all__ = ["PCGResult", "pcg", "pcg_block", "refine"]

# Iterations between host reads of the device-side `active` flag: each read
# drains the launch queue once, so rarer reads keep the card busier while
# costing at most this many minus one gated iterations after convergence.
_CHECK_EVERY = 8

# `refine`'s fixed settings, the reference's defaults: the floor of the
# adaptive inner tolerance, the most refinement sweeps, and the sweeps in a
# row without a lower true residual that make a column STAGNATED.
_INNER_TOL = 0.03
_MAX_OUTER = 40
_STALL_LIMIT = 1


def _up(u: torch.Tensor) -> torch.Tensor:
    """Upcast sub-fp32 floats for reduction accumulation; fp32 and wider
    pass through untouched."""
    if u.dtype.is_floating_point and torch.finfo(u.dtype).bits < 32:
        return u.float()
    return u


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.dot(_up(u).reshape(-1), _up(v).reshape(-1))


def _column_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-column dots of stacked fields: every axis but the last."""
    return (_up(u) * _up(v)).sum(dim=tuple(range(u.ndim - 1)))


class PCGResult(NamedTuple):
    """Outcome of a PCG solve; every field is a tensor on the solve's device
    (a scalar for `pcg`, one value per column for `pcg_block`).

    ``status`` is a `resilience.status.SolveStatus` code saying WHY the
    solve stopped; ``breakdown`` is the boolean view of the BREAKDOWN case.
    In every non-CONVERGED case the solve is frozen at its last *finite*
    iterate, so `x` is always a valid restart point and ``residual``
    reports where it stalled.
    """

    x: torch.Tensor
    iterations: torch.Tensor       # int32 scalar
    residual: torch.Tensor         # final sqrt(r.r) (last finite iterate)
    initial_residual: torch.Tensor
    breakdown: torch.Tensor        # bool scalar
    status: torch.Tensor           # int32 SolveStatus code


def pcg(a_op: Callable[[torch.Tensor], torch.Tensor],
        b: torch.Tensor,
        x0: Optional[torch.Tensor] = None,
        precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        tol: float = 1e-8,
        max_iter: int = 200,
        stagnation_window: int = 0,
        dot: Optional[Callable[[torch.Tensor, torch.Tensor],
                               torch.Tensor]] = None,
        ) -> PCGResult:
    """Solve A x = b with (preconditioned) CG; stop when ``r.r <= tol^2``.

    Inner products are full contractions (or `dot`), accumulated in fp32
    even for reduced-precision iterates; the iterates stay in b's dtype.
    `stagnation_window` > 0 additionally stops the solve with
    ``SolveStatus.STAGNATED`` when ``rr`` makes no new minimum for that
    many counted iterations (0, the default, disables the check).
    """
    if dot is None:
        dot = _dot
    if precond is None:
        def precond(r):
            return r
    dev = b.device

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - a_op(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    rr = dot(r, r)
    r0 = torch.sqrt(rr)
    tol2 = tol * tol
    zero = torch.zeros((), dtype=rr.dtype, device=dev)
    one = torch.ones((), dtype=rr.dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    brk = torch.zeros((), dtype=torch.bool, device=dev)
    div = torch.zeros((), dtype=torch.bool, device=dev)
    stag = torch.zeros((), dtype=torch.bool, device=dev)
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    best = rr

    # Every active body either advances `it` or raises a flag that ends the
    # solve, so max_iter bodies cover every reachable state.
    for step in range(max_iter):
        active = (it < max_iter) & (rr > tol2) & ~brk & ~div & ~stag
        if step % _CHECK_EVERY == 0 and not bool(active):
            break
        ap = a_op(p)
        pap = dot(p, ap)
        # Lanczos breakdown: p.Ap <= 0 with the residual still above
        # tolerance means A is not SPD along p — freeze and flag.
        bad = pap <= 0.0
        alpha = torch.where(bad, zero, rz / torch.where(bad, one, pap))
        step_len = alpha.to(x.dtype)
        x_new = x + step_len * p
        r_new = r - step_len * ap
        z_new = precond(r_new)
        rz_new = dot(r_new, z_new)
        rr_new = dot(r_new, r_new)
        # divergence: the carried rr went non-finite THIS iteration — roll
        # the whole step back so x stays the last finite iterate.
        hurt = ~torch.isfinite(rr_new)
        keep = hurt | ~active
        x = torch.where(keep, x, x_new)
        r = torch.where(keep, r, r_new)
        z = torch.where(keep, z, z_new)
        rz2 = torch.where(keep, rz, rz_new)
        rr2 = torch.where(keep, rr, rr_new)
        beta = torch.where(bad | hurt, zero,
                           rz_new / torch.where(rz != 0, rz, one))
        p = torch.where(bad | keep, p, z_new + beta.to(p.dtype) * p)
        advanced = active & ~bad & ~hurt
        # stagnation: iterations since the last new rr minimum
        improved = rr2 < best
        stall = torch.where(improved, 0, stall + advanced.to(torch.int32))
        best = torch.minimum(best, rr2)
        if stagnation_window > 0:
            stag = stag | (advanced & (stall >= stagnation_window)
                           & (rr2 > tol2))
        div = div | (active & hurt)
        brk = torch.where(active, bad, brk)
        rz, rr = rz2, rr2
        it = it + advanced.to(torch.int32)

    status = classify(rr, tol2, brk, div, stag)
    return PCGResult(x, it, torch.sqrt(rr), r0, brk, status)


def pcg_block(a_op: Callable[[torch.Tensor], torch.Tensor],
              b: torch.Tensor,
              x0: Optional[torch.Tensor] = None,
              precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
              tol: float = 1e-8,
              max_iter: int = 200,
              dot: Optional[Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor]] = None,
              stagnation_window: int = 0,
              ) -> PCGResult:
    """Solve A X = B for nrhs stacked right-hand sides (trailing axis).

    Each column runs the iteration of :func:`pcg` with its own alpha/beta;
    the operator is applied once per iteration to the whole block.  A
    column whose carried ``rr`` met the tolerance, or that broke down
    (``p.Ap <= 0`` while active), diverged (its step rolled back) or
    stagnated, is frozen (alpha 0, search direction kept) with its own
    `SolveStatus` code, while the other columns go on; the solve ends when
    no column is live or after ``max_iter`` iterations.  `dot` must return
    per-column values of shape (nrhs,) (default: every axis but the last,
    in fp32).  ``iterations``, ``residual``, ``initial_residual``,
    ``breakdown`` and ``status`` are per column; ``iterations`` counts the
    iterations each column advanced.

    As in :func:`pcg`, the loop runs eagerly with its state on the device:
    ``on`` — the reference while_loop's ``cond`` — gates a whole body, the
    host reads it every ``_CHECK_EVERY`` iterations, and a body after the
    end changes nothing.
    """
    if dot is None:
        dot = _column_dot
    if precond is None:
        def precond(r):
            return r
    dev = b.device

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - a_op(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    rr = dot(r, r)
    r0 = torch.sqrt(rr)
    tol2 = tol * tol
    nrhs = b.shape[-1]
    zero = torch.zeros((), dtype=rr.dtype, device=dev)
    one = torch.ones((), dtype=rr.dtype, device=dev)
    it = torch.zeros((nrhs,), dtype=torch.int32, device=dev)
    brk = torch.zeros((nrhs,), dtype=torch.bool, device=dev)
    div = torch.zeros_like(brk)
    stag = torch.zeros_like(brk)
    stall = torch.zeros_like(it)
    best = rr

    # the reference's cond also caps its count of bodies run at max_iter,
    # which the range below already does
    for step in range(max_iter):
        live = (rr > tol2) & ~brk & ~div & ~stag       # (nrhs,)
        on = live.any()
        if step % _CHECK_EVERY == 0 and not bool(on):
            break
        active = live & on
        ap = a_op(p)
        pap = dot(p, ap)
        # Lanczos breakdown on an active column: freeze it and flag it; the
        # healthy columns go on
        bad = active & (pap <= 0.0)
        brk = brk | bad
        active = active & ~bad
        alpha = torch.where(active, rz / torch.where(pap > 0, pap, one),
                            zero)
        step_len = alpha.to(x.dtype)     # fp32 per column -> iterate dtype
        x_new = x + step_len * p
        r_new = r - step_len * ap
        z_new = precond(r_new)
        rz_new = dot(r_new, z_new)
        rr_new = dot(r_new, r_new)
        # divergence: an active column's rr went non-finite; roll THAT
        # column's step back and flag it
        hurt = active & ~torch.isfinite(rr_new)
        div = div | hurt
        keep = hurt | ~on
        x = torch.where(keep, x, x_new)
        r = torch.where(keep, r, r_new)
        z = torch.where(keep, z, z_new)
        rz2 = torch.where(keep, rz, rz_new)
        rr2 = torch.where(keep, rr, rr_new)
        advanced = active & ~hurt
        beta = torch.where(advanced,
                           rz_new / torch.where(rz != 0, rz, one), zero)
        p = torch.where(advanced, z + beta.to(p.dtype) * p, p)
        # stagnation: per-column iterations since a new rr minimum
        improved = rr2 < best
        stall = torch.where(improved, 0, stall + advanced.to(torch.int32))
        best = torch.minimum(best, rr2)
        if stagnation_window > 0:
            stag = stag | (advanced & (stall >= stagnation_window)
                           & (rr2 > tol2))
        rz, rr = rz2, rr2
        it = it + advanced.to(torch.int32)

    status = classify(rr, tol2, brk, div, stag)
    return PCGResult(x, it, torch.sqrt(rr), r0, brk, status)


def refine(a_hi, a_lo, b: torch.Tensor,
           x0: Optional[torch.Tensor] = None,
           precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
           tol: float = 1e-8,
           max_iter: int = 200,
           batched: bool = False,
           inner_window: int = 5) -> PCGResult:
    """Mixed-precision iterative refinement: fp32 outer, bfloat16 inner.

    The outer loop keeps ``x``, the TRUE residual ``r = b - a_hi(x)`` and
    the accumulated correction in fp32; each sweep solves ``A d = r/||r||``
    (normalised per column) with an inner :func:`pcg` / :func:`pcg_block`
    on the bfloat16 operator ``a_lo``, iterates in bfloat16 and reductions
    in fp32 (full contractions, per column when `batched`), and adds
    ``d * ||r||`` in fp32.  The inner target is adaptive,
    ``clip(0.5 tol / max ||r||, _INNER_TOL, 0.3)`` over the active columns,
    with ``inner_window`` as the inner stagnation window.  Acceptance is
    monotone: a sweep that does not lower a column's true ``rr`` is rolled
    back for that column, and after ``_STALL_LIMIT`` such sweeps in a row
    the column is STAGNATED; a non-finite ``rr`` rolls back
    and flags DIVERGED.  A converged or flagged column gets a zero inner
    RHS and its fp32 state stops moving.  ``iterations`` counts the total
    inner iterations (reduced-precision operator applications) per column,
    and the loop stops at ``max_iter`` of them, after ``_MAX_OUTER`` sweeps,
    or when no column is live.

    The reference runs the loop as one while_loop with the inner tolerance
    and budget as device scalars.  The port's inner `pcg` takes them as
    Python numbers, so each sweep reads one small tensor on the host —
    whether a column is live, the iterations spent and the largest active
    residual — and computes the inner tolerance from it in float32, as the
    reference does on the device.
    """
    dot = _column_dot if batched else _dot
    b32 = b.to(torch.float32)
    runner = pcg_block if batched else pcg

    x = torch.zeros_like(b32) if x0 is None else x0.to(torch.float32)
    r = (b32 - a_hi(x)).to(torch.float32)
    rr = dot(r, r)
    r0 = torch.sqrt(rr)
    tol2 = tol * tol
    dev = b.device
    it = torch.zeros(rr.shape, dtype=torch.int32, device=dev)
    div = torch.zeros(rr.shape, dtype=torch.bool, device=dev)
    stag = torch.zeros_like(div)
    stall = torch.zeros_like(it)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    for _ in range(_MAX_OUTER):
        active = (rr > tol2) & ~div & ~stag
        rnorm = torch.sqrt(rr)
        maxr = torch.where(active, rnorm, zero).max()
        # the sweep's one host read
        live, spent, maxr_h = torch.stack(
            [active.any().float(), it.max().float(), maxr]).tolist()
        if not live or spent >= max_iter:
            break
        safe = torch.where(active & (rnorm > 0), rnorm, one)
        # a frozen column gets a zero inner RHS: its inner column converges
        # at iteration 0 and the block freeze keeps it out of the others
        r_hat = torch.where(active, r / safe, zero).to(torch.bfloat16)
        f32 = np.float32
        itol = float(np.clip(f32(0.5) * np.sqrt(f32(tol2))
                             / f32(maxr_h if maxr_h > 0 else 1.0),
                             f32(_INNER_TOL), f32(0.3)))
        res = runner(a_lo, r_hat, precond=precond, tol=itol,
                     max_iter=max(max_iter - int(spent), 1), dot=dot,
                     stagnation_window=inner_window)
        d = res.x.to(torch.float32) * torch.where(active, rnorm, zero)
        x_new = x + d
        r_new = (b32 - a_hi(x_new)).to(torch.float32)
        rr_new = dot(r_new, r_new)
        hurt = active & ~torch.isfinite(rr_new)
        div = div | hurt
        # a finite sweep that did not improve its column is rolled back
        # too: the sweep is a deterministic function of (r, a_lo), so
        # keeping the worse iterate would only compound — count the stall
        worse = active & ~hurt & (rr_new >= rr)
        keep = hurt | worse
        x = torch.where(keep, x, x_new)
        r = torch.where(keep, r, r_new)
        rr = torch.where(keep, rr, rr_new)
        stall = torch.where(active & ~keep, 0,
                            stall + worse.to(torch.int32))
        stag = stag | (worse & (stall >= _STALL_LIMIT))
        it = it + torch.where(active, res.iterations, 0).to(torch.int32)

    brk = torch.zeros_like(div)
    status = classify(rr, tol2, brk, div, stag)
    return PCGResult(x, it, torch.sqrt(rr), r0, brk, status)
