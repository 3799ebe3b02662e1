"""Preconditioned conjugate gradients (Nekbone's PCG, Figure 2).

The operator is supplied as a closure `A(x)` over global dofs (gather o
axhelm o scatter).  Preconditioners: none and Jacobi (inverse diagonal).

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

import torch

from repro_torch.resilience.status import classify

__all__ = ["PCGResult", "pcg"]

# Iterations between host reads of the device-side `active` flag: each read
# drains the launch queue once, so rarer reads keep the card busier while
# costing at most this many minus one gated iterations after convergence.
_CHECK_EVERY = 8


def _up(u: torch.Tensor) -> torch.Tensor:
    """Upcast sub-fp32 floats for reduction accumulation; fp32 and wider
    pass through untouched."""
    if u.dtype.is_floating_point and torch.finfo(u.dtype).bits < 32:
        return u.float()
    return u


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.dot(_up(u).reshape(-1), _up(v).reshape(-1))


class PCGResult(NamedTuple):
    """Outcome of a PCG solve; every field is a tensor on the solve's device.

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
        ) -> PCGResult:
    """Solve A x = b with (preconditioned) CG; stop when ``r.r <= tol^2``.

    Inner products are full contractions, accumulated in fp32 even for
    reduced-precision iterates.  `stagnation_window` > 0 additionally stops
    the solve with ``SolveStatus.STAGNATED`` when ``rr`` makes no new
    minimum for that many counted iterations (0, the default, disables the
    check).
    """
    if precond is None:
        def precond(r):
            return r
    dev = b.device

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - a_op(x)
    z = precond(r)
    p = z
    rz = _dot(r, z)
    rr = _dot(r, r)
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
        pap = _dot(p, ap)
        # Lanczos breakdown: p.Ap <= 0 with the residual still above
        # tolerance means A is not SPD along p — freeze and flag.
        bad = pap <= 0.0
        alpha = torch.where(bad, zero, rz / torch.where(bad, one, pap))
        step_len = alpha.to(x.dtype)
        x_new = x + step_len * p
        r_new = r - step_len * ap
        z_new = precond(r_new)
        rz_new = _dot(r_new, z_new)
        rr_new = _dot(r_new, r_new)
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
