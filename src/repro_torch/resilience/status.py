"""Structured solver outcomes: the SolveStatus lattice.

Every PCG solve reports WHY it stopped, not just how many iterations it
ran — `PCGResult.status` carries one of these codes, computed from scalars
the iteration already reduces (`rr`, `p.Ap`).

The codes form a severity lattice: DIVERGED > BREAKDOWN > STAGNATED >
CONVERGED > MAXITER.  A solve that hits several conditions reports the most
severe one; CONVERGED always wins over STAGNATED.
"""

from __future__ import annotations

import enum

import torch

__all__ = ["SolveStatus", "classify", "is_failure"]


class SolveStatus(enum.IntEnum):
    """Why a PCG solve stopped."""

    CONVERGED = 0   # residual met the tolerance
    MAXITER = 1     # ran out of iterations while still healthy
    DIVERGED = 2    # carried rr went NaN/Inf — a poisoned operator/field
    STAGNATED = 3   # rr made no new minimum for `stagnation_window` iters
    BREAKDOWN = 4   # Lanczos breakdown: p.Ap <= 0 while still active

    @property
    def ok(self) -> bool:
        return self is SolveStatus.CONVERGED


def classify(rr: torch.Tensor, tol2: float, breakdown: torch.Tensor,
             diverged: torch.Tensor, stagnated: torch.Tensor) -> torch.Tensor:
    """Fold the health flags into int32 SolveStatus codes (on rr's device).

    A non-finite final ``rr`` counts as DIVERGED even when the in-loop flag
    never fired (a NaN already in b poisons the initial residual, so the
    loop never advances).
    """
    diverged = diverged | ~torch.isfinite(rr)
    converged = rr <= tol2

    def code(s):
        return torch.tensor(int(s), dtype=torch.int32, device=rr.device)

    status = torch.where(converged, code(SolveStatus.CONVERGED),
                         code(SolveStatus.MAXITER))
    status = torch.where(stagnated & ~converged, code(SolveStatus.STAGNATED),
                         status)
    status = torch.where(breakdown, code(SolveStatus.BREAKDOWN), status)
    return torch.where(diverged, code(SolveStatus.DIVERGED), status)


def is_failure(status) -> torch.Tensor:
    """True where a status code needs recovery (anything but CONVERGED)."""
    return torch.as_tensor(status) != SolveStatus.CONVERGED
