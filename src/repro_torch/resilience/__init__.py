"""Structured solver outcomes (the `SolveStatus` lattice)."""

from repro_torch.resilience.status import SolveStatus, classify

__all__ = ["SolveStatus", "classify"]
