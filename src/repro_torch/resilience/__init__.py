"""Resilient solves: structured statuses, fault injection, retry.

- `status` — the SolveStatus lattice `core.pcg` threads through PCGResult.
- `inject` — deterministic fault injection (`FaultSpec`): a NaN or a
  bit-flip-like spike at a chosen PCG iteration, inside the loop.
- `retry`  — `solve_resilient`: true-residual verification and the ladder
  restart -> backend -> precision, with a structured `SolveReport`.

`retry` imports `core.nekbone`, which imports `inject`; import it as
`repro_torch.resilience.retry`.
"""

from repro_torch.resilience.status import SolveStatus, classify, is_failure

__all__ = ["SolveStatus", "classify", "is_failure"]
