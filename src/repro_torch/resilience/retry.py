"""Recovery policy: `solve_resilient` and the escalation ladder (the
reference's `resilience.retry`, single device).

A solve that comes back non-CONVERGED, or that "converged" on a recursive
residual the TRUE residual ``||b - A x||`` of the original problem's clean
operator does not confirm, is retried for its failed columns only, up a
bounded ladder:

1. **restart** — the SAME problem again from the frozen last-finite
   iterate (`core.pcg` rolls a diverged step back, so it is a valid warm
   start).  Cures a transient fault; a persistent one refires.
2. **backend:reference** — the problem rebuilt on the plain PyTorch
   version of the element operator, when it ran the CUDA kernels
   (``backend="cuda"``; the reference's ``pallas -> reference``): a
   defect of the kernel goes with the kernel.  Opt-in
   (``RetryPolicy(backend_fallback=True)``): on a card this rung answers
   with the plain version in place of the kernels, which the caller has
   to ask for; the reference's policy has it on by default.
3. **precision:float32** — the problem rebuilt in float32, when it leaned
   on reduced precision (a bf16 dtype, or a ``bf16_x32`` solve, whose
   rebuild drops the precision tag).

The ladder acts on solve STATUSES only.  It catches no exception: a kernel
that fails to build or launch raises through `solve_resilient` as it
would through `solve`.  Rebuild rungs run clean (no injected fault).  The
bookkeeping is numpy on the host; every solve is an ordinary
`core.nekbone.solve`, captured and replayed on a card.  A sharded problem
runs the same ladder on every rank: its answers and true residuals are the
same on every rank, so every rank takes the same rungs, and the rebuild
rungs rebuild it over the same `shard_ctx`.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import nekbone as _nek
from repro_torch.resilience.status import SolveStatus

__all__ = ["RetryPolicy", "AttemptRecord", "SolveReport",
           "has_precision_fallback", "solve_resilient"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Knobs of `solve_resilient`'s ladder.

    A column is accepted when ``||b - A x|| <= verify_factor * max(tol,
    eps * ||b||)`` (`tol` absolute, as the solver's ``rr > tol^2`` stop;
    the ``eps * ||b||`` floor keeps a tol below the dtype's attainable true
    residual from demoting every honest answer).  ``warm_start`` carries
    the best iterate into the REBUILD rungs too (the restart rung always
    warm-starts); off by default, so a clean rung's iterations match a
    cold solve's.  ``backend_fallback`` is off by default (the reference's
    is on): the backend:reference rung replaces the kernels with the plain
    version, so only a caller that asks for it gets that answer.
    """

    max_attempts: int = 4
    restart: bool = True
    backend_fallback: bool = False
    precision_fallback: bool = True
    warm_start: bool = False
    verify_factor: float = 10.0
    stagnation_window: int = 0


@dataclasses.dataclass
class AttemptRecord:
    """One rung's outcome (arrays per ATTEMPTED column, see `columns`)."""

    rung: str
    columns: Tuple[int, ...]       # the column indices this rung ran
    status: np.ndarray
    iterations: np.ndarray
    residual: np.ndarray           # recursive residual the solver reported
    true_residual: np.ndarray      # ||b - A x|| through the clean operator
    failed_columns: Tuple[int, ...]  # columns still failed after this rung


@dataclasses.dataclass
class SolveReport:
    """Outcome of a resilient solve.  Per-column arrays have length nrhs
    (1 for a single RHS); ``rung[j]`` names the rung whose answer column j
    carries."""

    x: torch.Tensor
    converged: bool
    status: np.ndarray
    iterations: np.ndarray
    residual: np.ndarray
    true_residual: np.ndarray
    rung: Tuple[str, ...]
    attempts: List[AttemptRecord]

    @property
    def ok(self) -> bool:
        return self.converged


_LOW_PRECISION = (torch.bfloat16, torch.float16)


def has_precision_fallback(problem) -> bool:
    """True when the precision:float32 rung applies: the problem lives at a
    low dtype, or it is a ``bf16_x32`` solve (whose diag is float32)."""
    return (problem.diag.dtype in _LOW_PRECISION
            or problem.precision == "bf16_x32")


def _default_rebuild(problem, full_nrhs):
    """Rebuild `problem` through `setup_problem` with the arguments it
    records.  Scalar lambdas are re-derived by `setup_problem`; per-node
    lambda fields cannot be recovered, so callers with fields pass their
    own ``rebuild``.  ``nrhs`` is the width the rung solves (the failed
    columns), or the full batch's."""

    def rebuild(backend=None, dtype=None, nrhs=None):
        # an explicit dtype IS the precision:float32 rung: for a bf16_x32
        # problem (already float32) it drops the precision tag; every
        # other rung keeps the tag
        precision = None if dtype is not None else problem.precision
        return _nek.setup_problem(
            problem.mesh, variant=problem.variant, d=problem.d,
            helmholtz=problem.helmholtz, dirichlet=problem.mask is not None,
            dtype=dtype if dtype is not None else problem.diag.dtype,
            backend=backend if backend is not None else problem.backend,
            device=problem.device, precision=precision,
            nrhs=full_nrhs if nrhs is None else nrhs,
            shard_ctx=getattr(problem, "shard_ctx", None))

    return rebuild


def _rebuild_caller(rebuild):
    """Call `rebuild` with ``nrhs=`` only where it accepts it (rebuilds
    written for the two-keyword surface keep working)."""
    try:
        params = inspect.signature(rebuild).parameters
        takes_nrhs = "nrhs" in params or any(
            p.kind == p.VAR_KEYWORD for p in params.values())
    except (TypeError, ValueError):  # callables without a signature
        takes_nrhs = True

    def call(nrhs, **kwargs):
        if takes_nrhs:
            kwargs["nrhs"] = nrhs
        return rebuild(**kwargs)

    return call


def _host64(t) -> np.ndarray:
    """A writable float64 numpy copy of a tensor or an array."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64).numpy()
    return np.array(t, np.float64)


def solve_resilient(problem, b: torch.Tensor,
                    policy: Optional[RetryPolicy] = None, *,
                    precond: str = "jacobi", tol: float = 1e-8,
                    max_iter: int = 200, fault=None, persistent: bool = True,
                    rebuild: Optional[Callable] = None,
                    solve_fn: Optional[Callable] = None) -> SolveReport:
    """Solve A x = b, detecting and recovering from failed columns.

    `fault` (a `resilience.inject.FaultSpec`) corrupts the initial attempt,
    refires on the restart rung when ``persistent=True`` (a deterministic
    defect) and not when ``persistent=False`` (a transient upset); rebuild
    rungs run clean.  Verification always runs through the ORIGINAL
    problem's clean operator.

    `rebuild(backend=None, dtype=None, nrhs=None)` builds the fallback
    rungs' problems (default: `setup_problem` with the problem's own
    arguments); `solve_fn(prob, b, x0, fault) -> PCGResult` overrides how
    each rung solves (default: `core.nekbone.solve` with this call's
    settings).  Returns a `SolveReport`: ``converged`` is the verdict and
    ``attempts`` the per-rung audit trail.
    """
    policy = policy or RetryPolicy()
    base = 1 if problem.d == 1 else 2
    batched = b.ndim == base + 1
    nrhs = b.shape[-1] if batched else 1
    b64 = _host64(b)
    axes = tuple(range(b64.ndim - 1)) if batched else None
    bnorm = np.atleast_1d(np.sqrt(np.sum(b64 * b64, axis=axes)))
    eps = float(torch.finfo(problem.diag.dtype).eps)
    thresh = policy.verify_factor * np.maximum(tol, eps * bnorm)
    rebuild = _rebuild_caller(rebuild if rebuild is not None
                              else _default_rebuild(problem, nrhs))

    if solve_fn is None:
        def solve_fn(prob, b_arr, x0, flt):
            dt = prob.diag.dtype
            return _nek.solve(
                prob, torch.as_tensor(b_arr, dtype=dt, device=prob.device),
                precond=precond, tol=tol, max_iter=max_iter,
                x0=None if x0 is None else torch.as_tensor(
                    x0, dtype=dt, device=prob.device),
                stagnation_window=policy.stagnation_window, fault=flt)
    run = solve_fn

    def true_residual(x_full):
        # the ORIGINAL problem's clean operator is the ground truth: it
        # never carries the injected fault, and one fixed operator keeps
        # the bar the same on every rung
        ax = problem.op(torch.as_tensor(x_full, dtype=problem.diag.dtype,
                                        device=problem.device))
        r = b64 - _host64(ax)
        return np.atleast_1d(np.sqrt(np.sum(r * r, axis=axes)))

    def audit(name, cols, res, x_full):
        """One rung's record: its statuses, with a CONVERGED column whose
        true residual disagrees (a lying recursive residual) demoted to
        STAGNATED so the ladder keeps climbing."""
        st = np.atleast_1d(res.status.cpu().numpy()).astype(np.int64)
        it = np.atleast_1d(res.iterations.cpu().numpy()).astype(np.int64)
        rr = np.atleast_1d(_host64(res.residual))
        cols = np.asarray(cols)
        tr = true_residual(x_full)[cols]
        lying = (st == int(SolveStatus.CONVERGED)) & (tr > thresh[cols])
        st = np.where(lying, int(SolveStatus.STAGNATED), st)
        ok = st == int(SolveStatus.CONVERGED)
        rec = AttemptRecord(name, tuple(int(c) for c in cols), st, it, rr,
                            tr, tuple(int(c) for c in cols[~ok]))
        return rec, ok

    # attempt 0: the caller's problem, fault and all
    res = run(problem, b, None, fault)
    x = _host64(res.x)
    rec, ok = audit("initial", tuple(range(nrhs)), res, x)
    status, iters = rec.status.copy(), rec.iterations.copy()
    resid, true_res = rec.residual.copy(), rec.true_residual.copy()
    rung_of = np.array(["initial"] * nrhs, dtype=object)
    attempts = [rec]
    failed = ~ok

    ladder = []
    if policy.restart:
        ladder.append(("restart", lambda n: problem,
                       fault if persistent else None, True))
    if policy.backend_fallback and problem.backend == "cuda":
        ladder.append(("backend:reference",
                       lambda n: rebuild(n, backend="reference"), None,
                       policy.warm_start))
    if policy.precision_fallback and has_precision_fallback(problem):
        ladder.append(("precision:float32",
                       lambda n: rebuild(n, dtype=torch.float32), None,
                       policy.warm_start))

    for name, build, flt, warm in ladder:
        if not failed.any() or len(attempts) >= policy.max_attempts:
            break
        cols = np.nonzero(failed)[0]
        prob2 = build(len(cols))
        # a warm start only helps from an iterate that beats x0 = 0: a
        # column whose true residual is no better than ||b|| restarts cold
        warm_x = x.copy()
        useless = true_res >= bnorm
        if batched:
            warm_x[..., useless] = 0.0
        elif useless[0]:
            warm_x = np.zeros_like(x)
        if batched:
            b_sub = b[..., torch.as_tensor(cols, device=b.device)]
            x0_sub = warm_x[..., cols] if warm else None
        else:
            b_sub, x0_sub = b, (warm_x if warm else None)
        res2 = run(prob2, b_sub, x0_sub, flt)
        x_try = x.copy()
        if batched:
            x_try[..., cols] = _host64(res2.x)
        else:
            x_try = _host64(res2.x)
        rec, ok2 = audit(name, tuple(cols), res2, x_try)
        attempts.append(rec)
        # adopt every attempted column's latest state; only verified
        # columns advance x and settle their rung
        status[cols], iters[cols] = rec.status, rec.iterations
        resid[cols], true_res[cols] = rec.residual, rec.true_residual
        good = cols[ok2]
        if batched:
            x[..., good] = x_try[..., good]
        elif ok2[0]:
            x = x_try
        rung_of[good] = name
        failed = status != int(SolveStatus.CONVERGED)

    x_out = torch.as_tensor(x, dtype=problem.diag.dtype,
                            device=problem.device)
    return SolveReport(x=x_out, converged=not bool(failed.any()),
                       status=status, iterations=iters, residual=resid,
                       true_residual=true_res, rung=tuple(rung_of),
                       attempts=attempts)
