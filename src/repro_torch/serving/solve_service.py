"""Solve-as-a-service: bucketed, batched resilient solves behind a queue
(the reference's `serving.solve_service`).

Clients submit right-hand sides; the service packs up to `max_batch` of
them into ONE block-PCG solve (`core.pcg.pcg_block`: one operator
application per iteration for the whole block), runs it through
`resilience.retry.solve_resilient`, and hands every request back a
structured `SolveReport` — status, verified true residual and audit trail
travel with the answer (``report.x``).

- **No request pays a capture after warmup.**  Packed blocks are
  zero-padded up to a ladder of bucket widths and solved through a
  `serving.bucket_cache.BucketedSolveCache` of captured block solves —
  one CUDA graph per loop and width, captured by :meth:`SolveService.
  warmup` without solving, replayed for every later request pattern.
  Padded columns are bit-neutral and sliced off before any report is
  built; `trace_count` exposes the cache's counter for the
  zero-captures-after-warmup gate.
- **Requests are validated at the door.**  `submit` checks the RHS shape
  against the problem's dof layout and casts it to the problem's dtype on
  its device, so a malformed request is rejected at submit time instead
  of throwing mid-`step` and taking down its batch-mates.
- **A poisoned request cannot lose its batch.**  `step` pops requests
  only AFTER a successful solve; if the batched solve raises, each request
  re-runs alone and only the offending one is failed, with the exception
  recorded on ``request.error`` (``done`` is True either way).
- **Per-request latency.**  ``queue_s`` (submit -> solve start),
  ``solve_s`` (its share of the block solve, attributed by its own
  column's iteration count) and ``wall_s`` (their sum), from the host
  clock, read after a `synchronize()` on a card.

The batching policy is greedy FIFO and the loop is synchronous, as in the
reference.  A sharded problem is refused: serving over ranks is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import nekbone as _nek
from repro_torch.resilience.retry import (RetryPolicy, SolveReport,
                                          _default_rebuild, _rebuild_caller,
                                          has_precision_fallback,
                                          solve_resilient)
from repro_torch.resilience.status import SolveStatus
from repro_torch.serving.bucket_cache import BucketedSolveCache

__all__ = ["SolveRequest", "SolveService"]


@dataclasses.dataclass(eq=False)
class SolveRequest:
    """One RHS to solve: `b` is (Ng,) for d=1 problems, (Ng, d) otherwise
    (a tensor or an array; `submit` casts it to the problem's dtype on its
    device).

    After service, ``report`` holds THIS request's single-column
    `SolveReport` (length-1 per-column arrays; ``report.x`` has b's shape)
    and ``done`` is True even when the solve FAILED — check
    ``report.converged``.  A request whose solve RAISED has ``report is
    None`` and the exception summarized in ``error``.  ``queue_s``,
    ``solve_s`` and ``wall_s`` are filled by the service (``eq=False``:
    requests are identities; the queue compares them with ``is``).
    """

    uid: int
    b: object
    report: Optional[SolveReport] = None
    done: bool = False
    error: Optional[str] = None
    submitted_at: Optional[float] = None
    queue_s: Optional[float] = None
    solve_s: Optional[float] = None
    wall_s: Optional[float] = None


class SolveService:
    """Greedy-FIFO batching of resilient solves on one fixed problem.

    ``rebuild`` is forwarded to `solve_resilient` (problems with per-node
    lambda fields need it).  The bucket ladder is derived from
    ``max_batch``; call :meth:`warmup` once before serving (otherwise the
    first request of each bucket width pays the capture).
    """

    def __init__(self, problem, policy: Optional[RetryPolicy] = None,
                 max_batch: int = 4, precond: str = "jacobi",
                 tol: float = 1e-8, max_iter: int = 200,
                 rebuild: Optional[Callable] = None):
        if isinstance(problem, _nek.ShardedNekboneProblem):
            raise ValueError(
                "SolveService serves a single-device problem; serving a "
                "sharded problem over ranks is not ported yet")
        self.problem = problem
        self.policy = policy or RetryPolicy()
        self.max_batch = max_batch
        self.precond = precond
        self.tol = tol
        self.max_iter = max_iter
        self.rebuild = rebuild
        self.queue: List[SolveRequest] = []
        self.served = 0
        self.errors = 0
        self.cache = BucketedSolveCache(
            max_batch=max_batch, precond=precond, tol=tol,
            max_iter=max_iter,
            stagnation_window=self.policy.stagnation_window)
        self.cache.register(problem)
        # verification runs through the same bucket ladder: the clean
        # operator is re-applied per audit, at the block's bucket width
        self._verify_problem = problem._replace(
            op=self.cache.verify_op(problem))

    @property
    def trace_count(self) -> int:
        """Graphs captured (on the CPU: loops and operators built) so far,
        solvers and verification operators — what the
        zero-captures-after-warmup gate watches."""
        return self.cache.traces

    def _sync(self) -> None:
        if self.problem.device.type == "cuda":
            torch.cuda.synchronize(self.problem.device)

    def warmup(self) -> int:
        """Prepare the bucket ladder; returns the count it made.

        A problem that leans on reduced precision (a bf16 dtype, or a
        ``bf16_x32`` solve) also warms its precision:float32 fallback
        ladder: the resilience rung rebuilds the fp32 problem mid-request,
        and the rebuilt problem shares its cache key with the one warmed
        here (same mesh, backend and device, precision tag dropped), so
        rung-time rebuilds replay these graphs.
        """
        n = self.cache.warmup(self.problem)
        if self.policy.precision_fallback and \
                has_precision_fallback(self.problem):
            rb = _rebuild_caller(
                self.rebuild if self.rebuild is not None
                else _default_rebuild(self.problem, self.max_batch))
            fallback = rb(self.max_batch, dtype=torch.float32)
            n += self.cache.warmup(fallback)
        self._sync()
        return n

    def submit(self, req: SolveRequest):
        """Validate and enqueue one request: a wrong shape raises
        ValueError, a payload that does not cast to the problem's dtype
        TypeError — here, where only the offender is affected."""
        prob = self.problem
        base = 1 if prob.d == 1 else 2
        expect = (prob.mesh.n_global,) if base == 1 else \
            (prob.mesh.n_global, prob.d)
        shape = tuple(np.shape(req.b))
        if len(shape) != base:
            raise ValueError(
                f"SolveRequest.b must be a single rank-{base} RHS for a "
                f"d={prob.d} problem (the service does the batching), got "
                f"shape {shape}")
        if shape != expect:
            raise ValueError(
                f"SolveRequest.b has shape {shape} but this problem has "
                f"{prob.mesh.n_global} dofs"
                + ("" if base == 1 else f" x d={prob.d}")
                + f" — expected {expect}")
        try:
            req.b = torch.as_tensor(req.b, dtype=prob.diag.dtype,
                                    device=prob.device)
        except (TypeError, ValueError) as e:
            raise TypeError(
                f"SolveRequest.b does not cast to the problem dtype "
                f"{str(prob.diag.dtype).removeprefix('torch.')}: {e}") from e
        req.submitted_at = time.perf_counter()
        self.queue.append(req)

    def _solve_fn(self, prob, b, x0, fault):
        """Rung dispatch for `solve_resilient`: the bucketed cache on the
        clean path; a fault harness run goes through `nekbone.solve`,
        outside the cache (each fault spec wraps its own operator)."""
        if fault is not None:
            dt, dev = prob.diag.dtype, prob.device
            return _nek.solve(
                prob, torch.as_tensor(b, dtype=dt, device=dev),
                precond=self.precond, tol=self.tol, max_iter=self.max_iter,
                x0=None if x0 is None
                else torch.as_tensor(x0, dtype=dt, device=dev),
                stagnation_window=self.policy.stagnation_window, fault=fault)
        return self.cache.solve(prob, b, x0)

    def _serve(self, batch: List[SolveRequest]):
        """Solve one packed batch and distribute per-request reports.
        Does NOT touch the queue — popping is the caller's job, after
        success."""
        self._sync()
        t0 = time.perf_counter()
        b_blk = torch.stack([r.b for r in batch], dim=-1)
        rep = solve_resilient(self._verify_problem, b_blk, self.policy,
                              precond=self.precond, tol=self.tol,
                              max_iter=self.max_iter, rebuild=self.rebuild,
                              solve_fn=self._solve_fn)
        self._sync()
        block_wall = time.perf_counter() - t0
        # per-column early return: request j's solve latency is its own
        # column's convergence point (+1 for the initial-residual
        # application each column shares), not the block's completion
        iters = np.maximum(np.asarray(rep.iterations, np.int64), 0) + 1
        frac = iters / iters.max()
        for j, req in enumerate(batch):
            req.report = SolveReport(
                x=rep.x[..., j],
                converged=bool(rep.status[j] == SolveStatus.CONVERGED),
                status=rep.status[j:j + 1],
                iterations=rep.iterations[j:j + 1],
                residual=rep.residual[j:j + 1],
                true_residual=rep.true_residual[j:j + 1],
                rung=rep.rung[j:j + 1],
                # the audit trail is batch-global: attempts record which
                # columns they ran
                attempts=rep.attempts)
            req.error = None
            req.queue_s = t0 - req.submitted_at
            req.solve_s = block_wall * float(frac[j])
            req.wall_s = req.queue_s + req.solve_s
            req.done = True
        self.served += len(batch)

    def _fail(self, req: SolveRequest, exc: BaseException, t0: float):
        """A solve that RAISED (not a structured failure): record the
        exception on the offending request and return it, done."""
        self._sync()
        req.report = None
        req.error = f"{type(exc).__name__}: {exc}"
        req.queue_s = t0 - req.submitted_at
        req.solve_s = time.perf_counter() - t0
        req.wall_s = req.queue_s + req.solve_s
        req.done = True
        self.errors += 1

    def step(self) -> int:
        """Serve one batch of queued requests; returns #requests handled.

        Requests are popped AFTER a successful solve.  On a batch
        exception every member re-runs alone: the offending request(s)
        come back ``done`` with a structured ``error``, their batch-mates
        get their answers.
        """
        batch = list(self.queue[:self.max_batch])
        if not batch:
            return 0
        try:
            self._serve(batch)
        except Exception:
            # isolate the offender: one poisoned request must not take
            # down (or keep in the queue forever) its batch-mates
            for req in batch:
                t0 = time.perf_counter()
                try:
                    self._serve([req])
                except Exception as exc:
                    self._fail(req, exc, t0)
                self.queue = [r for r in self.queue if r is not req]
            return len(batch)
        del self.queue[:len(batch)]
        return len(batch)

    def run_until_drained(self, max_steps: int = 100) -> int:
        """Serve batches until the queue is empty (or `max_steps` spent);
        returns the number of steps taken."""
        steps = 0
        while self.queue and steps < max_steps:
            self.step()
            steps += 1
        return steps
