"""Bucketed cache of captured block solves (the reference's
`serving.bucket_cache`).

The serving problem: stacking queued right-hand sides makes the queue
depth a SHAPE, and the port captures one CUDA graph per loop shape
(`core.graphs`), so a greedy batcher would pay a fresh capture on nearly
every request pattern.  The fix is the reference's: quantize the batch
axis to a small ladder of bucket widths (powers of two up to
``max_batch``), zero-pad every packed block up to its bucket, and keep one
block solver (`core.nekbone.make_block_solver`) per bucket.  `warmup`
prepares every width of the ladder without solving
(``solve_block.prepare``), so after it no request pattern captures
anything — machine-checked by the ``traces`` counter this module carries.

Padding is bit-neutral and invisible to callers: a zero RHS column has
``r0 = 0``, converges at iteration 0, and block PCG's freeze keeps it out
of the live columns; every per-column operation of the block solve gives
column j the same bits whatever the block's width and the other columns
hold (`core.pcg._column_dot`), so a padded block's real columns are
bitwise the unpadded block's.  `solve` slices the padded columns off
before returning; they never reach a caller.

Cache entries are keyed by ``(mesh-id, equation, variant, d, backend,
precision-or-dtype, device, nrhs-bucket)`` — everything that selects a
distinct captured computation for a fixed (tol, max_iter, precond) cache.
The rebuilt problems of `resilience.retry.solve_resilient`'s fallback rungs
key their own entries, and a failed-column subset solve re-enters through
the same ladder (a 3-of-8 retry pads to bucket 4), so retries replay warm
graphs too.  Per-node lambda fields are not part of the key; a service
serving several field-coefficient problems on one mesh needs one cache
per problem.
"""

from __future__ import annotations

import torch

from repro_torch.core import nekbone as _nek
from repro_torch.core.graphs import GraphCache
from repro_torch.core.pcg import PCGResult

__all__ = ["bucket_sizes", "problem_key", "BucketedSolveCache"]


def bucket_sizes(max_batch: int) -> tuple:
    """The bucket ladder: powers of two up to ``max_batch``, plus
    ``max_batch`` itself when it is not a power of two (so a full queue
    never pads past the service's own batch cap)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def problem_key(problem) -> tuple:
    """The bucket-free part of a problem's cache key.

    ``id(mesh)`` is the in-process mesh identity: the fallback rungs
    rebuild around the same mesh object, so their entries share it while
    differing in backend or dtype exactly as their loops do.  The
    precision tag, not just the dtype, keeps a ``bf16_x32`` problem apart
    from the float32 build its precision:float32 rung rebuilds (both have
    a float32 diagonal), and the device keeps a CPU build apart from a
    CUDA build on one mesh.
    """
    return (id(problem.mesh), "helmholtz" if problem.helmholtz else
            "poisson", problem.variant, problem.d, problem.backend,
            problem.precision
            or str(problem.diag.dtype).removeprefix("torch."),
            str(problem.device))


def _pad_cols(x: torch.Tensor, pad: int) -> torch.Tensor:
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)


class _CapturedOp:
    """`op` on one fixed input and output tensor, captured once as a CUDA
    graph in `graphs` (its warm-up and capture apply `op` to zeros) and
    replayed for every call."""

    def __init__(self, op, x: torch.Tensor, graphs: GraphCache) -> None:
        self.op = op
        self.x = torch.zeros_like(x)
        self.y = None
        self.graphs = graphs
        self.graph = graphs.capture(self._apply)

    def _apply(self) -> None:
        self.y = self.op(self.x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.x.copy_(x)
        self.graphs.replay(self.graph)
        return self.y.clone()


class BucketedSolveCache:
    """One captured block solver per (problem-key, nrhs-bucket).

    ``traces`` counts what the cache makes — on a card the CUDA graphs it
    captures, on the CPU (where nothing is captured) the loops it builds —
    for solvers and verification operators alike; the serving gate asserts
    it stays flat across a warm request stream (the name is the
    reference's, whose cache counts jit traces).  The solver knobs
    (precond, tol, max_iter, stagnation_window) are fixed per cache, as in
    the reference.
    """

    def __init__(self, *, max_batch: int, precond: str = "jacobi",
                 tol: float = 1e-8, max_iter: int = 200,
                 stagnation_window: int = 0):
        self.buckets = bucket_sizes(max_batch)
        self.precond = precond
        self.tol = tol
        self.max_iter = max_iter
        self.stagnation_window = stagnation_window
        self.traces = 0
        self._solvers = {}    # problem_key + (bucket,) -> block solver
        self._verify = {}     # problem_key + (bucket,) -> clean operator
        self._pristine = {}   # problem_key -> first-registered problem

    def register(self, problem) -> tuple:
        """Pin `problem` as the canonical build for its key: cache-made
        solvers and verification operators close over it, not over the
        op-wrapped clone the service verifies through (same key).  The
        pinned copy gets a graph cache of its own, so the loops and graphs
        this cache makes — and counts — are its own, whatever else solved
        the same problem (the reference's caches each hold their own
        jits)."""
        key = problem_key(problem)
        if key not in self._pristine:
            self._pristine[key] = problem._replace(graphs=GraphCache())
        return key

    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket >= n (n itself beyond the ladder: an
        oversized block solves unbucketed, paying its own capture)."""
        for b in self.buckets:
            if b >= n:
                return b
        return n

    def _count(self, _shape):
        self.traces += 1

    def _solver(self, problem, bucket: int):
        key = self.register(problem) + (bucket,)
        fn = self._solvers.get(key)
        if fn is None:
            fn = _nek.make_block_solver(
                self._pristine[key[:-1]], precond=self.precond,
                tol=self.tol, max_iter=self.max_iter,
                stagnation_window=self.stagnation_window,
                on_capture=self._count)
            self._solvers[key] = fn
        return fn

    def solve(self, problem, b, x0=None) -> PCGResult:
        """Solve through the bucket ladder; pads up, slices back.

        `b` is a stacked block (trailing RHS axis) or a single RHS, a
        tensor or an array; the result has `core.nekbone.solve`'s shapes
        for the UNPADDED input — padded columns never leave this method.
        """
        dtype, dev = problem.diag.dtype, problem.device
        b = torch.as_tensor(b, dtype=dtype, device=dev)
        if x0 is not None:
            x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
        base = 1 if problem.d == 1 else 2
        squeeze = b.ndim == base
        if squeeze:
            b = b[..., None]
            x0 = None if x0 is None else x0[..., None]
        k = b.shape[-1]
        pad = self.bucket_for(k) - k
        bp = _pad_cols(b, pad)
        x0p = torch.zeros_like(bp) if x0 is None else _pad_cols(x0, pad)
        res = self._solver(problem, bp.shape[-1])(bp, x0p)
        res = PCGResult(res.x[..., :k], res.iterations[:k],
                        res.residual[:k], res.initial_residual[:k],
                        res.breakdown[:k], res.status[:k])
        if squeeze:
            res = PCGResult(res.x[..., 0], res.iterations[0],
                            res.residual[0], res.initial_residual[0],
                            res.breakdown[0], res.status[0])
        return res

    def verify_op(self, problem):
        """A bucket-shaped clean operator for true-residual verification.

        `resilience.retry.solve_resilient` re-applies ``problem.op`` to
        every candidate answer.  This wrapper pads the column axis up to
        the block's bucket and applies one entry per (key, bucket): on a
        card the clean operator captured as a CUDA graph on fixed tensors
        of that shape (`_CapturedOp`), on the CPU the operator itself —
        made once and counted in ``traces``, and warmed with the solver
        ladder, so verification captures nothing on the serving path.
        """
        key = self.register(problem)
        base = 1 if problem.d == 1 else 2

        def raw(x):
            entry = self._verify.get(key + (x.shape[-1],))
            if entry is None:
                entry = self._make_verify(self._pristine[key], x)
                self._verify[key + (x.shape[-1],)] = entry
            return entry(x)

        def apply(x):
            if x.ndim == base:
                return raw(x[..., None])[..., 0]
            k = x.shape[-1]
            return raw(_pad_cols(x, self.bucket_for(k) - k))[..., :k]

        return apply

    def _make_verify(self, prob, x: torch.Tensor):
        self._count(tuple(x.shape))
        if prob.device.type != "cuda":
            return prob.op
        return _CapturedOp(prob.op, x, prob.graphs)

    def warmup(self, problem) -> int:
        """Prepare the whole bucket ladder — each width's solver loops
        (``solve_block.prepare``: built, and on a card captured, without
        solving) and its verification operator — and return the count of
        what it made (2 per bucket for a fresh key)."""
        before = self.traces
        vop = self.verify_op(problem)
        field = (problem.mesh.n_global,) if problem.d == 1 else \
            (problem.mesh.n_global, problem.d)
        for bucket in self.buckets:
            shape = field + (bucket,)
            self._solver(problem, bucket).prepare(shape)
            vop(torch.zeros(shape, dtype=problem.diag.dtype,
                            device=problem.device))
        return self.traces - before
