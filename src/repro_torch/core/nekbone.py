"""Nekbone-equivalent problem setup: global operator, RHS, solve.

Composes the matrix-free pipeline of Algorithm 1 (scatter -> axhelm ->
gather) into a global SPD operator on unique dofs and runs PCG, mirroring
the Nekbone proxy app (Poisson with a Dirichlet mask, or Helmholtz, which
is SPD without masking).  Single device: one right-hand side or a stack of
them (block PCG), in float32 or in the mixed-precision ``bf16_x32`` mode
(float32 outer refinement around bfloat16 inner sweeps).  The PCG loops
run on the card as replayed CUDA graphs, kept per problem
(`NekboneProblem.graphs`, see `core.graphs`); `make_block_solver` is the
reference's nrhs-polymorphic entry that captures once per RHS width.  The
element-sharded solve is a later slice.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no card and no explicit device they raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import axhelm as axhelm_mod
from repro_torch.core import gather_scatter as gs
from repro_torch.core.graphs import GraphCache
from repro_torch.core.mesh_gen import BoxMesh
from repro_torch.core.pcg import PCGResult, pcg, pcg_block, refine
from repro_torch.core.spectral import SpectralBasis, basis as make_basis
from repro_torch.resilience import inject

__all__ = ["NekboneProblem", "PRECISIONS", "resolve_device", "setup_problem",
           "rhs_from_solution", "solve", "make_block_solver", "flop_count",
           "random_solution", "random_rhs", "manufactured_error"]

PRECISIONS = (None, "bf16_x32")


class NekboneProblem(NamedTuple):
    """`op`/`diag` are always at the problem's dtype; with
    ``precision="bf16_x32"`` the bfloat16 operator of the inner refinement
    sweeps is the extra ``op_lo``.  ``graphs`` keeps the problem's solver
    loops and their CUDA graphs between solves (shared by `_replace`d
    copies, whose other operators get loops of their own)."""

    op: object                     # callable global operator A(x)
    diag: torch.Tensor             # diag(A) on global dofs (for Jacobi)
    mask: Optional[torch.Tensor]   # Dirichlet mask (None => no mask)
    mesh: BoxMesh
    basis: SpectralBasis
    d: int
    helmholtz: bool
    variant: str
    backend: str = "reference"
    device: torch.device = torch.device("cpu")
    precision: Optional[str] = None  # None (plain) or "bf16_x32"
    op_lo: object = None             # bf16 operator for the inner sweeps
    graphs: Optional[GraphCache] = None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA device unless the caller
    names another.  Raises when no card is there to run on — never falls
    back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device "
                           f"is available")
    return device


def _global_op(element_op, mesh: BoxMesh, mask, device,
               plan: gs.GatherPlan):
    """A(x) = M Q^T A_e Q M x + (I - M) x  (M = Dirichlet zero-mask).

    The identity on masked dofs keeps the operator SPD on the full vector
    space so plain CG applies.  Accepts (Ng,), (Ng, d) and the stacked
    (Ng, nrhs) and (Ng, d, nrhs): every axis after the dof axis is
    flattened into c = d*nrhs columns, which move next to the element axis
    so the element kernel sees (E, c, N1^3) and shares its per-element
    geometry across all of them; the layout is restored on exit.  The
    gather sums in `plan`'s fixed order.
    """
    ids = torch.as_tensor(mesh.global_ids, dtype=torch.int64, device=device)
    ng = mesh.n_global

    def apply(x):
        x_in = x
        bshape = tuple(x.shape[1:])
        if mask is not None:
            m = gs._expand_mask(mask, x)
            x = torch.where(m, torch.zeros((), dtype=x.dtype,
                                           device=x.device), x)
        if bshape:
            xl = gs.scatter_columns(x.reshape(ng, -1), ids)  # (E, c, N1^3)
            y = gs.gather_columns(element_op(xl), plan).reshape(
                (ng,) + bshape)
        else:
            y = gs.gather(element_op(gs.scatter(x, ids)), ids, ng, plan)
        if mask is not None:
            y = torch.where(m, x_in, y)
        return y

    return apply


def _global_diag(mesh: BoxMesh, b: SpectralBasis, factors, lam0, lam1,
                 helmholtz: bool, d: int, mask, dtype, device,
                 plan: gs.GatherPlan) -> torch.Tensor:
    """Jacobi diagonal on global dofs from per-element factor arrays."""
    node_shape = (len(mesh.verts),) + (b.n1,) * 3
    lam0n = None if lam0 is None else torch.as_tensor(
        lam0, dtype=dtype, device=device).expand(node_shape)
    lam1n = None if lam1 is None else torch.as_tensor(
        lam1, dtype=dtype, device=device).expand(node_shape)
    dl = axhelm_mod.element_diagonal(
        factors, torch.as_tensor(b.dhat, dtype=dtype, device=device),
        lam0=lam0n, lam1=lam1n, helmholtz=helmholtz)
    ids = torch.as_tensor(mesh.global_ids, dtype=torch.int64, device=device)
    diag = gs.gather(dl, ids, mesh.n_global, plan)
    if d > 1:
        diag = diag[:, None].expand(mesh.n_global, d)
    if mask is not None:
        m = mask if d == 1 else mask[:, None]
        diag = torch.where(m, torch.ones((), dtype=dtype, device=device),
                           diag)
    return diag


def setup_problem(mesh: BoxMesh, variant: str = "precomputed", d: int = 1,
                  helmholtz: bool = False, lam0=None, lam1=None,
                  dirichlet: bool | None = None,
                  dtype: torch.dtype = torch.float32,
                  backend: str | None = None,
                  device=None,
                  nrhs: int | None = None,
                  precision: str | None = None) -> NekboneProblem:
    """Build the global operator + Jacobi diagonal for a mesh/variant.

    `variant` is any of `core.axhelm.VARIANTS`; merged is Helmholtz only
    and partial Poisson only, and the other equation raises the reference
    package's ValueError.  The Jacobi diagonal comes from the operator's
    own factors (`AxhelmOp.factors`).

    `backend` selects the element-kernel implementation ("reference",
    "cuda", or "auto"/None; see core.axhelm._resolve_backend) — with "cuda"
    every PCG iteration launches the hand-written axhelm kernel, and on a
    CUDA device "auto" is "cuda" (float32 or bfloat16 storage).  `device`
    defaults to the CUDA device (see :func:`resolve_device`).

    `nrhs` declares the RHS-batch width of later `solve` calls, as in the
    reference; the operator takes any width, and the port has no block
    size to tune for it, so nothing else depends on it.

    `precision="bf16_x32"` builds the mixed-precision solve: `op`/`diag`
    stay float32 (`dtype` must be float32, the outer precision) and a
    second, bfloat16 operator over the same mesh and coefficients becomes
    `op_lo` — vertices rounded fp64 -> fp32 -> bf16 and lambdas rounded to
    bf16, as the reference rounds them.  `solve` then runs
    `core.pcg.refine`.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one "
                         f"of {PRECISIONS}")
    if precision == "bf16_x32" and dtype != torch.float32:
        raise ValueError(
            f"precision='bf16_x32' keeps the outer solve in float32 (the "
            f"bf16 operator is the separate inner machinery); pass "
            f"dtype=torch.float32, got {str(dtype).removeprefix('torch.')}")
    if nrhs is not None and (int(nrhs) != nrhs or nrhs < 1):
        raise ValueError(f"nrhs must be a positive integer, got {nrhs!r}")
    device = resolve_device(device)
    b = make_basis(mesh.order)
    verts = torch.as_tensor(mesh.verts, dtype=dtype, device=device)
    if helmholtz and lam1 is None:
        lam1 = 0.1   # Nekbone's h2-like shift
    if helmholtz and lam0 is None:
        lam0 = 1.0
    if dirichlet is None:
        dirichlet = not helmholtz  # Poisson needs the mask to be SPD
    mask = torch.as_tensor(mesh.boundary, device=device) if dirichlet else None
    op = axhelm_mod.make_axhelm(variant, b, verts, lam0=lam0, lam1=lam1,
                                helmholtz=helmholtz, dtype=dtype,
                                backend=backend, device=device)
    plan = gs.gather_plan(mesh.global_ids, mesh.n_global, device)
    apply = _global_op(op.apply, mesh, mask, device, plan)
    diag = _global_diag(mesh, b, op.factors, lam0, lam1, helmholtz, d, mask,
                        dtype, device, plan)
    op_lo_apply = None
    if precision == "bf16_x32":
        op_lo = axhelm_mod.make_axhelm(variant, b, verts, lam0=lam0,
                                       lam1=lam1, helmholtz=helmholtz,
                                       dtype=torch.bfloat16, backend=backend,
                                       device=device)
        op_lo_apply = _global_op(op_lo.apply, mesh, mask, device, plan)
    return NekboneProblem(apply, diag, mask, mesh, b, d, helmholtz, variant,
                          op.backend, device, precision, op_lo_apply,
                          GraphCache())


def rhs_from_solution(problem: NekboneProblem,
                      x_true: torch.Tensor) -> torch.Tensor:
    """Manufactured RHS b = A x_true (x_true zeroed on the mask first).

    `x_true` may carry a trailing RHS-batch axis — (Ng, nrhs) or
    (Ng, d, nrhs) — giving a stacked RHS for the block solve."""
    if problem.mask is not None:
        m = gs._expand_mask(problem.mask, x_true)
        x_true = torch.where(m, torch.zeros((), dtype=x_true.dtype,
                                            device=x_true.device), x_true)
    return problem.op(x_true)


def solve(problem: NekboneProblem, b_rhs: torch.Tensor,
          precond: str = "jacobi", tol: float = 1e-8, max_iter: int = 200,
          x0: Optional[torch.Tensor] = None,
          stagnation_window: int = 0, fault=None,
          capture: Optional[bool] = None) -> PCGResult:
    """Solve A x = b (PCG).

    `b_rhs` is (Ng,) for d=1 or (Ng, d) for vector problems; one extra
    trailing axis stacks nrhs right-hand sides — (Ng, nrhs) / (Ng, d, nrhs)
    — solved together by block PCG (`core.pcg.pcg_block`): one operator
    application for the whole block per iteration, per-column convergence,
    and per-column iterations, residuals and statuses in the result.  A
    trailing axis of size 1 takes the single-RHS path, so that degenerate
    batch gives exactly the unbatched result.  A ``bf16_x32`` problem runs
    `core.pcg.refine` with the bfloat16 operator `op_lo` and a bfloat16
    Jacobi preconditioner for the inner sweeps, `stagnation_window` (or 5)
    as their window.  The result's ``status`` reports WHY each solve or
    column stopped (a `resilience.status.SolveStatus` code).

    `x0` warm-starts the iteration.  `fault` (a
    `resilience.inject.FaultSpec`) corrupts one operator application inside
    the loop — of `op_lo` on a ``bf16_x32`` problem, where it recurs every
    sweep; the test harness of `resilience`, None in production.  On a card
    the loops run as CUDA graphs kept in ``problem.graphs``, so a repeat
    solve of the same shape captures nothing; ``capture=False`` runs them
    eagerly, for comparisons."""
    if precond not in ("jacobi", "copy"):
        raise ValueError(f"unknown preconditioner {precond!r}")
    base = 1 if problem.d == 1 else 2
    if b_rhs.ndim not in (base, base + 1):
        raise ValueError(
            f"solve: b_rhs must be rank {base} (single RHS) or {base + 1} "
            f"(stacked RHS) for a d={problem.d} problem, got shape "
            f"{tuple(b_rhs.shape)}")
    batched = b_rhs.ndim == base + 1
    if batched and b_rhs.shape[-1] == 1:
        res = solve(problem, b_rhs[..., 0], precond=precond, tol=tol,
                    max_iter=max_iter,
                    x0=None if x0 is None else x0[..., 0],
                    stagnation_window=stagnation_window, fault=fault,
                    capture=capture)
        return PCGResult(res.x[..., None], res.iterations[None],
                         res.residual[None], res.initial_residual[None],
                         res.breakdown[None], res.status[None])
    refined = problem.precision == "bf16_x32"
    # the functions a solve makes from the problem are memoized with its
    # loops, so that a repeat solve finds the loop (and graph) it captured
    graphs = problem.graphs if problem.graphs is not None else GraphCache()
    pre = None
    if precond == "jacobi":
        # keyed by the diagonal's id; the memo holds the diagonal, so the
        # id stays its own
        _, pre = graphs.memo(
            ("jacobi", id(problem.diag), refined, batched),
            lambda: (problem.diag, _jacobi(problem.diag, refined, batched)))
    op = problem.op_lo if refined else problem.op
    if fault is not None:
        op = graphs.memo(("fault", op, fault), lambda: inject.wrap_operator(
            op, fault, problem.mesh.global_ids))
    if refined:
        return refine(problem.op, op, b_rhs, x0=x0, precond=pre,
                      tol=tol, max_iter=max_iter, batched=batched,
                      inner_window=stagnation_window or 5, graphs=graphs,
                      capture=capture)
    runner = pcg_block if batched else pcg
    return runner(op, b_rhs, x0=x0, precond=pre, tol=tol,
                  max_iter=max_iter, stagnation_window=stagnation_window,
                  graphs=graphs, capture=capture)


def _jacobi(diag: torch.Tensor, refined: bool, batched: bool):
    """The Jacobi preconditioner r -> r / diag(A), in bfloat16 for the
    inner sweeps of a ``bf16_x32`` solve."""
    inv_diag = 1.0 / diag
    if refined:
        inv_diag = inv_diag.to(torch.bfloat16)
    if batched:
        inv_diag = inv_diag[..., None]

    def pre(r):
        return inv_diag * r

    return pre


def make_block_solver(problem: NekboneProblem, *, precond: str = "jacobi",
                      tol: float = 1e-8, max_iter: int = 200,
                      stagnation_window: int = 0, on_capture=None):
    """An nrhs-polymorphic solve entry for padded RHS blocks, the
    reference's `make_block_solver`.

    Returns ``solve_block(b_blk, x0_blk) -> PCGResult`` with the solver's
    settings closed over.  Each RHS width gets its loop, and on a card its
    CUDA graph, once, in ``problem.graphs``; every later call of that width
    replays it.  `x0_blk` is required (zeros for a cold start, which the
    loop treats as ``x0=None``).  A zero-padded column converges at
    iteration 0 and block PCG's freeze keeps it from perturbing live
    columns, so callers may pad a block to a bucket width.

    ``on_capture(shape)``, if given, is called with the block's shape when
    a call captured a graph — on the CPU, where nothing is captured, when
    it built a width's loop — and never on a call that replays: the
    counterpart of the reference's ``on_trace``.
    """
    if problem.graphs is None:
        problem = problem._replace(graphs=GraphCache())
    graphs = problem.graphs

    def made():
        return graphs.captures if problem.device.type == "cuda" \
            else graphs.builds

    def solve_block(b_blk: torch.Tensor, x0_blk: torch.Tensor) -> PCGResult:
        before = made()
        res = solve(problem, b_blk, precond=precond, tol=tol,
                    max_iter=max_iter, x0=x0_blk,
                    stagnation_window=stagnation_window)
        if on_capture is not None and made() > before:
            on_capture(tuple(b_blk.shape))
        return res

    return solve_block


def flop_count(mesh: BoxMesh, d: int, helmholtz: bool, iterations: int) -> float:
    """Nekbone-style useful-FLOP count for GFLOPS reporting (Table 6).

    Per CG iteration: one axhelm (F_ax per element) + vector ops
    (~7 flops/dof: 2 dots, 3 axpy-likes with fused mul-add counted as 2).
    """
    n1 = mesh.order + 1
    e = len(mesh.verts)
    is_helm = 1 if helmholtz else 0
    f_ax = d * (12.0 * n1**4 + (15.0 + 5.0 * is_helm) * n1**3) * e
    f_vec = 7.0 * mesh.n_global * d
    return (f_ax + f_vec) * iterations


def manufactured_error(problem: NekboneProblem, x: torch.Tensor,
                       x_true: torch.Tensor) -> float:
    """Relative error of a solve against its manufactured solution (the
    solution is zero on Dirichlet dofs)."""
    ref = x_true
    if problem.mask is not None:
        ref = torch.where(gs._expand_mask(problem.mask, x_true),
                          torch.zeros((), dtype=x_true.dtype,
                                      device=x_true.device), x_true)
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def random_solution(problem: NekboneProblem, seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    nrhs: int = 1) -> torch.Tensor:
    """A standard-normal x_true on the problem's dofs, made with numpy from
    `seed` so every backend and device sees the same numbers; with
    ``nrhs > 1`` a stack of them on a trailing axis."""
    shape = (problem.mesh.n_global,) if problem.d == 1 else \
        (problem.mesh.n_global, problem.d)
    if nrhs > 1:
        shape = shape + (nrhs,)
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                           device=problem.device)


def random_rhs(problem: NekboneProblem, nrhs: int = 1) -> torch.Tensor:
    """The right-hand side of the reference's precision benchmark
    (`benchmarks/bench_nekbone.py::precision_rows`): standard normal in
    float32 from numpy seed 0, zero on the mesh's Dirichlet boundary (also
    for an unmasked problem), each right-hand side scaled to 2-norm 30; with
    ``nrhs > 1`` a stack of them on a trailing axis."""
    shape = (problem.mesh.n_global,) if problem.d == 1 else \
        (problem.mesh.n_global, problem.d)
    if nrhs > 1:
        shape = shape + (nrhs,)
    b = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    b[np.asarray(problem.mesh.boundary)] = 0.0
    axes = 0 if problem.d == 1 else (0, 1)
    b = b / np.linalg.norm(b, axis=axes) * 30.0
    return torch.as_tensor(b, device=problem.device)
