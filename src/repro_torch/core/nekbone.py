"""Nekbone-equivalent problem setup: global operator, RHS, solve.

Composes the matrix-free pipeline of Algorithm 1 (scatter -> axhelm ->
gather) into a global SPD operator on unique dofs and runs PCG, mirroring
the Nekbone proxy app (Poisson with a Dirichlet mask, or Helmholtz, which
is SPD without masking).  Single device; the element-sharded solve, the
stacked-RHS solve and the mixed-precision solve are later slices.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no card and no explicit device they raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import axhelm as axhelm_mod
from repro_torch.core import gather_scatter as gs
from repro_torch.core.mesh_gen import BoxMesh
from repro_torch.core.pcg import PCGResult, pcg
from repro_torch.core.spectral import SpectralBasis, basis as make_basis

__all__ = ["NekboneProblem", "resolve_device", "setup_problem",
           "rhs_from_solution", "solve", "flop_count", "random_solution",
           "manufactured_error"]


class NekboneProblem(NamedTuple):
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


def _global_op(element_op, mesh: BoxMesh, mask, device):
    """A(x) = M Q^T A_e Q M x + (I - M) x  (M = Dirichlet zero-mask).

    The identity on masked dofs keeps the operator SPD on the full vector
    space so plain CG applies.  Accepts (Ng,) and (Ng, d): the component
    axis moves next to the element axis so the element kernel sees
    (E, d, N1^3) and shares its per-element geometry across components.
    """
    ids = torch.as_tensor(mesh.global_ids, dtype=torch.int64, device=device)
    ng = mesh.n_global

    def apply(x):
        x_in = x
        vector = x.ndim > 1
        if mask is not None:
            m = gs._expand_mask(mask, x)
            x = torch.where(m, torch.zeros((), dtype=x.dtype,
                                           device=x.device), x)
        xl = gs.scatter(x, ids)                        # (E, N1,N1,N1[, d])
        if vector:
            xl = torch.movedim(xl, -1, 1).contiguous()  # (E, d, N1,N1,N1)
        yl = element_op(xl)
        if vector:
            yl = torch.movedim(yl, 1, -1)
        y = gs.gather(yl, ids, ng)
        if mask is not None:
            y = torch.where(m, x_in, y)
        return y

    return apply


def _global_diag(mesh: BoxMesh, b: SpectralBasis, factors, lam0, lam1,
                 helmholtz: bool, d: int, mask, dtype, device) -> torch.Tensor:
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
    diag = gs.gather(dl, ids, mesh.n_global)
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
                  device=None) -> NekboneProblem:
    """Build the global operator + Jacobi diagonal for a mesh/variant.

    `backend` selects the element-kernel implementation ("reference",
    "cuda", or "auto"/None; see core.axhelm._resolve_backend) — with "cuda"
    every PCG iteration launches the hand-written axhelm kernel, and on a
    CUDA device "auto" is "cuda" (float32 only).  `device`
    defaults to the CUDA device (see :func:`resolve_device`).
    """
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
    apply = _global_op(op.apply, mesh, mask, device)
    diag = _global_diag(mesh, b, op.factors, lam0, lam1, helmholtz, d, mask,
                        dtype, device)
    return NekboneProblem(apply, diag, mask, mesh, b, d, helmholtz, variant,
                          op.backend, device)


def rhs_from_solution(problem: NekboneProblem,
                      x_true: torch.Tensor) -> torch.Tensor:
    """Manufactured RHS b = A x_true (x_true zeroed on the mask first)."""
    if problem.mask is not None:
        m = gs._expand_mask(problem.mask, x_true)
        x_true = torch.where(m, torch.zeros((), dtype=x_true.dtype,
                                            device=x_true.device), x_true)
    return problem.op(x_true)


def solve(problem: NekboneProblem, b_rhs: torch.Tensor,
          precond: str = "jacobi", tol: float = 1e-8, max_iter: int = 200,
          x0: Optional[torch.Tensor] = None,
          stagnation_window: int = 0) -> PCGResult:
    """Solve A x = b (PCG) for one right-hand side: `b_rhs` is (Ng,) for
    d=1 or (Ng, d) for vector problems.  The result's ``status`` reports
    WHY the solve stopped (a `resilience.status.SolveStatus` code)."""
    if precond not in ("jacobi", "copy"):
        raise ValueError(f"unknown preconditioner {precond!r}")
    base = 1 if problem.d == 1 else 2
    if b_rhs.ndim == base + 1:
        raise NotImplementedError(
            "stacked right-hand sides (block PCG) are not ported yet: see "
            "ROADMAP.md, Queue 1 item 9 (multi-RHS)")
    if b_rhs.ndim != base:
        raise ValueError(
            f"solve: b_rhs must be rank {base} for a d={problem.d} problem, "
            f"got shape {tuple(b_rhs.shape)}")
    pre = None
    if precond == "jacobi":
        inv_diag = 1.0 / problem.diag

        def pre(r):
            return inv_diag * r
    return pcg(problem.op, b_rhs, x0=x0, precond=pre, tol=tol,
               max_iter=max_iter, stagnation_window=stagnation_window)


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
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A standard-normal x_true on the problem's dofs, made with numpy from
    `seed` so every backend and device sees the same numbers."""
    shape = (problem.mesh.n_global,) if problem.d == 1 else \
        (problem.mesh.n_global, problem.d)
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                           device=problem.device)
