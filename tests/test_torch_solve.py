"""Port parity, the solve: gather/scatter, the Jacobi diagonal, PCG and the
single-device Nekbone solve of `repro_torch` against the JAX reference, on
the CPU, from the same numpy inputs.

Tolerances, each with its reason:
  * gather/scatter and the diagonals in float64: <= 1e-12 relative (same
    sums, other order);
  * solves in float32: iterations within +-1 of the reference package's
    `backend="reference"` solve with the same `SolveStatus`, and x within
    1e-4 relative (fp32 rounding drifts the two iterations apart slowly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import axhelm as jax_axhelm
from repro.core import gather_scatter as jgs
from repro.core import mesh_gen as jmesh
from repro.core import nekbone as jnek
from repro.core.pcg import pcg as jpcg
from repro.core.spectral import basis as jbasis
from repro_torch import convert
from repro_torch.core import axhelm as taxhelm
from repro_torch.core import gather_scatter as tgs
from repro_torch.core import nekbone as tnek
from repro_torch.core.pcg import pcg as tpcg
from repro_torch.core.spectral import basis as tbasis
from repro_torch.resilience.status import SolveStatus

RTOL64 = 1e-12
RTOL32 = 1e-4
CPU = torch.device("cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _mesh(shape=(2, 2, 2), order=3):
    return jmesh.deform_trilinear(jmesh.box_mesh(*shape, order), seed=3)


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_gather_scatter_match_reference(x64, trailing):
    mesh = _mesh()
    rng = np.random.default_rng(1)
    ids_j = jnp.asarray(mesh.global_ids)
    ids_t = torch.as_tensor(mesh.global_ids, dtype=torch.int64)
    xg = rng.standard_normal((mesh.n_global,) + trailing)
    yl = rng.standard_normal(mesh.global_ids.shape + trailing)
    assert _rel(tgs.scatter(torch.as_tensor(xg), ids_t),
                jgs.scatter(jnp.asarray(xg), ids_j)) == 0.0
    assert _rel(tgs.gather(torch.as_tensor(yl), ids_t, mesh.n_global),
                jgs.gather(jnp.asarray(yl), ids_j, mesh.n_global)) <= RTOL64
    assert _rel(tgs.dssum(torch.as_tensor(yl), ids_t, mesh.n_global),
                jgs.dssum(jnp.asarray(yl), ids_j, mesh.n_global)) <= RTOL64
    assert _rel(tgs.multiplicity(ids_t, mesh.n_global),
                jgs.multiplicity(ids_j, mesh.n_global)) == 0.0


def test_gather_rejects_the_reference_packages_bad_shapes():
    mesh = _mesh()
    ids = torch.as_tensor(mesh.global_ids, dtype=torch.int64)
    with pytest.raises(ValueError, match="does not match"):
        tgs.gather(torch.zeros(3, 4, 4, 4), ids, mesh.n_global)
    with pytest.raises(ValueError, match="trailing"):
        tgs.gather(torch.zeros(mesh.global_ids.shape + (2, 3)), ids,
                   mesh.n_global)


def test_gather_is_deterministic_on_cpu():
    """On the CPU `index_add_` adds in index order: repeated gathers are
    bitwise identical.  (On CUDA it adds with atomics; see
    tests/test_torch_cuda.py.)"""
    mesh = _mesh((3, 3, 3))
    ids = torch.as_tensor(mesh.global_ids, dtype=torch.int64)
    yl = torch.as_tensor(np.random.default_rng(2).standard_normal(
        mesh.global_ids.shape), dtype=torch.float32)
    first = tgs.gather(yl, ids, mesh.n_global)
    for _ in range(3):
        assert torch.equal(tgs.gather(yl, ids, mesh.n_global), first)


@pytest.mark.parametrize("variant", ["precomputed", "trilinear"])
@pytest.mark.parametrize("helm,d", [(False, 1), (True, 1), (True, 3)])
def test_diagonals_match_reference(x64, variant, helm, d):
    """element_diagonal and the masked global Jacobi diagonal, with a
    per-node lam0 field inside the contraction."""
    mesh = _mesh()
    jb, tb = jbasis(3), tbasis(3)
    rng = np.random.default_rng(3)
    lam0 = 1 + 0.3 * rng.random(mesh.global_ids.shape)
    lam1 = 0.1 if helm else None
    jop = jax_axhelm.make_axhelm(variant, jb, jnp.asarray(mesh.verts),
                                 lam0=jnp.asarray(lam0), lam1=lam1,
                                 helmholtz=helm, dtype=jnp.float64)
    top = taxhelm.make_axhelm(variant, tb, mesh.verts,
                              lam0=torch.as_tensor(lam0), lam1=lam1,
                              helmholtz=helm, dtype=torch.float64)
    assert _rel(taxhelm.element_diagonal(
        top.factors, torch.as_tensor(tb.dhat), torch.as_tensor(lam0), lam1,
        helm), jax_axhelm.element_diagonal(
        jop.factors, jnp.asarray(jb.dhat), jnp.asarray(lam0), lam1,
        helm)) <= RTOL64
    mask = None if helm else mesh.boundary
    jd = jnek._global_diag(mesh, jb, jop.factors, jnp.asarray(lam0), lam1,
                           helm, d, None if mask is None
                           else jnp.asarray(mask), jnp.float64)
    td = tnek._global_diag(convert.mesh_from_numpy(mesh), tb, top.factors,
                           torch.as_tensor(lam0), lam1, helm, d,
                           None if mask is None else torch.as_tensor(mask),
                           torch.float64, CPU)
    assert _rel(td, jd) <= RTOL64


def _jax_solve(mesh, variant, helm, x_true, tol, max_iter):
    prob = jnek.setup_problem(mesh, variant=variant, helmholtz=helm,
                              dtype=jnp.float32, backend="reference")
    b = jnek.rhs_from_solution(prob, jnp.asarray(x_true, jnp.float32))
    return jnek.solve(prob, b, tol=tol, max_iter=max_iter)


def _carried_problem(mesh, variant, helm):
    """A port problem whose element operator runs on the reference
    package's setup products (kernel operands), carried across with
    `convert` — the port's own setup is not used for the element data."""
    jb, tb = jbasis(mesh.order), tbasis(mesh.order)
    lam0, lam1 = (1.0, 0.1) if helm else (None, None)
    j_ops, _, _ = jax_axhelm.make_axhelm_elem_ops(
        variant, jb, jnp.asarray(mesh.verts, jnp.float32), lam0=lam0,
        lam1=lam1, helmholtz=helm, dtype=jnp.float32, backend="pallas")
    carried = convert.elem_ops_from_numpy(
        variant, {k: np.asarray(v) for k, v in j_ops.items()}, CPU)
    tmesh = convert.mesh_from_numpy(mesh)
    verts = torch.as_tensor(tmesh.verts, dtype=torch.float32)
    _, t_apply, backend = taxhelm.make_axhelm_elem_ops(
        variant, tb, verts, lam0=lam0, lam1=lam1, helmholtz=helm,
        dtype=torch.float32, backend="cuda", device=CPU)
    factors = taxhelm._setup_factors(variant, tb, verts, carried)
    mask = None if helm else torch.as_tensor(tmesh.boundary)
    op = tnek._global_op(lambda x: t_apply(x, carried), tmesh, mask, CPU)
    diag = tnek._global_diag(tmesh, tb, factors, lam0, lam1, helm, 1, mask,
                             torch.float32, CPU)
    return tnek.NekboneProblem(op, diag, mask, tmesh, tb, 1, helm, variant,
                               backend, CPU)


@pytest.mark.parametrize("setup", ["port", "carried"])
@pytest.mark.parametrize("variant", ["precomputed", "trilinear"])
@pytest.mark.parametrize("shape,helm", [((2, 2, 2), False),
                                        ((3, 3, 3), False),
                                        ((2, 2, 2), True)])
def test_solve_matches_reference(shape, helm, variant, setup):
    mesh = _mesh(shape)
    x_true = np.random.default_rng(4).standard_normal(mesh.n_global)
    tol, max_iter = 1e-6, 400
    jres = _jax_solve(mesh, variant, helm, x_true, tol, max_iter)
    if setup == "port":
        prob = tnek.setup_problem(convert.mesh_from_numpy(mesh),
                                  variant=variant, helmholtz=helm,
                                  backend="reference", device="cpu")
    else:
        prob = _carried_problem(mesh, variant, helm)
    b = tnek.rhs_from_solution(prob, torch.as_tensor(x_true,
                                                     dtype=torch.float32))
    tres = tnek.solve(prob, b, tol=tol, max_iter=max_iter)
    assert int(tres.status) == int(jres.status) == SolveStatus.CONVERGED
    assert abs(int(tres.iterations) - int(jres.iterations)) <= 1
    assert _rel(tres.x, jres.x) <= RTOL32
    err = tnek.manufactured_error(prob, tres.x, torch.as_tensor(
        x_true, dtype=torch.float32))
    assert err < 1e-4


def test_solve_maxiter_matches_reference():
    mesh = _mesh((3, 3, 3))
    x_true = np.random.default_rng(5).standard_normal(mesh.n_global)
    jres = _jax_solve(mesh, "trilinear", False, x_true, 1e-8, 7)
    prob = tnek.setup_problem(convert.mesh_from_numpy(mesh),
                              variant="trilinear", device="cpu")
    b = tnek.rhs_from_solution(prob, torch.as_tensor(x_true,
                                                     dtype=torch.float32))
    tres = tnek.solve(prob, b, tol=1e-8, max_iter=7)
    assert int(tres.status) == int(jres.status) == SolveStatus.MAXITER
    assert int(tres.iterations) == int(jres.iterations) == 7
    assert _rel(tres.residual, jres.residual) <= 1e-3
    assert _rel(tres.x, jres.x) <= RTOL32


def test_solve_rejects_stacked_rhs():
    mesh = convert.mesh_from_numpy(_mesh())
    prob = tnek.setup_problem(mesh, variant="trilinear", device="cpu")
    with pytest.raises(NotImplementedError, match="multi-RHS"):
        tnek.solve(prob, torch.zeros(mesh.n_global, 2))


def _both_pcg(op_np, b, **kw):
    """The same small SPD/semidefinite system through both packages' pcg."""
    jres = jpcg(lambda v: op_np(v, jnp), jnp.asarray(b), **kw)
    tres = tpcg(lambda v: op_np(v, torch), torch.as_tensor(b), **kw)
    return jres, tres


def test_pcg_breakdown_matches_reference(x64):
    """A pure null-space RHS on a semidefinite operator: p.Ap == 0 flags
    BREAKDOWN and freezes x at 0 after zero iterations (tests/test_pcg.py)."""
    diag = np.array([1.0, 2.0, 0.0])

    def op(v, xp):
        return xp.asarray(diag) * v if xp is jnp else torch.as_tensor(diag) * v

    jres, tres = _both_pcg(op, np.array([0.0, 0.0, 1.0]), tol=1e-12,
                           max_iter=50)
    assert bool(tres.breakdown) and bool(jres.breakdown)
    assert int(tres.status) == int(jres.status) == SolveStatus.BREAKDOWN
    assert int(tres.iterations) == int(jres.iterations) == 0
    np.testing.assert_array_equal(tres.x.numpy(), 0.0)
    assert float(tres.residual) == pytest.approx(float(jres.residual))


def test_pcg_nan_rollback_matches_reference(x64):
    """An operator that returns NaN at iteration 3: the step is rolled
    back, x stays finite, and both packages report DIVERGED after 3
    counted iterations (tests/test_resilience.py)."""
    rng = np.random.default_rng(6)
    n = 24
    a = rng.standard_normal((n, n))
    a = a @ a.T + n * np.eye(n)
    b = a @ rng.standard_normal(n)

    def j_op(x, it):
        return jnp.where(it == 3, jnp.nan, jnp.asarray(a) @ x)

    j_op.takes_iteration = True
    calls = []

    def t_op(x):
        # application 0 is the initial residual; iteration k is application
        # k + 1, so iteration 3 is the fifth call
        calls.append(None)
        y = torch.as_tensor(a) @ x
        return torch.full_like(y, float("nan")) if len(calls) == 5 else y

    jres = jpcg(j_op, jnp.asarray(b), tol=1e-12, max_iter=100)
    tres = tpcg(t_op, torch.as_tensor(b), tol=1e-12, max_iter=100)
    assert int(tres.status) == int(jres.status) == SolveStatus.DIVERGED
    assert int(tres.iterations) == int(jres.iterations) == 3
    assert torch.isfinite(tres.x).all()
    assert _rel(tres.x, jres.x) <= RTOL64
    assert float(tres.residual) == pytest.approx(float(jres.residual),
                                                 rel=1e-12)


def test_pcg_nan_in_rhs_is_diverged():
    b = torch.tensor([1.0, float("nan"), 2.0])
    res = tpcg(lambda v: 2.0 * v, b, tol=1e-6, max_iter=10)
    assert int(res.status) == SolveStatus.DIVERGED
    assert int(res.iterations) == 0


def test_pcg_stagnation_matches_reference(x64):
    """An ill-conditioned system at an unattainable tol: the window flags
    STAGNATED at the same iteration in both packages."""
    d = np.logspace(-10, 0, 40)
    b = np.random.default_rng(7).standard_normal(40)

    def op(v, xp):
        return xp.asarray(d) * v if xp is jnp else torch.as_tensor(d) * v

    jres, tres = _both_pcg(op, b, tol=1e-30, max_iter=500,
                           stagnation_window=10)
    assert int(tres.status) == int(jres.status) == SolveStatus.STAGNATED
    assert int(tres.iterations) == int(jres.iterations) < 500
    jres0, tres0 = _both_pcg(op, b, tol=1e-30, max_iter=60)
    assert int(tres0.status) == int(jres0.status) == SolveStatus.MAXITER
    assert int(tres0.iterations) == 60


def test_flop_count_matches_reference():
    mesh = _mesh((3, 2, 2), 7)
    for d, helm, iters in ((1, False, 200), (3, True, 17)):
        assert tnek.flop_count(convert.mesh_from_numpy(mesh), d, helm,
                               iters) == jnek.flop_count(mesh, d, helm, iters)
