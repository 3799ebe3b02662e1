"""Port parity, bfloat16 storage and the mixed-precision `bf16_x32` solve:
the port's bf16 axhelm plain version, its bf16 operators, `refine` and the
refined Nekbone solve against the JAX reference, on the CPU, from the same
numpy inputs.

Operands that are already bf16-representable are handed to both packages
as float32 arrays, so both casts to bfloat16 are exact.  Tolerances, each
with its reason:
  * the bf16 kernel semantics (widen to fp32, compute, round y once): the
    port's plain version against the reference's Pallas kernel in interpret
    mode, max-norm relative <= 8e-3 — one bf16 ulp of the largest entry,
    since the two sum in other orders before the one rounding;
  * bf16 operators: the port computes its setup products in fp32 from the
    bf16-rounded vertices and rounds once, the reference computes them in
    bf16 arithmetic, so the two bf16 operators agree to <= 1e-2 norm-wise;
  * solves: the same `SolveStatus`, iterations within max(3, 10%) — the
    bf16 inner iterates round at other places in the two frameworks (XLA
    may keep a fused product in fp32), so the inner trajectories drift
    apart at the bf16 rounding level — and the fp32 true residual within
    1.5 tol wherever the reference converges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import axhelm as jax_axhelm
from repro.core import mesh_gen as jmesh
from repro.core import nekbone as jnek
from repro.core.pcg import pcg as jpcg
from repro.core.pcg import refine as jrefine
from repro.core.spectral import basis as jbasis
from repro.kernels.axhelm import ops as jops
from repro_torch import convert
from repro_torch.core import axhelm as taxhelm
from repro_torch.core import nekbone as tnek
from repro_torch.core.pcg import pcg as tpcg
from repro_torch.core.pcg import refine as trefine
from repro_torch.core.spectral import basis as tbasis
from repro_torch.kernels.axhelm import ops as tops
from repro_torch.resilience.status import SolveStatus

BF16 = torch.bfloat16
RTOL_KERNEL = 8e-3
RTOL_OP = 1e-2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16_values(a) -> np.ndarray:
    """float32 numpy array of bf16-representable values."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(BF16).float() \
        .numpy()


def _close_iterations(it_t, it_j) -> bool:
    it_t, it_j = np.atleast_1d(np.asarray(it_t)), np.atleast_1d(
        np.asarray(it_j))
    return bool(np.all(np.abs(it_t - it_j)
                       <= np.maximum(3, 0.1 * np.abs(it_j))))


# ------------------------------------------------------- the bf16 kernel --

# (variant, helmholtz); merged is Helmholtz only, partial Poisson only
_KERNEL_CASES = [("precomputed", False), ("trilinear", False),
                 ("trilinear", True), ("parallelepiped", True),
                 ("merged", True), ("partial", False)]


def _kernel_inputs(variant, helm, n, nrhs, d):
    """bf16-representable x, geom and lambda fields (float32 numpy), from
    the port's own bf16 setup: random per-node lam0/lam1 for Helmholtz,
    Lam2/Lam3 for merged, gScale for partial."""
    rng = np.random.default_rng(7 * n + 3 * nrhs + d)
    box = jmesh.box_mesh(2, 2, 1, n)
    mesh = jmesh.deform_affine(box, seed=2) if variant == "parallelepiped" \
        else jmesh.deform_trilinear(box, seed=1)
    e, n1 = len(mesh.verts), n + 1
    lams = {}
    if helm:
        lams = {"lam0": 1 + 0.3 * rng.random((e,) + (n1,) * 3),
                "lam1": 0.5 + 0.2 * rng.random((e,) + (n1,) * 3)}
    ops, _, _ = taxhelm.make_axhelm_elem_ops(
        variant, tbasis(n), torch.as_tensor(mesh.verts, dtype=torch.float32),
        helmholtz=helm, dtype=BF16, device="cpu",
        **{k: torch.as_tensor(v, dtype=torch.float32)
           for k, v in lams.items()})
    x = _bf16_values(rng.standard_normal((e, nrhs, d) + (n1,) * 3))
    return x, {k: v.float().numpy() for k, v in ops.items()}


@pytest.mark.parametrize("nrhs,d", [(1, 1), (1, 3), (2, 1), (2, 3)])
@pytest.mark.parametrize("variant,helm", _KERNEL_CASES)
def test_bf16_plain_version_matches_pallas_kernel(variant, helm, nrhs, d):
    """The port's bf16 plain version (what a CPU tensor runs, and what the
    CUDA kernel is held to on the card) against the reference's Pallas
    kernel at bf16 storage, interpret mode."""
    n = 3
    x, ops = _kernel_inputs(variant, helm, n, nrhs, d)
    geom = ops.pop("geom")
    # the reference's precomputed operand is packed (E, N1,N1,N1, 7), the
    # port's planar (E, 7, N1,N1,N1)
    j_geom = np.concatenate([np.moveaxis(geom[:, :6], 1, -1),
                             geom[:, 6, ..., None]], axis=-1) \
        if variant == "precomputed" else geom
    y_t = tops.axhelm(torch.as_tensor(x).to(BF16), tbasis(n), variant,
                      torch.as_tensor(geom).to(BF16), helmholtz=helm,
                      **{k: torch.as_tensor(v).to(BF16)
                         for k, v in ops.items()})
    y_j = jops.axhelm(jnp.asarray(x, jnp.bfloat16), jbasis(n), variant,
                      jnp.asarray(j_geom, jnp.bfloat16), helmholtz=helm,
                      interpret=True,
                      **{k: jnp.asarray(v, jnp.bfloat16)
                         for k, v in ops.items()})
    assert y_t.dtype == BF16 and y_j.dtype == jnp.bfloat16
    assert _rel(y_t.float().numpy(), np.asarray(y_j, np.float32)) \
        <= RTOL_KERNEL


def test_bf16_constants_are_the_references_rounding():
    """D-hat, xi and w3 reach the bf16 kernel as fp32 arrays of the values
    the reference rounds to its storage dtype."""
    for n in (3, 7):
        b = jbasis(n)
        dhat, xi, w3 = tops._constants(n, BF16, torch.device("cpu"))
        assert dhat.dtype == xi.dtype == w3.dtype == torch.float32
        for t, a in ((dhat, b.dhat), (xi, b.points), (w3, b.w3)):
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jnp.asarray(a, jnp.bfloat16),
                                      np.float32))


@pytest.mark.parametrize("variant", ["trilinear", "parallelepiped",
                                     "merged", "partial", "precomputed"])
def test_bf16_setup_products_round_fp32_math_once(variant):
    """Every bf16 setup product is the fp32 one computed from the
    bf16-rounded vertices and lambdas, rounded once."""
    n = 3
    mesh = jmesh.deform_trilinear(jmesh.box_mesh(2, 2, 1, n), seed=1)
    helm = variant == "merged"
    verts = torch.as_tensor(mesh.verts, dtype=torch.float32)
    lams = {"lam0": 1.3, "lam1": 0.1} if helm else {}
    lo, _, _ = taxhelm.make_axhelm_elem_ops(variant, tbasis(n), verts,
                                            helmholtz=helm, dtype=BF16,
                                            device="cpu", **lams)
    hi, _, _ = taxhelm.make_axhelm_elem_ops(
        variant, tbasis(n), verts.to(BF16).float(), helmholtz=helm,
        dtype=torch.float32, device="cpu",
        **{k: float(torch.tensor(v).to(BF16)) for k, v in lams.items()})
    assert set(lo) == set(hi)
    for key in lo:
        assert lo[key].dtype == BF16
        assert torch.equal(lo[key], hi[key].to(BF16)), key


# ------------------------------------------------------ the bf16 operator --

def _mesh(order=3, affine=False):
    box = jmesh.box_mesh(3, 3, 2, order)
    return jmesh.deform_affine(box, seed=2) if affine else \
        jmesh.deform_trilinear(box, seed=3)


@pytest.mark.parametrize("variant,helm", [("trilinear", False),
                                          ("parallelepiped", False),
                                          ("partial", False),
                                          ("merged", True)])
def test_op_lo_matches_reference_pallas_op_lo(variant, helm):
    mesh = _mesh(affine=variant == "parallelepiped")
    kw = dict(variant=variant, helmholtz=helm, precision="bf16_x32")
    jp = jnek.setup_problem(mesh, backend="pallas", **kw)
    tp = tnek.setup_problem(convert.mesh_from_numpy(mesh), device="cpu",
                            **kw)
    x = _bf16_values(np.random.default_rng(3).standard_normal(
        mesh.n_global))
    y_j = np.asarray(jp.op_lo(jnp.asarray(x, jnp.bfloat16)), np.float32)
    y_t = tp.op_lo(torch.as_tensor(x).to(BF16))
    assert y_t.dtype == BF16
    assert _norm_rel(y_t.float().numpy(), y_j) <= RTOL_OP


def test_precomputed_op_lo_keeps_the_references_invariant():
    """precomputed at N=7: the reference computes the discrete factors in
    bf16 arithmetic, where D-hat times bf16 coordinates cancels
    catastrophically (its factors are off by up to 30x on this mesh and
    its bf16 operator ~314% off the fp32 one), so the port is held to the
    reference's documented invariant (tests/test_mixed_precision.py), not
    to the reference's output: a bf16-rounded operator, neither fp32 nor
    junk."""
    mesh = convert.mesh_from_numpy(_mesh(order=7))
    p = tnek.setup_problem(mesh, variant="precomputed",
                           precision="bf16_x32", device="cpu")
    x = torch.ones(mesh.n_global)
    rel = float(torch.linalg.norm(p.op_lo(x.to(BF16)).float() - p.op(x))
                / torch.linalg.norm(p.op(x)))
    assert 1e-5 < rel < 0.03, rel


def test_refined_problem_keeps_full_precision_canonical_fields():
    mesh = convert.mesh_from_numpy(_mesh())
    plain = tnek.setup_problem(mesh, device="cpu")
    assert plain.precision is None and plain.op_lo is None
    p = tnek.setup_problem(mesh, precision="bf16_x32", device="cpu")
    assert p.precision == "bf16_x32" and p.diag.dtype == torch.float32
    x = torch.ones(mesh.n_global)
    assert p.op(x).dtype == torch.float32
    assert p.op_lo(x.to(BF16)).dtype == BF16


def test_precision_validation_matches_reference():
    jm = _mesh()
    mesh = convert.mesh_from_numpy(jm)
    cases = [(dict(precision="fp8"), {}, {}),
             (dict(precision="bf16_x32"), dict(dtype=jnp.bfloat16),
              dict(dtype=BF16))]
    for kw, jkw, tkw in cases:
        with pytest.raises(ValueError, match="precision") as jerr:
            jnek.setup_problem(jm, **kw, **jkw)
        with pytest.raises(ValueError, match="precision") as terr:
            tnek.setup_problem(mesh, device="cpu", **kw, **tkw)
        assert str(terr.value) == str(jerr.value).replace("jnp.", "torch.")


# ----------------------------------------------- refine on dense systems --

def _spd(rng, n, cond_boost=1.0):
    a = rng.standard_normal((n, n))
    return np.asarray(a @ a.T / n + cond_boost * np.eye(n), np.float32)


def _ops(a):
    """(fp32 matvec, bf16 matvec) of one dense SPD matrix, in each
    package."""
    a32j, a16j = jnp.asarray(a, jnp.float32), jnp.asarray(a, jnp.bfloat16)
    a32t, a16t = torch.as_tensor(a), torch.as_tensor(a).to(BF16)
    return ((lambda v: a32j @ v,
             lambda v: (a16j @ v.astype(jnp.bfloat16)).astype(v.dtype)),
            (lambda v: a32t @ v,
             lambda v: (a16t @ v.to(BF16)).to(v.dtype)))


def _unit(rng, shape):
    b = rng.standard_normal(shape).astype(np.float32)
    return b / np.linalg.norm(b, axis=0, keepdims=b.ndim > 1)


def _both_refine(a, b, lo=(None, None), x0=None, precond=(None, None),
                 **kw):
    """One refine per package on the same system; `lo` replaces the bf16
    operators, `precond` gives each package its preconditioner."""
    (jhi, jlo), (thi, tlo) = _ops(a)
    jres = jrefine(jhi, lo[0] or jlo, jnp.asarray(b, jnp.float32),
                   x0=None if x0 is None else jnp.asarray(x0, jnp.float32),
                   precond=precond[0], **kw)
    tres = trefine(thi, lo[1] or tlo, torch.as_tensor(b),
                   x0=None if x0 is None else torch.as_tensor(x0),
                   precond=precond[1], **kw)
    true = np.linalg.norm(b - np.asarray(a, np.float64)
                          @ tres.x.double().numpy(), axis=0)
    return jres, tres, true


def _same_outcome(jres, tres):
    np.testing.assert_array_equal(tres.status.numpy(),
                                  np.asarray(jres.status))
    assert _close_iterations(tres.iterations.numpy(), jres.iterations), \
        (tres.iterations, jres.iterations)


def test_refine_reaches_fp32_tolerance_bf16_cannot():
    rng = np.random.default_rng(4)
    a = _spd(rng, 500)
    b = _unit(rng, 500)
    tol = 1e-6
    jres, tres, true = _both_refine(a, b, tol=tol, max_iter=400)
    _same_outcome(jres, tres)
    assert int(tres.status) == SolveStatus.CONVERGED
    assert true <= 1.5 * tol, true
    # a plain bf16 solve bottoms out orders of magnitude above that
    _, (thi, tlo) = _ops(a)
    res16 = tpcg(tlo, torch.as_tensor(b).to(BF16), tol=tol, max_iter=400,
                 stagnation_window=10)
    true16 = float(torch.linalg.norm(torch.as_tensor(b)
                                     - thi(res16.x.float())))
    assert true16 > 10 * tol, true16


def test_refine_matches_plain_pcg_solution():
    rng = np.random.default_rng(5)
    a = _spd(rng, 400)
    b = _unit(rng, 400)
    jres, tres, _ = _both_refine(a, b, tol=1e-6, max_iter=400)
    _same_outcome(jres, tres)
    _, (thi, _) = _ops(a)
    ref = tpcg(thi, torch.as_tensor(b), tol=1e-6, max_iter=400)
    err = float(torch.linalg.norm(tres.x - ref.x) / torch.linalg.norm(ref.x))
    assert err < 1e-4, err


def test_refine_single_sweep_regime_adds_no_restart():
    rng = np.random.default_rng(6)
    a = _spd(rng, 400)
    b = _unit(rng, 400)
    tol = 0.05
    jres, tres, _ = _both_refine(a, b, tol=tol, max_iter=200)
    _same_outcome(jres, tres)
    _, (thi, _) = _ops(a)
    ref = tpcg(thi, torch.as_tensor(b), tol=tol, max_iter=200)
    assert abs(int(tres.iterations) - int(ref.iterations)) <= 2


def test_refine_batched_per_column_status():
    rng = np.random.default_rng(7)
    a = _spd(rng, 400)
    b = _unit(rng, (400, 4))
    tol = 1e-5
    jres, tres, true = _both_refine(a, b, tol=tol, max_iter=600,
                                    batched=True)
    assert tres.x.shape == b.shape and tres.status.shape == (4,)
    _same_outcome(jres, tres)
    assert (tres.status == SolveStatus.CONVERGED).all()
    assert np.all(true <= 1.5 * tol), true


def test_refine_warm_start_converges_faster():
    rng = np.random.default_rng(8)
    a = _spd(rng, 400)
    b = _unit(rng, 400)
    jcold, cold, _ = _both_refine(a, b, tol=1e-5, max_iter=400)
    jwarm, warm, _ = _both_refine(a, b, tol=1e-5, max_iter=400,
                                  x0=np.asarray(cold.x))
    _same_outcome(jwarm, warm)
    assert int(warm.iterations) < int(cold.iterations)


def test_refine_jacobi_precond():
    rng = np.random.default_rng(9)
    a = _spd(rng, 400)
    d = np.linspace(1.0, 50.0, 400).astype(np.float32)
    a = a * np.outer(np.sqrt(d), np.sqrt(d))
    b = _unit(rng, 400)
    inv = 1.0 / np.diag(a)
    inv_j, inv_t = jnp.asarray(inv, jnp.bfloat16), torch.as_tensor(inv).to(
        BF16)
    pre = (lambda r: inv_j * r, lambda r: inv_t * r)
    _, plain, _ = _both_refine(a, b, tol=1e-5, max_iter=2000)
    jprec, prec, _ = _both_refine(a, b, tol=1e-5, max_iter=2000,
                                  precond=pre)
    _same_outcome(jprec, prec)
    assert int(prec.status) == SolveStatus.CONVERGED
    assert int(prec.iterations) < int(plain.iterations)


def test_refine_broken_lo_operator_flags_stagnated():
    """The negated lo system: the inner CG breaks down at once and returns
    a zero correction, which the monotone acceptance rolls back and flags
    STAGNATED — never a false CONVERGED, never an endless loop."""
    rng = np.random.default_rng(10)
    a = _spd(rng, 300)
    b = _unit(rng, 300)
    (_, jlo), (_, tlo) = _ops(a)
    jres, tres, _ = _both_refine(
        a, b, lo=(lambda v: -jlo(v), lambda v: -tlo(v)), tol=1e-6,
        max_iter=400)
    _same_outcome(jres, tres)
    assert int(tres.status) == SolveStatus.STAGNATED
    assert torch.isfinite(tres.x).all()


def test_refine_nan_lo_operator_flags_without_poisoning_x():
    rng = np.random.default_rng(11)
    a = _spd(rng, 200)
    b = _unit(rng, 200)
    jres, tres, _ = _both_refine(
        a, b, lo=(lambda v: jnp.full_like(v, jnp.nan),
                  lambda v: torch.full_like(v, float("nan"))),
        tol=1e-6, max_iter=100)
    _same_outcome(jres, tres)
    assert int(tres.status) != SolveStatus.CONVERGED
    assert torch.isfinite(tres.x).all()


def test_refine_zero_rhs_converges_immediately():
    a = _spd(np.random.default_rng(12), 100)
    jres, tres, _ = _both_refine(a, np.zeros(100, np.float32), tol=1e-8,
                                 max_iter=50)
    _same_outcome(jres, tres)
    assert int(tres.iterations) == 0
    assert int(tres.status) == SolveStatus.CONVERGED
    assert float(torch.linalg.norm(tres.x)) == 0.0


def test_pcg_default_dot_is_fp32_on_bf16():
    """A bf16 solve with the default dot follows the same trajectory as
    one whose dot is explicitly fp32, and reports fp32 residuals."""
    rng = np.random.default_rng(1)
    a16 = torch.as_tensor(_spd(rng, 2048, cond_boost=4.0)).to(BF16)
    b16 = torch.as_tensor(_unit(rng, 2048)).to(BF16)

    def fp32_dot(u, v):
        return torch.dot(u.float(), v.float())

    res = tpcg(lambda v: a16 @ v, b16, tol=5e-3, max_iter=100)
    res32 = tpcg(lambda v: a16 @ v, b16, tol=5e-3, max_iter=100,
                 dot=fp32_dot)
    assert res.residual.dtype == torch.float32
    assert int(res.iterations) == int(res32.iterations)
    assert torch.equal(res.x, res32.x)


# ---------------------------------------------- the refined Nekbone solve --

def _rhs(mesh, nrhs=1, norm=30.0):
    """The reference tests' RHS: standard normal from numpy seed 0, zero
    on the Dirichlet mask, each column normalised to `norm`."""
    rng = np.random.default_rng(0)
    shape = (mesh.n_global,) if nrhs == 1 else (mesh.n_global, nrhs)
    b = rng.standard_normal(shape).astype(np.float32)
    b[np.asarray(mesh.boundary)] = 0.0
    return b / np.linalg.norm(b, axis=0, keepdims=nrhs > 1) * norm


def _both_solves(mesh, b, tol, max_iter=400, **kw):
    jp = jnek.setup_problem(mesh, backend="pallas", precision="bf16_x32",
                            **kw)
    jres = jnek.solve(jp, jnp.asarray(b), tol=tol, max_iter=max_iter)
    tp = tnek.setup_problem(convert.mesh_from_numpy(mesh), device="cpu",
                            precision="bf16_x32", **kw)
    tres = tnek.solve(tp, torch.as_tensor(b), tol=tol, max_iter=max_iter)
    true = torch.linalg.norm(torch.as_tensor(b) - tp.op(tres.x), dim=0)
    return jres, tres, true.numpy()


@pytest.mark.parametrize("nrhs", [1, 4])
@pytest.mark.parametrize("variant,helm", [("trilinear", False),
                                          ("merged", True)])
def test_refined_solve_matches_reference(variant, helm, nrhs):
    mesh = _mesh()
    tol = 1e-4
    jres, tres, true = _both_solves(mesh, _rhs(mesh, nrhs), tol,
                                    variant=variant, helmholtz=helm,
                                    dirichlet=True)
    assert tres.x.shape == ((mesh.n_global,) if nrhs == 1
                            else (mesh.n_global, nrhs))
    _same_outcome(jres, tres)
    assert (tres.status == SolveStatus.CONVERGED).all()
    assert np.all(true <= 1.5 * tol), true


def test_outside_envelope_stagnates_like_reference():
    """Unmasked Helmholtz lies outside refinement's envelope
    (kappa_eff * eps_bf16 >= 1): STAGNATED in both packages, never a false
    CONVERGED."""
    mesh = _mesh()
    tol = 1e-4
    jres, tres, true = _both_solves(mesh, _rhs(mesh), tol,
                                    variant="trilinear", helmholtz=True,
                                    dirichlet=False)
    assert int(jres.status) == int(tres.status) == SolveStatus.STAGNATED
    assert true > 1.5 * tol, true


def test_refined_solve_jacobi_and_warm_start():
    mesh = convert.mesh_from_numpy(_mesh())
    b = torch.as_tensor(_rhs(mesh))
    p = tnek.setup_problem(mesh, precision="bf16_x32", device="cpu")
    cold = tnek.solve(p, b, tol=1e-4, max_iter=400)
    assert int(cold.status) == SolveStatus.CONVERGED
    warm = tnek.solve(p, b, tol=1e-4, max_iter=400, x0=cold.x)
    assert int(warm.iterations) < int(cold.iterations)
