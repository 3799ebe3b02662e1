"""The port's resilient solve (`repro_torch.resilience`) on the CPU: the
single-device cases of tests/test_resilience.py (all but the serving and
training-injector ones), each beside the JAX reference on the same seeded
inputs where the reference has the function.

Tolerances: statuses, rungs and attempt trails equal to the reference's;
iterations within +-1 (the packages' dots round in other orders); answers
within the bounds of tests/test_resilience.py.  The backend rung needs a
problem on the CUDA kernels; on the CPU such a problem is the reference
operator relabelled ``backend="cuda"``, which exercises the ladder and not
the kernels (tests/test_torch_cuda.py runs it on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mesh_gen as jmesh
from repro.core import nekbone as jnek
from repro.core.pcg import pcg as jpcg
from repro.core.pcg import pcg_block as jpcg_block
from repro.resilience import inject as jinject
from repro.resilience import retry as jretry
from repro_torch.core import mesh_gen, nekbone
from repro_torch.core.pcg import pcg, pcg_block
from repro_torch.resilience import SolveStatus, classify, is_failure
from repro_torch.resilience.inject import (FAULT_MODES, FaultSpec,
                                           bitflip_scale, fault_dof, poison,
                                           wrap_operator)
from repro_torch.resilience.retry import (RetryPolicy, SolveReport,
                                          has_precision_fallback,
                                          solve_resilient)

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _x64():
    # restore what was set before: a session fixture of another module may
    # have switched x64 on for the rest of the worker's session
    saved = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", saved)


def _close(a, b):
    return np.all(np.abs(np.asarray(a, np.int64)
                         - np.asarray(b, np.int64)) <= 1)


# ------------------------------------------------------------ status ----

def test_status_enum_and_predicates():
    assert SolveStatus.CONVERGED.ok
    for s in (SolveStatus.MAXITER, SolveStatus.DIVERGED,
              SolveStatus.STAGNATED, SolveStatus.BREAKDOWN):
        assert not s.ok
        assert is_failure(int(s))
    assert not is_failure(int(SolveStatus.CONVERGED))
    np.testing.assert_array_equal(
        is_failure(torch.tensor([0, 1, 2, 3, 4])).numpy(),
        [False, True, True, True, True])


def test_classify_severity_lattice():
    f, t = torch.tensor(False), torch.tensor(True)
    ok, bad = torch.tensor(1e-20), torch.tensor(1.0)
    tol2 = 1e-12
    assert int(classify(ok, tol2, f, f, f)) == SolveStatus.CONVERGED
    assert int(classify(bad, tol2, f, f, f)) == SolveStatus.MAXITER
    assert int(classify(bad, tol2, f, f, t)) == SolveStatus.STAGNATED
    assert int(classify(ok, tol2, f, f, t)) == SolveStatus.CONVERGED
    assert int(classify(bad, tol2, t, f, t)) == SolveStatus.BREAKDOWN
    assert int(classify(bad, tol2, t, t, t)) == SolveStatus.DIVERGED
    assert int(classify(torch.tensor(float("nan")), tol2, f, f, f)) \
        == SolveStatus.DIVERGED


def test_classify_is_vectorised():
    st = classify(torch.tensor([1e-20, 1.0, float("nan")]), 1e-12,
                  torch.zeros(3, dtype=torch.bool),
                  torch.zeros(3, dtype=torch.bool),
                  torch.zeros(3, dtype=torch.bool))
    np.testing.assert_array_equal(
        st.numpy(), [SolveStatus.CONVERGED, SolveStatus.MAXITER,
                     SolveStatus.DIVERGED])


# ------------------------------------------- in-loop detection, pcg ----

def _spd(rng, n=24):
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def _poisoned(a, at_iteration, xp):
    """A matvec that returns all-NaN at one iteration, per package."""
    am = xp.asarray(a) if xp is jnp else torch.as_tensor(a)

    def apply(x, it):
        y = am @ x
        return xp.where(it == at_iteration, float("nan"), y)

    apply.takes_iteration = True
    return apply


def test_pcg_detects_nan_within_one_iteration(rng):
    a = _spd(rng)
    b = a @ rng.standard_normal(a.shape[0])
    jres = jpcg(_poisoned(a, 3, jnp), jnp.asarray(b), tol=1e-12,
                max_iter=100)
    res = pcg(_poisoned(a, 3, torch), torch.as_tensor(b), tol=1e-12,
              max_iter=100)
    assert int(res.status) == int(jres.status) == SolveStatus.DIVERGED
    assert int(res.iterations) == int(jres.iterations) == 3
    assert torch.isfinite(res.x).all() and torch.isfinite(res.residual)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               rtol=0, atol=1e-10 * np.abs(jres.x).max())


def test_pcg_healthy_solve_reports_converged(rng):
    a = _spd(rng)
    b = a @ rng.standard_normal(a.shape[0])
    res = pcg(lambda v: torch.as_tensor(a) @ v, torch.as_tensor(b),
              tol=1e-12, max_iter=200)
    assert int(res.status) == SolveStatus.CONVERGED
    assert not bool(res.breakdown)


def test_pcg_maxiter_status(rng):
    a = _spd(rng)
    b = a @ rng.standard_normal(a.shape[0])
    res = pcg(lambda v: torch.as_tensor(a) @ v, torch.as_tensor(b),
              tol=1e-12, max_iter=2)
    assert int(res.status) == SolveStatus.MAXITER


def test_pcg_stagnation_window(rng):
    d = np.logspace(-10, 0, 40)
    b = rng.standard_normal(40)
    jres = jpcg(lambda v: jnp.asarray(d) * v, jnp.asarray(b), tol=1e-30,
                max_iter=500, stagnation_window=10)
    res = pcg(lambda v: torch.as_tensor(d) * v, torch.as_tensor(b),
              tol=1e-30, max_iter=500, stagnation_window=10)
    assert int(res.status) == int(jres.status) == SolveStatus.STAGNATED
    assert _close(res.iterations, jres.iterations)
    assert int(res.iterations) < 500
    res0 = pcg(lambda v: torch.as_tensor(d) * v, torch.as_tensor(b),
               tol=1e-30, max_iter=60)
    assert int(res0.status) == SolveStatus.MAXITER
    assert int(res0.iterations) == 60


def test_pcg_breakdown_status():
    d = torch.tensor([1.0, 2.0, 0.0])
    res = pcg(lambda x: d * x, torch.tensor([0.0, 0.0, 1.0]), tol=1e-12,
              max_iter=50)
    assert bool(res.breakdown)
    assert int(res.status) == SolveStatus.BREAKDOWN


def test_pcg_block_poisoned_column_isolated(rng):
    """A NaN strike on one column at body 2 freezes THAT column; the
    others converge with the clean solve's iterations."""
    a = _spd(rng, n=16)
    bs = a @ rng.standard_normal((a.shape[0], 4))

    def japply(x, it):
        y = jnp.asarray(a) @ x
        return y.at[..., 1].set(jnp.where(it == 2, jnp.nan, y[..., 1]))

    japply.takes_iteration = True
    at = torch.as_tensor(a)

    def tapply(x, it):
        y = at @ x
        col = torch.where(it == 2, float("nan"), y[..., 1])
        return torch.cat([y[..., :1], col[..., None], y[..., 2:]], -1)

    tapply.takes_iteration = True
    jres = jpcg_block(japply, jnp.asarray(bs), tol=1e-12, max_iter=100)
    res = pcg_block(tapply, torch.as_tensor(bs), tol=1e-12, max_iter=100)
    want = [SolveStatus.CONVERGED, SolveStatus.DIVERGED,
            SolveStatus.CONVERGED, SolveStatus.CONVERGED]
    np.testing.assert_array_equal(res.status.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jres.status), want)
    assert int(res.iterations[1]) == 2
    ref = pcg_block(lambda v: at @ v, torch.as_tensor(bs), tol=1e-12,
                    max_iter=100)
    np.testing.assert_array_equal(res.iterations.numpy()[[0, 2, 3]],
                                  ref.iterations.numpy()[[0, 2, 3]])
    assert _close(res.iterations, jres.iterations)
    assert torch.isfinite(res.x).all()


# ---------------------------------------------------- fault injection ----

def test_fault_spec_validation():
    assert FAULT_MODES == jinject.FAULT_MODES
    with pytest.raises(ValueError, match="mode"):
        FaultSpec(mode="gamma_ray")
    with pytest.raises(ValueError, match="iteration"):
        FaultSpec(iteration=-1)
    assert hash(FaultSpec()) == hash(FaultSpec())
    assert FaultSpec(column=2) == FaultSpec(column=2)


@pytest.mark.parametrize("element", [0, 1, 3])
def test_fault_dof_targets_interior_node(element):
    mesh = mesh_gen.box_mesh(2, 2, 1, 3)
    dof = fault_dof(mesh.global_ids, FaultSpec(element=element))
    assert isinstance(dof, int)
    assert dof == jinject.fault_dof(mesh.global_ids,
                                    jinject.FaultSpec(element=element))
    assert (mesh.global_ids.reshape(len(mesh.verts), -1) == dof).sum() == 1
    with pytest.raises(ValueError, match="element"):
        fault_dof(mesh.global_ids, FaultSpec(element=99))


def test_fault_dof_rejects_low_order():
    mesh = mesh_gen.box_mesh(2, 1, 1, 1)
    with pytest.raises(ValueError, match="order"):
        fault_dof(mesh.global_ids, FaultSpec())


def test_wrap_operator_rejects_exchange_mode_and_other_shards():
    mesh = mesh_gen.box_mesh(2, 1, 1, 3)
    with pytest.raises(ValueError, match="drop_exchange"):
        wrap_operator(lambda x: x, FaultSpec(mode="drop_exchange"),
                      mesh.global_ids)
    with pytest.raises(ValueError, match="shard"):
        wrap_operator(lambda x: x, FaultSpec(shard=1), mesh.global_ids)


def test_bitflip_scale_is_dtype_aware():
    assert bitflip_scale(torch.float32) < bitflip_scale(torch.float64)
    assert np.isfinite(bitflip_scale(torch.float32))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.float64, jnp.float64),
                    (torch.bfloat16, jnp.bfloat16)):
        assert bitflip_scale(dt) == jinject.bitflip_scale(jdt)


@pytest.mark.parametrize("mode", ["nan", "bitflip"])
@pytest.mark.parametrize("column", [None, 1])
@pytest.mark.parametrize("fire", [False, True])
def test_poison_matches_reference(mode, column, fire):
    rng = np.random.default_rng(4)
    y = rng.standard_normal((9, 3))
    spec = FaultSpec(mode=mode, column=column)
    jspec = jinject.FaultSpec(mode=mode, column=column)
    got = poison(torch.as_tensor(y), 4, torch.tensor(fire), spec)
    want = np.asarray(jinject.poison(jnp.asarray(y), 4, jnp.asarray(fire),
                                     jspec))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------- injection through the solve ----

@pytest.fixture(scope="module")
def poisson64():
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 2, 2, 4), seed=3)
    prob = nekbone.setup_problem(mesh, variant="trilinear",
                                 dtype=torch.float64, device=CPU)
    jprob = jnek.setup_problem(mesh, variant="trilinear", dtype=jnp.float64)
    x_true = np.random.default_rng(0).standard_normal(mesh.n_global)
    b = nekbone.rhs_from_solution(prob, torch.as_tensor(x_true))
    return mesh, prob, b, jprob


def test_solve_nan_injection_detected_within_one_iteration(poisson64):
    _, prob, b, jprob = poisson64
    spec = FaultSpec(mode="nan", iteration=3)
    res = nekbone.solve(prob, b, tol=1e-10, max_iter=300, fault=spec)
    jres = jnek.solve(jprob, jnp.asarray(b.numpy()), tol=1e-10,
                      max_iter=300,
                      fault=jinject.FaultSpec(mode="nan", iteration=3))
    assert int(res.status) == int(jres.status) == SolveStatus.DIVERGED
    assert int(res.iterations) == int(jres.iterations) == spec.iteration
    assert torch.isfinite(res.x).all()
    ref = nekbone.solve(prob, b, tol=1e-10, max_iter=300)
    assert int(ref.status) == SolveStatus.CONVERGED


def test_solve_bitflip_injection_is_detected(poisson64):
    _, prob, b, jprob = poisson64
    res = nekbone.solve(prob, b, tol=1e-10, max_iter=120,
                        fault=FaultSpec(mode="bitflip", iteration=2),
                        stagnation_window=15)
    jres = jnek.solve(jprob, jnp.asarray(b.numpy()), tol=1e-10,
                      max_iter=120, stagnation_window=15,
                      fault=jinject.FaultSpec(mode="bitflip", iteration=2))
    assert is_failure(int(res.status)), SolveStatus(int(res.status)).name
    assert int(res.status) == int(jres.status)


def test_solve_batched_injection_isolates_column(poisson64):
    mesh, _, _, _ = poisson64
    prob = nekbone.setup_problem(mesh, variant="trilinear",
                                 dtype=torch.float64, device=CPU, nrhs=4)
    xs = np.random.default_rng(1).standard_normal((mesh.n_global, 4))
    bs = nekbone.rhs_from_solution(prob, torch.as_tensor(xs))
    spec = FaultSpec(mode="nan", iteration=2, column=1)
    res = nekbone.solve(prob, bs, tol=1e-10, max_iter=300, fault=spec)
    np.testing.assert_array_equal(
        res.status.numpy(), [SolveStatus.CONVERGED, SolveStatus.DIVERGED,
                             SolveStatus.CONVERGED, SolveStatus.CONVERGED])
    assert int(res.iterations[1]) == 2
    ref = nekbone.solve(prob, bs, tol=1e-10, max_iter=300)
    np.testing.assert_array_equal(res.iterations.numpy()[[0, 2, 3]],
                                  ref.iterations.numpy()[[0, 2, 3]])


def test_faulted_solve_reuses_its_loop(poisson64):
    """The wrapped operator is memoized with the problem's loops: a repeat
    faulted solve builds nothing new and repeats bitwise."""
    _, prob, b, _ = poisson64
    spec = FaultSpec(mode="nan", iteration=4)
    first = nekbone.solve(prob, b, tol=1e-10, max_iter=300, fault=spec)
    builds = prob.graphs.builds
    again = nekbone.solve(prob, b, tol=1e-10, max_iter=300, fault=spec)
    assert prob.graphs.builds == builds
    assert torch.equal(first.x, again.x)


# ----------------------------------------- solve_resilient's ladder ----

def test_resilient_clean_solve_single_attempt(poisson64):
    _, prob, b, _ = poisson64
    rep = solve_resilient(prob, b, tol=1e-10, max_iter=300)
    assert isinstance(rep, SolveReport)
    assert rep.ok and rep.converged
    assert rep.rung == ("initial",)
    assert len(rep.attempts) == 1
    assert int(rep.status[0]) == SolveStatus.CONVERGED


def test_resilient_transient_fault_restart_recovers(poisson64):
    _, prob, b, jprob = poisson64
    ref = nekbone.solve(prob, b, tol=1e-10, max_iter=300)
    rep = solve_resilient(prob, b, tol=1e-10, max_iter=300,
                          fault=FaultSpec(mode="nan", iteration=5),
                          persistent=False)
    jrep = jretry.solve_resilient(
        jprob, jnp.asarray(b.numpy()), tol=1e-10, max_iter=300,
        fault=jinject.FaultSpec(mode="nan", iteration=5), persistent=False)
    assert rep.converged and jrep.converged
    assert rep.rung == jrep.rung == ("restart",)
    assert [a.rung for a in rep.attempts] == ["initial", "restart"]
    assert int(rep.attempts[0].status[0]) == SolveStatus.DIVERGED
    assert int(rep.iterations[0]) <= int(ref.iterations)
    assert _close(rep.iterations, jrep.iterations)
    assert float((rep.x - ref.x).abs().max()) < 1e-6


def _relabelled(prob):
    """The problem as if it ran the CUDA kernels (the reference operator
    under ``backend="cuda"``), so the backend rung applies."""
    return prob._replace(backend="cuda")


def test_resilient_persistent_fault_backend_fallback():
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 2, 1, 4), seed=3)
    prob = _relabelled(nekbone.setup_problem(
        mesh, variant="partial", dtype=torch.float32, device=CPU))
    x_true = np.random.default_rng(0).standard_normal(mesh.n_global)
    b = nekbone.rhs_from_solution(prob, torch.as_tensor(x_true,
                                                        dtype=torch.float32))
    ref = nekbone.solve(nekbone.setup_problem(
        mesh, variant="partial", dtype=torch.float32, device=CPU), b,
        tol=1e-6, max_iter=300)
    rep = solve_resilient(prob, b, RetryPolicy(backend_fallback=True),
                          tol=1e-6, max_iter=300,
                          fault=FaultSpec(mode="nan", iteration=3),
                          persistent=True)
    jprob = jnek.setup_problem(mesh, variant="partial", dtype=jnp.float32,
                               backend="pallas")
    jrep = jretry.solve_resilient(
        jprob, jnp.asarray(b.numpy()), tol=1e-6, max_iter=300,
        fault=jinject.FaultSpec(mode="nan", iteration=3), persistent=True)
    assert rep.converged
    assert rep.rung == ("backend:reference",)
    assert jrep.rung == ("backend:reference",)
    assert [a.rung for a in rep.attempts] == \
        ["initial", "restart", "backend:reference"] == \
        [a.rung for a in jrep.attempts]
    assert abs(int(rep.iterations[0]) - int(ref.iterations)) <= 1
    assert float((rep.x - ref.x).abs().max()) < 1e-4


def test_resilient_backend_rung_is_opt_in():
    """The default policy never answers with the plain version in place of
    the kernels: a persistent fault on a ``backend="cuda"`` problem ends
    after the restart rung, not converged, where the reference's default
    (``pallas -> reference`` on) goes on to its backend rung."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 2, 1, 4), seed=3)
    prob = _relabelled(nekbone.setup_problem(
        mesh, variant="partial", dtype=torch.float32, device=CPU))
    x_true = np.random.default_rng(0).standard_normal(mesh.n_global)
    b = nekbone.rhs_from_solution(prob, torch.as_tensor(x_true,
                                                        dtype=torch.float32))
    assert not RetryPolicy().backend_fallback
    rep = solve_resilient(prob, b, tol=1e-6, max_iter=300,
                          fault=FaultSpec(mode="nan", iteration=3),
                          persistent=True)
    assert not rep.converged
    assert rep.rung == ("initial",)
    assert [a.rung for a in rep.attempts] == ["initial", "restart"]
    assert int(rep.status[0]) == SolveStatus.DIVERGED


def test_resilient_honest_failure_when_ladder_exhausted(poisson64):
    _, prob, b, _ = poisson64
    rep = solve_resilient(prob, b, tol=1e-10, max_iter=300,
                          fault=FaultSpec(mode="nan", iteration=3),
                          persistent=True)
    assert not rep.converged and not rep.ok
    assert [a.rung for a in rep.attempts] == ["initial", "restart"]
    assert all(int(a.status[0]) == SolveStatus.DIVERGED
               for a in rep.attempts)
    assert torch.isfinite(rep.x).all()


def test_resilient_batched_retries_only_failed_columns(poisson64):
    mesh, _, _, _ = poisson64
    prob = nekbone.setup_problem(mesh, variant="trilinear",
                                 dtype=torch.float64, device=CPU, nrhs=4)
    xs = np.random.default_rng(2).standard_normal((mesh.n_global, 4))
    bs = nekbone.rhs_from_solution(prob, torch.as_tensor(xs))
    rep = solve_resilient(prob, bs, tol=1e-10, max_iter=300,
                          fault=FaultSpec(mode="nan", iteration=2, column=2),
                          persistent=False)
    assert rep.converged
    assert rep.rung == ("initial", "initial", "restart", "initial")
    assert rep.attempts[1].columns == (2,)
    ref = nekbone.solve(prob, bs, tol=1e-10, max_iter=300)
    assert float((rep.x - ref.x).abs().max()) < 1e-6


def test_resilient_rebuild_gets_subset_nrhs():
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 2, 1, 4), seed=3)
    prob = _relabelled(nekbone.setup_problem(
        mesh, variant="partial", dtype=torch.float32, device=CPU, nrhs=8))
    xs = np.random.default_rng(5).standard_normal((mesh.n_global, 8))
    bs = nekbone.rhs_from_solution(prob, torch.as_tensor(
        xs, dtype=torch.float32))
    nrhs_seen = []

    def spy_rebuild(backend=None, dtype=None, nrhs=None):
        nrhs_seen.append(nrhs)
        return nekbone.setup_problem(mesh, variant="partial",
                                     dtype=torch.float32,
                                     backend=backend or "reference",
                                     device=CPU, nrhs=nrhs)

    rep = solve_resilient(prob, bs, tol=1e-6, max_iter=300,
                          fault=FaultSpec(mode="nan", iteration=2, column=2),
                          persistent=True, rebuild=spy_rebuild,
                          policy=RetryPolicy(backend_fallback=True))
    assert rep.converged
    assert nrhs_seen == [1]
    assert rep.rung[2] == "backend:reference"
    assert rep.attempts[2].columns == (2,)


def test_resilient_rebuild_without_nrhs_kwarg_still_works(poisson64):
    mesh, _, _, _ = poisson64
    prob = nekbone.setup_problem(mesh, variant="trilinear",
                                 dtype=torch.bfloat16, device=CPU)
    calls = []

    def old_style_rebuild(backend=None, dtype=None):
        calls.append((backend, dtype))
        return nekbone.setup_problem(mesh, variant="trilinear",
                                     dtype=dtype or torch.bfloat16,
                                     device=CPU)

    x_true = torch.as_tensor(
        np.random.default_rng(6).standard_normal(mesh.n_global),
        dtype=torch.bfloat16)
    b = nekbone.rhs_from_solution(prob, x_true)
    rep = solve_resilient(prob, b, tol=1e-2, max_iter=300,
                          fault=FaultSpec(mode="nan", iteration=2),
                          persistent=True, rebuild=old_style_rebuild)
    assert rep.converged
    assert rep.rung == ("precision:float32",)
    assert calls == [(None, torch.float32)]


def test_resilient_bf16_x32_precision_rung(poisson64):
    """A persistent fault at the first inner iteration of a bf16_x32
    problem's bf16 operator strikes every sweep, so no sweep gains and the
    restart stagnates too; the precision rung rebuilds the problem in fp32
    (the precision tag dropped) and converges, as the reference's does."""
    mesh, _, _, _ = poisson64
    prob = nekbone.setup_problem(mesh, variant="trilinear", device=CPU,
                                 precision="bf16_x32")
    assert has_precision_fallback(prob)
    b = nekbone.random_rhs(prob)
    spec = FaultSpec(mode="nan", iteration=0)
    rep = solve_resilient(prob, b, tol=1e-3, max_iter=600, fault=spec,
                          persistent=True)
    jprob = jnek.setup_problem(mesh, variant="trilinear",
                               precision="bf16_x32")
    jrep = jretry.solve_resilient(
        jprob, jnp.asarray(b.numpy()), tol=1e-3, max_iter=600,
        fault=jinject.FaultSpec(mode="nan", iteration=0), persistent=True)
    assert rep.converged and jrep.converged
    assert rep.rung == jrep.rung == ("precision:float32",)
    assert [a.rung for a in rep.attempts] == \
        [a.rung for a in jrep.attempts] == \
        ["initial", "restart", "precision:float32"]
    assert int(rep.attempts[0].status[0]) == SolveStatus.STAGNATED
    assert _close(rep.iterations, jrep.iterations)
    assert float(rep.true_residual[0]) <= 10 * 1e-3


def test_resilient_policy_can_disable_rungs(poisson64):
    _, prob, b, _ = poisson64
    rep = solve_resilient(prob, b,
                          RetryPolicy(restart=False, backend_fallback=False,
                                      precision_fallback=False),
                          tol=1e-10, max_iter=300,
                          fault=FaultSpec(mode="nan", iteration=3))
    assert not rep.converged
    assert [a.rung for a in rep.attempts] == ["initial"]


def test_resilient_lets_a_failing_solve_raise(poisson64):
    """The ladder acts on statuses only: an exception in a solve (a kernel
    that fails to build or launch) passes through uncaught."""
    _, prob, b, _ = poisson64

    def broken(prob_, b_, x0, flt):
        raise RuntimeError("axhelm kernel launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        solve_resilient(prob, b, tol=1e-10, solve_fn=broken)
