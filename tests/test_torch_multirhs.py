"""Port parity, stacked right-hand sides: `pcg_block`, the batched global
operator and the stacked-RHS Nekbone solve of `repro_torch` against the JAX
reference, on the CPU, from the same numpy inputs.

Tolerances, each with its reason:
  * float64 (`x64`): per-column iterations and statuses equal, x within
    1e-10 relative, the batched operator within 1e-12 (same sums, other
    order);
  * float32 solves: per-column iterations within +-1 and the same status
    (fp32 rounding drifts the two packages' iterations apart slowly);
  * a trailing nrhs=1 axis takes the single-RHS path: bitwise equal to the
    unbatched solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mesh_gen as jmesh
from repro.core import nekbone as jnek
from repro.core.pcg import pcg_block as jpcg_block
from repro_torch import convert, nekbone_solve
from repro_torch.core import nekbone as tnek
from repro_torch.core.pcg import pcg_block as tpcg_block
from repro_torch.resilience.status import SolveStatus
from _torch_x64 import x64  # noqa: F401

RTOL64 = 1e-12


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _spd(rng, n):
    a = rng.standard_normal((n, n))
    return a @ a.T / n + np.eye(n)


def _both_blocks(op_np, b, **kw):
    """The same stacked system through both packages' pcg_block, float64;
    `op_np(v, xp)` applies the operator with xp = jnp or torch."""
    jres = jpcg_block(lambda v: op_np(v, jnp), jnp.asarray(b), **kw)
    tkw = dict(kw)
    if "x0" in kw:
        tkw["x0"] = torch.as_tensor(kw["x0"])
        kw["x0"] = jnp.asarray(kw["x0"])
        jres = jpcg_block(lambda v: op_np(v, jnp), jnp.asarray(b), **kw)
    tres = tpcg_block(lambda v: op_np(v, torch), torch.as_tensor(b), **tkw)
    return jres, tres


def _same_block(jres, tres, rtol=1e-10):
    for field in ("iterations", "status", "breakdown"):
        np.testing.assert_array_equal(getattr(tres, field).numpy(),
                                      np.asarray(getattr(jres, field)))
    assert tres.residual.shape == tres.status.shape
    x_t, x_j = tres.x.numpy(), np.asarray(jres.x)
    assert np.isfinite(x_t).all()
    assert np.max(np.abs(x_t - x_j)) <= rtol * max(np.max(np.abs(x_j)), 1)


def _dense(a):
    def op(v, xp):
        return xp.asarray(a) @ v if xp is jnp else torch.as_tensor(a) @ v
    return op


@pytest.mark.parametrize("scales", [(1.0, 1.0, 1.0), (1.0, 1e-3, 1e3, 0.0)])
def test_pcg_block_columns_freeze_independently(x64, scales):
    """Columns of very different size meet the absolute tolerance at
    different iterations (a zero column at iteration 0); each is frozen
    where it converged."""
    rng = np.random.default_rng(1)
    a = _spd(rng, 60)
    b = rng.standard_normal((60, len(scales))) * np.asarray(scales)
    jres, tres = _both_blocks(_dense(a), b, tol=1e-9, max_iter=200)
    _same_block(jres, tres)
    assert (tres.status == SolveStatus.CONVERGED).all()
    if 0.0 in scales:
        assert int(tres.iterations[-1]) == 0
        assert not tres.x[:, -1].any()


def test_pcg_block_jacobi_and_warm_start(x64):
    rng = np.random.default_rng(2)
    d = np.linspace(1.0, 40.0, 50)
    a = _spd(rng, 50) * np.outer(np.sqrt(d), np.sqrt(d))
    b = rng.standard_normal((50, 3))
    inv = 1.0 / np.diag(a)

    def jacobi(r):
        w = jnp.asarray(inv) if isinstance(r, jnp.ndarray) else \
            torch.as_tensor(inv)
        return w[:, None] * r

    jres, tres = _both_blocks(_dense(a), b, precond=jacobi, tol=1e-9,
                              max_iter=300)
    _same_block(jres, tres)
    jwarm, twarm = _both_blocks(_dense(a), b, precond=jacobi, tol=1e-9,
                                max_iter=300, x0=0.9 * tres.x.numpy())
    _same_block(jwarm, twarm)
    assert (twarm.iterations <= tres.iterations).all()


@pytest.mark.parametrize("diag,b,broken", [
    ([1.0, 3.0, 0.0, 2.0], [[1.0, 0.0, 2.0], [3.0, 0.0, 0.0],
                            [0.0, 1.0, 0.0], [2.0, 0.0, 4.0]],
     [False, True, False]),
    ([1.0, 2.0, -1.0], [[1.0, 0.0], [2.0, 0.0], [0.0, 1.0]], [False, True]),
], ids=["semidefinite", "indefinite"])
def test_pcg_block_breakdown_isolates_column(x64, diag, b, broken):
    """A column along a null or negative direction breaks down at once,
    frozen at x = 0 after 0 iterations; its siblings converge."""
    diag = np.asarray(diag)

    def op(v, xp):
        w = jnp.asarray(diag) if xp is jnp else torch.as_tensor(diag)
        return w[:, None] * v

    jres, tres = _both_blocks(op, np.asarray(b), tol=1e-12, max_iter=50)
    _same_block(jres, tres)
    np.testing.assert_array_equal(tres.breakdown.numpy(), broken)
    assert not tres.x[:, 1].any() and int(tres.iterations[1]) == 0


def test_pcg_block_poisoned_column_isolated(x64):
    """A NaN in one column's operator output at iteration 2 flags that
    column DIVERGED with its last finite iterate; the others converge with
    the iterations of the clean solve."""
    rng = np.random.default_rng(3)
    a = _spd(rng, 16)
    b = a @ rng.standard_normal((16, 4))

    def japply(x, it):
        y = jnp.asarray(a) @ x
        return y.at[..., 1].set(jnp.where(it == 2, jnp.nan, y[..., 1]))

    japply.takes_iteration = True
    jres = jpcg_block(japply, jnp.asarray(b), tol=1e-12, max_iter=100)
    calls = {"n": 0}

    def tapply(x):          # call 0 is the initial residual, k+1 iteration k
        y = torch.as_tensor(a) @ x
        if calls["n"] == 3:
            y[:, 1] = float("nan")
        calls["n"] += 1
        return y

    tres = tpcg_block(tapply, torch.as_tensor(b), tol=1e-12, max_iter=100)
    _same_block(jres, tres)
    np.testing.assert_array_equal(
        tres.status.numpy(), [SolveStatus.CONVERGED, SolveStatus.DIVERGED,
                              SolveStatus.CONVERGED, SolveStatus.CONVERGED])
    assert int(tres.iterations[1]) == 2


def test_pcg_block_stagnation_window(x64):
    """With a stagnation window, a column with a component along the null
    direction of a semidefinite operator makes no new residual minimum and
    stops STAGNATED; its sibling in the range converges."""
    diag = np.array([1.0, 2.0, 3.0, 5.0, 0.0])
    b = np.array([[1.0, 1.0], [1.0, 2.0], [1.0, 0.5], [1.0, 1.0],
                  [1.0, 0.0]])

    def op(v, xp):
        w = jnp.asarray(diag) if xp is jnp else torch.as_tensor(diag)
        return w[:, None] * v

    jres, tres = _both_blocks(op, b, tol=1e-12, max_iter=100,
                              stagnation_window=3)
    _same_block(jres, tres)
    np.testing.assert_array_equal(
        tres.status.numpy(), [SolveStatus.STAGNATED, SolveStatus.CONVERGED])


def test_pcg_block_bf16_columns_reduce_in_fp32():
    rng = np.random.default_rng(3)
    a = _spd(rng, 1024) + 3.0 * np.eye(1024)
    b = rng.standard_normal((1024, 3))
    b = b / np.linalg.norm(b, axis=0)
    a16 = torch.as_tensor(a, dtype=torch.bfloat16)
    res = tpcg_block(lambda v: a16 @ v,
                     torch.as_tensor(b, dtype=torch.bfloat16), tol=5e-3,
                     max_iter=100)
    assert res.residual.dtype == torch.float32
    assert res.x.dtype == torch.bfloat16
    assert (res.status == SolveStatus.CONVERGED).all()


# --------------------------------------------------- the Nekbone solve ----

def _mesh(shape=(2, 2, 2), order=3):
    return jmesh.deform_trilinear(jmesh.box_mesh(*shape, order), seed=3)


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("variant,helm", [("trilinear", False),
                                          ("merged", True)])
def test_batched_operator_matches_reference_and_columns(x64, variant, helm,
                                                        d):
    """(Ng[, d], nrhs) through one application: the reference package's
    batched operator, and the port's own column-by-column application."""
    jm = _mesh()
    kw = dict(variant=variant, helmholtz=helm, d=d)
    jp = jnek.setup_problem(jm, dtype=jnp.float64, backend="reference", **kw)
    tp = tnek.setup_problem(convert.mesh_from_numpy(jm), dtype=torch.float64,
                            device="cpu", **kw)
    shape = (jm.n_global,) + ((d,) if d > 1 else ()) + (3,)
    x = np.random.default_rng(5).standard_normal(shape)
    y_t = tp.op(torch.as_tensor(x))
    assert _rel(y_t, jp.op(jnp.asarray(x))) <= RTOL64
    for c in range(3):
        assert _rel(y_t[..., c], tp.op(torch.as_tensor(x[..., c]))) \
            <= RTOL64
    xt = torch.as_tensor(x)
    assert _rel(tnek.rhs_from_solution(tp, xt),
                jnek.rhs_from_solution(jp, jnp.asarray(x))) <= RTOL64


@pytest.mark.parametrize("variant,helm,d", [("trilinear", False, 1),
                                            ("trilinear", False, 3),
                                            ("merged", True, 1),
                                            ("partial", False, 1)])
def test_stacked_solve_matches_reference(variant, helm, d):
    jm = _mesh((3, 3, 2))
    nrhs = 4
    kw = dict(variant=variant, helmholtz=helm, d=d)
    shape = (jm.n_global,) + ((d,) if d > 1 else ()) + (nrhs,)
    x_true = np.random.default_rng(6).standard_normal(shape).astype(
        np.float32)
    jp = jnek.setup_problem(jm, backend="reference", **kw)
    jres = jnek.solve(jp, jnek.rhs_from_solution(jp, jnp.asarray(x_true)),
                      tol=1e-6, max_iter=400)
    tp = tnek.setup_problem(convert.mesh_from_numpy(jm), device="cpu", **kw)
    xt = torch.as_tensor(x_true)
    tres = tnek.solve(tp, tnek.rhs_from_solution(tp, xt), tol=1e-6,
                      max_iter=400)
    assert tres.x.shape == shape and tres.status.shape == (nrhs,)
    np.testing.assert_array_equal(tres.status.numpy(),
                                  np.asarray(jres.status))
    assert (tres.status == SolveStatus.CONVERGED).all()
    assert np.all(np.abs(tres.iterations.numpy()
                         - np.asarray(jres.iterations)) <= 1)
    assert tnek.manufactured_error(tp, tres.x, xt) < 1e-4


@pytest.mark.parametrize("precision", [None, "bf16_x32"])
def test_nrhs_one_is_the_single_rhs_path(precision):
    """A trailing axis of size 1 gives exactly the unbatched solve."""
    mesh = convert.mesh_from_numpy(_mesh())
    p = tnek.setup_problem(mesh, device="cpu", precision=precision)
    b = tnek.rhs_from_solution(p, tnek.random_solution(p, seed=2))
    single = tnek.solve(p, b, tol=1e-4, max_iter=200)
    stacked = tnek.solve(p, b[:, None], tol=1e-4, max_iter=200)
    assert stacked.x.shape == (mesh.n_global, 1)
    assert torch.equal(stacked.x[:, 0], single.x)
    for field in ("iterations", "residual", "initial_residual", "breakdown",
                  "status"):
        got, want = getattr(stacked, field), getattr(single, field)
        assert got.shape == (1,) and torch.equal(got[0], want), field


def test_random_solution_stacks_columns():
    mesh = convert.mesh_from_numpy(_mesh())
    p = tnek.setup_problem(mesh, device="cpu", d=3)
    x = tnek.random_solution(p, seed=0, nrhs=4)
    assert x.shape == (mesh.n_global, 3, 4)
    assert torch.equal(tnek.random_solution(p, seed=0, nrhs=1),
                       x.new_tensor(np.random.default_rng(0).standard_normal(
                           (mesh.n_global, 3))))


def test_cli_stacked_rhs(capsys):
    nekbone_solve.main(["--elements", "2", "2", "2", "--order", "3",
                        "--nrhs", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "nrhs=3" in out and "iters/column=[" in out and "wall/rhs=" in out
    line = out.strip().splitlines()[-1]
    assert line.startswith("status=['CONVERGED', 'CONVERGED', 'CONVERGED']")
