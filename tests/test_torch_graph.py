"""The port's chunked solver loops (`core/pcg.py`, `core/graphs.py`) and
`make_block_solver` on the CPU, against the JAX reference.

The loops keep their state in fixed tensors, take the squared tolerance
and the iteration budget as device scalars of that state, and run in
chunks of `_CHECK_EVERY` gated bodies.  On the CPU the chunk runs eagerly
(on a card it is the chunk that is captured and replayed; see
tests/test_torch_cuda.py).  Tolerances: statuses equal to the
reference's, iterations within +-1, x within 1e-4 of max|x| in fp32 (the
two packages' dots round in other orders) and 1e-10 in fp64.
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
from repro.core.pcg import refine as jrefine
from repro_torch.core import graphs as tgraphs
from repro_torch.core import nekbone as tnek
from repro_torch.core import pcg as tpcg_mod
from repro_torch.core.pcg import pcg as tpcg
from repro_torch.core.pcg import pcg_block as tpcg_block
from repro_torch.core.pcg import refine as trefine
from repro_torch.resilience.status import SolveStatus

BF16 = torch.bfloat16
RTOL = {np.float32: 1e-4, np.float64: 1e-10}


def _spd(rng, n, boost=1.0):
    a = rng.standard_normal((n, n))
    return a @ a.T / n + boost * np.eye(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _close_iterations(t, j):
    return np.all(np.abs(np.asarray(t, np.int64)
                         - np.asarray(j, np.int64)) <= 1)


def _same(jres, tres, dt):
    np.testing.assert_array_equal(tres.status.numpy(),
                                  np.asarray(jres.status))
    assert _close_iterations(tres.iterations.numpy(), jres.iterations), \
        (tres.iterations, jres.iterations)
    assert _rel(tres.x.numpy(), jres.x) <= RTOL[dt], \
        _rel(tres.x.numpy(), jres.x)


def _dtype_context(dt):
    """x64 on for a float64 case, restored after."""
    class _Ctx:
        def __enter__(self):
            self.saved = jax.config.jax_enable_x64
            jax.config.update("jax_enable_x64", dt is np.float64)

        def __exit__(self, *exc):
            jax.config.update("jax_enable_x64", self.saved)
    return _Ctx()


# (name, boost, tol, max_iter, stagnation window, jacobi)
PCG_CASES = [("converges", 1.0, 1e-5, 200, 0, False),
             ("jacobi", 0.3, 1e-5, 300, 0, True),
             ("maxiter", 0.05, 1e-12, 13, 0, False),
             ("window", 0.0, 1e-30, 400, 7, False)]


@pytest.mark.parametrize("dt", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("name,boost,tol,max_iter,window,jacobi", PCG_CASES,
                         ids=[c[0] for c in PCG_CASES])
def test_pcg_chunks_match_reference(dt, name, boost, tol, max_iter, window,
                                    jacobi):
    rng = np.random.default_rng(7)
    n = 60
    a = _spd(rng, n, boost)
    if name == "window":       # an unattainable tol: the window stops it
        a = np.diag(np.logspace(-7 if dt is np.float32 else -10, 0, n))
    b = rng.standard_normal(n)
    inv = 1.0 / np.diag(a)
    with _dtype_context(dt):
        aj, bj, ij = (jnp.asarray(v, dt) for v in (a, b, inv))
        jres = jpcg(lambda v: aj @ v, bj, tol=tol, max_iter=max_iter,
                    stagnation_window=window,
                    precond=(lambda r: ij * r) if jacobi else None)
        at, bt, it = (torch.as_tensor(v.astype(dt)) for v in (a, b, inv))
        tres = tpcg(lambda v: at @ v, bt, tol=tol, max_iter=max_iter,
                    stagnation_window=window,
                    precond=(lambda r: it * r) if jacobi else None)
    _same(jres, tres, dt)
    if name == "maxiter":
        assert int(tres.status) == SolveStatus.MAXITER
        assert int(tres.iterations) == max_iter
    if name == "window":
        assert int(tres.status) == SolveStatus.STAGNATED


# (name, column scales, tol, max_iter)
BLOCK_CASES = [("converges", (1.0, 1e-3, 10.0), 1e-5, 300),
               ("frozen_zero_column", (1.0, 0.0, 2.0), 1e-5, 300),
               ("budget", (1.0, 3.0, 0.5), 1e-12, 9)]


@pytest.mark.parametrize("dt", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("name,scales,tol,max_iter", BLOCK_CASES,
                         ids=[c[0] for c in BLOCK_CASES])
def test_pcg_block_chunks_match_reference(dt, name, scales, tol, max_iter):
    rng = np.random.default_rng(8)
    n = 48
    a = _spd(rng, n)
    b = rng.standard_normal((n, len(scales))) * np.asarray(scales)
    with _dtype_context(dt):
        aj, bj = jnp.asarray(a, dt), jnp.asarray(b, dt)
        jres = jpcg_block(lambda v: aj @ v, bj, tol=tol, max_iter=max_iter)
        at, bt = torch.as_tensor(a.astype(dt)), torch.as_tensor(b.astype(dt))
        tres = tpcg_block(lambda v: at @ v, bt, tol=tol, max_iter=max_iter)
    _same(jres, tres, dt)
    if name == "budget":
        # the body counter caps the block at max_iter bodies, as the
        # reference's cond does
        assert (tres.iterations.numpy() == max_iter).all()
    if name == "frozen_zero_column":
        assert int(tres.iterations[1]) == 0


def _bf16_ops(a):
    """(fp32 operator, bf16 operator) of one dense matrix, per package."""
    a32j, a16j = jnp.asarray(a, jnp.float32), jnp.asarray(a, jnp.bfloat16)
    a32t = torch.as_tensor(np.asarray(a, np.float32))
    a16t = a32t.to(BF16)
    return ((lambda v: a32j @ v,
             lambda v: (a16j @ v.astype(jnp.bfloat16)).astype(v.dtype)),
            (lambda v: a32t @ v,
             lambda v: (a16t @ v.to(BF16)).to(v.dtype)))


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("tol", [1e-5, 1e-6])
def test_refine_chunks_match_reference(nrhs, tol):
    """Several sweeps (tol far below the bf16 operator's ~1e-2), each with
    its own inner tolerance; deep enough that x is held to 1e-4."""
    rng = np.random.default_rng(9)
    n = 200
    a = np.asarray(_spd(rng, n), np.float32)
    b = rng.standard_normal((n, nrhs) if nrhs > 1 else n).astype(np.float32)
    b /= np.linalg.norm(b, axis=0)
    (jhi, jlo), (thi, tlo) = _bf16_ops(a)
    batched = nrhs > 1
    jres = jrefine(jhi, jlo, jnp.asarray(b), tol=tol, max_iter=600,
                   batched=batched)
    tres = trefine(thi, tlo, torch.as_tensor(b), tol=tol, max_iter=600,
                   batched=batched)
    _same(jres, tres, np.float32)


def test_refine_inner_tolerance_changes_every_sweep():
    """The bf16 operator is 3 A, so every sweep lowers the true residual by
    a third whatever its inner target; the adaptive target
    0.5 tol / ||r|| then takes a new value in each of the last sweeps.
    The port runs the reference's sweeps (outer operator applications,
    counted in both) and iterations, on one inner loop."""
    rng = np.random.default_rng(10)
    n = 120
    a = np.asarray(_spd(rng, n, 2.0), np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    b /= np.linalg.norm(b)
    tol = 1e-2
    jcalls, tcalls = [], []
    a32j, a3j = jnp.asarray(a), jnp.asarray(3 * a, jnp.bfloat16)

    def jhi(v):
        jax.debug.callback(lambda: jcalls.append(1))
        return a32j @ v

    a32t = torch.as_tensor(a)
    a3t = torch.as_tensor(3 * a).to(BF16)

    def thi(v):
        tcalls.append(1)
        return a32t @ v

    jres = jrefine(jhi, lambda v: (a3j @ v.astype(jnp.bfloat16)).astype(
        v.dtype), jnp.asarray(b), tol=tol, max_iter=2000)
    jax.effects_barrier()
    graphs = tgraphs.GraphCache()
    tres = trefine(thi, lambda v: (a3t @ v.to(BF16)).to(v.dtype),
                   torch.as_tensor(b), tol=tol, max_iter=2000, graphs=graphs)
    _same(jres, tres, np.float32)
    assert len(tcalls) == len(jcalls) >= 8, (len(tcalls), len(jcalls))
    assert graphs.builds == 1          # one inner loop for every sweep


def test_repeat_solve_reuses_its_loop_and_new_tol_is_exact():
    """A second solve on one cache builds no loop; a solve at a new
    tolerance on a loop built at another gives the bits of a fresh one."""
    rng = np.random.default_rng(11)
    a = torch.as_tensor(_spd(rng, 40, 0.5))
    b = torch.as_tensor(rng.standard_normal(40))

    def op(v):
        return a @ v

    graphs = tgraphs.GraphCache()
    first = tpcg(op, b, tol=1e-3, graphs=graphs)
    second = tpcg(op, b, tol=1e-10, graphs=graphs)
    fresh = tpcg(op, b, tol=1e-10)
    assert graphs.builds == 1 and graphs.captures == 0
    assert int(second.iterations) > int(first.iterations)
    assert torch.equal(second.x, fresh.x)
    assert torch.equal(second.iterations, fresh.iterations)
    # results are copies: the later solve did not move the earlier one
    assert not torch.equal(first.x, second.x)
    again = tpcg(op, b, tol=1e-3, graphs=graphs)
    assert torch.equal(again.x, first.x)


def test_each_key_gets_its_own_loop():
    rng = np.random.default_rng(12)
    a = torch.as_tensor(_spd(rng, 30))
    graphs = tgraphs.GraphCache()

    def op(v):
        return a @ v

    b1 = torch.as_tensor(rng.standard_normal(30))
    b2 = torch.as_tensor(rng.standard_normal((30, 2)))
    tpcg(op, b1, graphs=graphs)
    tpcg(op, b1, graphs=graphs, stagnation_window=3)   # another window
    tpcg(op, b1, graphs=graphs, precond=lambda r: r)   # another precond
    tpcg_block(op, b2, graphs=graphs)                  # another kind
    tpcg(op, b1, graphs=graphs)                        # a repeat
    assert graphs.builds == 4 and len(graphs.loops) == 4


def test_capture_needs_a_card():
    b = torch.ones(3)
    with pytest.raises(ValueError, match="CUDA"):
        tpcg(lambda v: 2.0 * v, b, capture=True)


def test_operator_sees_the_iteration_counter():
    """An iteration-aware operator gets -1 for the initial residual, then
    the counted iteration (`pcg`) or the body count (`pcg_block`), as the
    reference passes them; gated bodies after the end see the last one."""
    a = torch.as_tensor(np.diag(np.arange(1.0, 7.0)))
    seen = {"pcg": [], "pcg_block": []}

    def op_for(kind):
        def op(x, it):
            seen[kind].append(int(it))
            return a @ x
        op.takes_iteration = True
        return op

    res = tpcg(op_for("pcg"), torch.ones(6, dtype=torch.float64),
               tol=1e-12)
    n = int(res.iterations)
    assert seen["pcg"][:n + 2] == [-1] + list(range(n + 1))
    assert set(seen["pcg"][n + 1:]) == {n}
    assert len(seen["pcg"]) % tpcg_mod._CHECK_EVERY == 1
    resb = tpcg_block(op_for("pcg_block"),
                      torch.ones((6, 2), dtype=torch.float64), tol=1e-12)
    nb = int(resb.iterations.max())
    assert seen["pcg_block"][:nb + 2] == [-1] + list(range(nb + 1))


def test_gated_chunk_changes_nothing():
    """After the end, a further chunk leaves every state tensor bitwise
    as it was (an inactive body is gated, not skipped)."""
    rng = np.random.default_rng(13)
    a = torch.as_tensor(_spd(rng, 20))
    graphs = tgraphs.GraphCache()
    tpcg(lambda v: a @ v, torch.as_tensor(rng.standard_normal(20)),
         tol=1e-6, graphs=graphs)
    (loop,) = graphs.loops.values()
    before = {k: v.clone() for k, v in loop.state.items()}
    assert not bool(loop.flag)
    loop.chunk()
    for k, v in loop.state.items():
        assert torch.equal(v, before[k]), k


def test_count_adds_one_outside_a_capture():
    counter = {"k": 0}
    tgraphs.count(counter, "k")
    tgraphs.count(counter, "k")
    assert counter == {"k": 2}


@pytest.fixture(scope="module")
def small_problem():
    jm = jmesh.deform_trilinear(jmesh.box_mesh(2, 2, 2, 3), seed=3)
    return jm, tnek.setup_problem(jm, variant="trilinear", device="cpu")


@pytest.mark.parametrize("precision", [None, "bf16_x32"])
def test_block_solver_builds_once_per_width(small_problem, precision):
    jm, prob = small_problem
    if precision:
        prob = tnek.setup_problem(jm, variant="trilinear", device="cpu",
                                  precision=precision)
    shapes = []
    solve_block = tnek.make_block_solver(prob, tol=1e-6, max_iter=300,
                                         on_capture=shapes.append)
    rng = np.random.default_rng(14)
    for width in (2, 4, 2, 1, 4, 1):
        b = torch.as_tensor(rng.standard_normal((jm.n_global, width)),
                            dtype=torch.float32)
        res = solve_block(b, torch.zeros_like(b))
        ref = tnek.solve(prob, b, tol=1e-6, max_iter=300)
        assert torch.equal(res.x, ref.x)
        assert torch.equal(res.iterations, ref.iterations)
    assert shapes == [(jm.n_global, 2), (jm.n_global, 4), (jm.n_global, 1)]


def test_block_solver_matches_reference_block_solver(small_problem):
    jm, prob = small_problem
    jprob = jnek.setup_problem(jm, variant="trilinear")
    rng = np.random.default_rng(15)
    b = rng.standard_normal((jm.n_global, 3)).astype(np.float32)
    traced = []
    jsolve = jnek.make_block_solver(jprob, tol=1e-6, max_iter=300,
                                    on_trace=traced.append)
    jres = jsolve(jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)))
    tsolve = tnek.make_block_solver(prob, tol=1e-6, max_iter=300)
    tres = tsolve(torch.as_tensor(b), torch.zeros(b.shape))
    _same(jres, tres, np.float32)


def test_solve_keeps_one_loop_per_problem_and_width(small_problem):
    jm, prob = small_problem
    prob = tnek.setup_problem(jm, variant="trilinear", device="cpu")
    b = tnek.rhs_from_solution(prob, tnek.random_solution(prob, seed=0))
    first = tnek.solve(prob, b, tol=1e-6)
    again = tnek.solve(prob, b, tol=1e-6)
    assert prob.graphs.builds == 1
    assert torch.equal(first.x, again.x)
    tnek.solve(prob, b, tol=1e-6, precond="copy")      # another precond
    tnek.solve(prob, torch.stack([b, b], -1), tol=1e-6)
    assert prob.graphs.builds == 3
