"""The port's solve service (`repro_torch.serving`) on the CPU: every test
of tests/test_solve_service.py, the two serving tests of
tests/test_mixed_precision.py and the two of tests/test_resilience.py,
each on the same 2x2x1 order-3 trilinear mesh (2x2x2 order 4 in float64
for the resilience pair), with ``NoRetrace.counts`` as an equality of
`trace_count` (on the CPU it counts the loops and operators the cache
builds; on a card the graphs it captures — tests/test_torch_serving_cuda.py).

Added: parity with the JAX `SolveService` on the same numpy inputs (per
request the same status and rungs; fp32 iterations within +-1 and x
within 1e-4 of max|x|; a bf16_x32 stream's iterations within
max(3, 10%) and x within 1e-2, see `PARITY`); padded columns bitwise
neutral — which the reference's own test of it does not meet (ROADMAP
Queue 3, item 3); one RHS at column 0 of blocks of width 1-8 with the
same x bits at every width; `prepare` on a zero block; a sharded problem
refused; the CLI on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mesh_gen as jmesh
from repro.core import nekbone as jnek
from repro.serving.solve_service import SolveRequest as JRequest
from repro.serving.solve_service import SolveService as JService
from repro_torch import serve_solves
from repro_torch.core import mesh_gen, nekbone
from repro_torch.core.pcg import pcg_block
from repro_torch.resilience.retry import RetryPolicy, solve_resilient
from repro_torch.resilience.status import SolveStatus
from repro_torch.serving import solve_service
from repro_torch.serving.bucket_cache import (BucketedSolveCache,
                                              bucket_sizes, problem_key)
from repro_torch.serving.solve_service import SolveRequest, SolveService

CPU = "cpu"
TOL = 1e-6


def _mesh():
    return mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 2, 1, 3), seed=3)


@pytest.fixture(scope="module")
def poisson():
    mesh = _mesh()
    return mesh, nekbone.setup_problem(mesh, variant="trilinear", device=CPU)


def _rhs(prob, rng):
    return nekbone.rhs_from_solution(prob, torch.as_tensor(
        rng.standard_normal(prob.mesh.n_global), dtype=prob.diag.dtype))


def _norm30(mesh, rng):
    """A float32 numpy RHS: standard normal, zero on the boundary, 2-norm
    30 (the mixed-precision tests' right-hand side)."""
    b = rng.standard_normal(mesh.n_global).astype(np.float32)
    b[np.asarray(mesh.boundary)] = 0.0
    return b / np.linalg.norm(b) * np.float32(30.0)


# ------------------------------------------------ bucket ladder, keys ----

def test_bucket_ladder_shapes():
    assert bucket_sizes(1) == (1,)
    assert bucket_sizes(4) == (1, 2, 4)
    assert bucket_sizes(8) == (1, 2, 4, 8)
    assert bucket_sizes(6) == (1, 2, 4, 6)
    with pytest.raises(ValueError, match="max_batch"):
        bucket_sizes(0)


def test_cache_key_separates_rebuilt_problems(poisson):
    mesh, prob = poisson
    k = problem_key(prob)
    assert k == problem_key(prob)
    low = nekbone.setup_problem(mesh, variant="trilinear",
                                dtype=torch.bfloat16, device=CPU)
    assert problem_key(low) != k   # dtype is part of the key
    mixed = nekbone.setup_problem(mesh, variant="trilinear",
                                  precision="bf16_x32", device=CPU)
    assert problem_key(mixed) != k  # so is the precision tag
    # and the device: a CPU and a CUDA build on one mesh are two entries
    assert problem_key(prob._replace(device=torch.device("cuda"))) != k
    cache = BucketedSolveCache(max_batch=4, tol=TOL)
    assert cache.bucket_for(3) == 4
    assert cache.bucket_for(4) == 4
    assert cache.bucket_for(9) == 9


# ------------------------------------------------ the trace-count gate ----

def test_warmup_then_randomized_depths_trace_nothing(poisson):
    _, prob = poisson
    svc = SolveService(prob, max_batch=8, tol=TOL, max_iter=200)
    warm = svc.warmup()
    # one solver per bucket + the verify operator at each bucket shape
    assert warm == 2 * len(svc.cache.buckets)
    rng = np.random.default_rng(0)
    depth_rng = np.random.default_rng(1)
    reqs = []
    while len(reqs) < 20:
        for _ in range(int(depth_rng.integers(1, svc.max_batch + 1))):
            req = SolveRequest(uid=len(reqs), b=_rhs(prob, rng))
            svc.submit(req)
            reqs.append(req)
        svc.step()
    svc.run_until_drained()
    assert svc.trace_count == warm
    assert all(r.done and r.report.converged for r in reqs)


def test_unwarmed_service_traces_on_demand(poisson):
    _, prob = poisson
    svc = SolveService(prob, max_batch=2, tol=TOL, max_iter=200)
    rng = np.random.default_rng(2)
    for uid in range(2):
        svc.submit(SolveRequest(uid=uid, b=_rhs(prob, rng)))
    svc.step()
    first = svc.trace_count
    assert first > 0
    for uid in range(2, 4):
        svc.submit(SolveRequest(uid=uid, b=_rhs(prob, rng)))
    svc.step()
    assert svc.trace_count == first


# ------------------------------------------- padding and bit parity ----

def test_bucketed_single_request_bit_parity(poisson):
    """Bucket 1: bitwise the direct single-RHS `solve_resilient`."""
    _, prob = poisson
    rng = np.random.default_rng(3)
    b = _rhs(prob, rng)
    svc = SolveService(prob, max_batch=8, tol=TOL, max_iter=200)
    svc.warmup()
    req = SolveRequest(uid=0, b=b)
    svc.submit(req)
    svc.step()
    ref = solve_resilient(prob, b, tol=TOL, max_iter=200)
    assert req.report.converged and ref.converged
    assert torch.equal(req.report.x, ref.x)
    assert int(req.report.iterations[0]) == int(ref.iterations[0])


def test_padded_columns_are_bit_neutral(poisson):
    """3 requests pack into bucket 4 (one zero-padded column): every real
    column is bitwise the direct unpadded 3-column block solve's, and the
    reports carry length-1 arrays."""
    _, prob = poisson
    rng = np.random.default_rng(4)
    bs = [_rhs(prob, rng) for _ in range(3)]
    svc = SolveService(prob, max_batch=4, tol=TOL, max_iter=200)
    svc.warmup()
    reqs = [SolveRequest(uid=i, b=b) for i, b in enumerate(bs)]
    for r in reqs:
        svc.submit(r)
    assert svc.step() == 3
    ref = solve_resilient(prob, torch.stack(bs, dim=-1), tol=TOL,
                          max_iter=200)
    for j, req in enumerate(reqs):
        assert torch.equal(req.report.x, ref.x[..., j]), j
        assert int(req.report.iterations[0]) == int(ref.iterations[j])
        assert req.report.status.shape == (1,)
        assert len(req.report.rung) == 1


def test_padded_column_never_flips_a_real_columns_status(poisson):
    _, prob = poisson
    rng = np.random.default_rng(5)
    good = [SolveRequest(uid=i, b=_rhs(prob, rng)) for i in range(2)]
    bad = SolveRequest(uid=9, b=torch.full((prob.mesh.n_global,),
                                           float("nan")))
    svc = SolveService(prob, max_batch=4, tol=TOL, max_iter=200)
    warm = svc.warmup()
    for r in (good[0], bad, good[1]):
        svc.submit(r)
    assert svc.step() == 3
    assert svc.trace_count == warm
    for r in good:
        assert r.done and r.error is None and r.report.converged
        assert int(r.report.status[0]) == SolveStatus.CONVERGED
    assert bad.done and bad.error is None
    assert not bad.report.converged
    assert int(bad.report.status[0]) == SolveStatus.DIVERGED
    assert [a.rung for a in bad.report.attempts] == ["initial", "restart"]


@pytest.mark.parametrize("fill", ["random", "zero"])
def test_column_has_the_same_bits_at_every_width(poisson, fill):
    """One RHS at column 0 of `pcg_block` blocks of width 1-8, the other
    columns random right-hand sides or zero: the same x bits and
    iterations at every width."""
    _, prob = poisson
    rng = np.random.default_rng(10)
    b0 = _rhs(prob, rng)
    others = torch.stack([_rhs(prob, rng) for _ in range(7)], dim=-1)
    if fill == "zero":
        others = torch.zeros_like(others)
    inv = 1.0 / prob.diag[:, None]
    xs, iters = [], []
    for width in range(1, 9):
        b = torch.cat([b0[:, None], others[:, :width - 1]], dim=-1)
        res = pcg_block(prob.op, b, precond=lambda r: inv * r, tol=TOL,
                        max_iter=200)
        xs.append(res.x[:, 0])
        iters.append(int(res.iterations[0]))
    assert all(torch.equal(x, xs[1]) for x in xs[1:])
    assert torch.equal(xs[0], xs[1])
    assert len(set(iters)) == 1, iters


# -------------------------------------------- prepare, zero captures ----

@pytest.mark.parametrize("precision", [None, "bf16_x32"])
def test_prepare_builds_each_width_once(precision):
    """`solve_block.prepare` builds each width's loop once (on_capture
    once per width, at preparation); a zero block then solves through it
    without building anything, x stays zero, CONVERGED after 0
    iterations."""
    prob = nekbone.setup_problem(_mesh(), variant="trilinear", device=CPU,
                                 precision=precision)
    widths = []
    solve_block = nekbone.make_block_solver(prob, tol=1e-4, max_iter=400,
                                            on_capture=widths.append)
    ng = prob.mesh.n_global
    for w in (1, 2, 4, 8):
        solve_block.prepare((ng, w))
        solve_block.prepare((ng, w))
    assert widths == [(ng, 1), (ng, 2), (ng, 4), (ng, 8)]
    built = prob.graphs.builds
    for w in (1, 4):
        z = torch.zeros(ng, w)
        res = solve_block(z, torch.zeros_like(z))
        assert torch.equal(res.x, z)
        assert res.status.tolist() == [SolveStatus.CONVERGED] * w
        assert res.iterations.tolist() == [0] * w
    b = torch.as_tensor(np.stack([_norm30(prob.mesh, np.random.default_rng(
        s)) for s in range(3)], axis=-1))
    res = solve_block(torch.cat([b, torch.zeros(ng, 1)], dim=-1),
                      torch.zeros(ng, 4))
    assert res.status.tolist() == [SolveStatus.CONVERGED] * 4
    assert prob.graphs.builds == built
    assert len(widths) == 4
    with pytest.raises(ValueError, match="rank"):
        solve_block.prepare((ng,))


def test_sharded_problem_refused(poisson):
    _, prob = poisson
    sharded = nekbone.ShardedNekboneProblem(
        op=prob.op, diag=prob.diag, mask=prob.mask, mesh=prob.mesh,
        basis=prob.basis, d=1, helmholtz=False, variant="trilinear",
        backend="reference", device=torch.device(CPU), shard_ctx=None,
        partition=None, run_pcg=None)
    with pytest.raises(ValueError, match="sharded"):
        SolveService(sharded)


# ---------------------------------------------- validation at the door ----

def test_submit_rejects_batched_rhs(poisson):
    mesh, prob = poisson
    svc = SolveService(prob)
    with pytest.raises(ValueError, match="single"):
        svc.submit(SolveRequest(uid=0, b=torch.zeros(mesh.n_global, 2)))


def test_submit_rejects_wrong_length_at_the_door(poisson):
    mesh, prob = poisson
    svc = SolveService(prob, max_batch=4, tol=TOL, max_iter=200)
    rng = np.random.default_rng(6)
    ok = SolveRequest(uid=0, b=_rhs(prob, rng))
    svc.submit(ok)
    with pytest.raises(ValueError, match="dofs"):
        svc.submit(SolveRequest(uid=1, b=torch.zeros(mesh.n_global + 5)))
    assert len(svc.queue) == 1
    svc.step()
    assert ok.done and ok.report.converged


def test_submit_rejects_uncastable_dtype(poisson):
    _, prob = poisson
    svc = SolveService(prob)
    with pytest.raises(TypeError, match="cast"):
        svc.submit(SolveRequest(
            uid=0, b=np.array(["x"] * prob.mesh.n_global, dtype=object)))
    assert not svc.queue


# ------------------------------- batch loss: pop on success, isolate ----

def test_raising_solve_fails_offender_not_batch(poisson, monkeypatch):
    _, prob = poisson
    real = solve_service.solve_resilient

    def flaky(problem, b, *args, **kwargs):
        if bool(torch.isnan(b).any()):
            raise RuntimeError("mid-solve explosion")
        return real(problem, b, *args, **kwargs)

    monkeypatch.setattr(solve_service, "solve_resilient", flaky)
    svc = SolveService(prob, max_batch=4, tol=TOL, max_iter=200)
    rng = np.random.default_rng(7)
    good = [SolveRequest(uid=i, b=_rhs(prob, rng)) for i in range(2)]
    bad = SolveRequest(uid=9, b=torch.full((prob.mesh.n_global,),
                                           float("nan")))
    for r in (good[0], bad, good[1]):
        svc.submit(r)
    assert svc.step() == 3
    assert not svc.queue
    for r in good:
        assert r.done and r.error is None and r.report.converged
    assert bad.done and bad.report is None
    assert "mid-solve explosion" in bad.error
    assert svc.errors == 1 and svc.served == 2


def test_raising_rebuild_fails_request_structured():
    mesh = _mesh()
    prob = nekbone.setup_problem(mesh, variant="trilinear",
                                 dtype=torch.bfloat16, device=CPU)

    def bad_rebuild(backend=None, dtype=None, nrhs=None):
        raise RuntimeError("rebuild exploded")

    svc = SolveService(prob, max_batch=2, tol=1e-6, max_iter=50,
                       rebuild=bad_rebuild)
    req = SolveRequest(uid=0, b=torch.full((mesh.n_global,), float("nan"),
                                           dtype=torch.bfloat16))
    svc.submit(req)
    assert svc.step() == 1
    assert not svc.queue
    assert req.done and req.report is None
    assert "rebuild exploded" in req.error
    assert svc.errors == 1


# ------------------------------------------------ per-request latency ----

def test_per_request_latency_metrics(poisson):
    _, prob = poisson
    svc = SolveService(prob, max_batch=4, tol=TOL, max_iter=200)
    svc.warmup()
    rng = np.random.default_rng(8)
    reqs = [SolveRequest(uid=i, b=_rhs(prob, rng)) for i in range(3)]
    for r in reqs:
        svc.submit(r)
    svc.step()
    iters = [int(r.report.iterations[0]) for r in reqs]
    for r in reqs:
        assert r.queue_s >= 0
        assert r.solve_s > 0
        assert r.wall_s == pytest.approx(r.queue_s + r.solve_s)
    order_by_iters = np.argsort(iters)
    solve_s = [reqs[j].solve_s for j in order_by_iters]
    assert solve_s == sorted(solve_s)
    slowest = reqs[int(order_by_iters[-1])]
    assert all(r.solve_s <= slowest.solve_s + 1e-12 for r in reqs)


def test_drain_steps_and_served_counter(poisson):
    _, prob = poisson
    svc = SolveService(prob, max_batch=2, tol=TOL, max_iter=200)
    rng = np.random.default_rng(9)
    bs = [_rhs(prob, rng) for _ in range(3)]
    reqs = [SolveRequest(uid=i, b=b) for i, b in enumerate(bs)]
    for r in reqs:
        svc.submit(r)
    assert svc.run_until_drained() == 2
    assert svc.served == 3 and not svc.queue
    for req, b in zip(reqs, bs):
        r = b.double() - prob.op(req.report.x).double()
        assert float(torch.linalg.norm(r)) < 10 * TOL


# ------------------- tests/test_mixed_precision.py's serving tests ----

def test_service_warms_fp32_fallback_and_trace_gate():
    """Unmasked Helmholtz bf16_x32 lies outside refinement's envelope:
    every request climbs to precision:float32, and the warmed fallback
    ladder keeps the trace count flat."""
    mesh = _mesh()
    p = nekbone.setup_problem(mesh, helmholtz=True, dirichlet=False,
                              precision="bf16_x32", device=CPU)
    svc = SolveService(p, RetryPolicy(), max_batch=2, tol=1e-3,
                       max_iter=400)
    svc.warmup()
    t0 = svc.trace_count
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(3):
        b = rng.standard_normal(mesh.n_global).astype(np.float32)
        b = b / np.linalg.norm(b) * 30.0
        reqs.append(SolveRequest(uid=uid, b=torch.as_tensor(b)))
        svc.submit(reqs[-1])
    svc.run_until_drained()
    assert svc.trace_count == t0, (svc.trace_count, t0)
    assert svc.served == 3
    for r in reqs:
        assert r.done and r.report is not None and r.report.converged, \
            (r.error, None if r.report is None else r.report.rung)
        assert r.report.rung[0] == "precision:float32", r.report.rung


def test_service_bf16_x32_problem_round_trip():
    mesh = _mesh()
    p = nekbone.setup_problem(mesh, precision="bf16_x32", device=CPU)
    svc = SolveService(p, RetryPolicy(), max_batch=2, tol=1e-4,
                       max_iter=400)
    svc.warmup()
    t0 = svc.trace_count
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(3):
        b = rng.standard_normal(mesh.n_global).astype(np.float32)
        b = b / np.linalg.norm(b) * 30.0
        reqs.append(SolveRequest(uid=uid, b=b))
        svc.submit(reqs[-1])
    svc.run_until_drained()
    assert svc.trace_count == t0, (svc.trace_count, t0)
    for r in reqs:
        assert r.done and r.report is not None and r.report.converged, \
            (r.error, None if r.report is None else r.report.rung)
        assert r.report.rung[0] == "initial", r.report.rung


# ------------------------ tests/test_resilience.py's serving tests ----

@pytest.fixture(scope="module")
def poisson64():
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 2, 2, 4), seed=3)
    prob = nekbone.setup_problem(mesh, variant="trilinear",
                                 dtype=torch.float64, device=CPU)
    return mesh, prob


def test_solve_service_drains_and_reports(poisson64):
    mesh, prob = poisson64
    svc = SolveService(prob, max_batch=2, tol=1e-10, max_iter=300)
    rng = np.random.default_rng(3)
    bs = [_rhs(prob, rng) for _ in range(3)]
    reqs = [SolveRequest(uid=i, b=b) for i, b in enumerate(bs)]
    for req in reqs:
        svc.submit(req)
    assert svc.run_until_drained() == 2
    assert not svc.queue
    for req, b in zip(reqs, bs):
        assert req.done and req.report.converged
        assert req.report.x.shape == b.shape
        r = b - prob.op(req.report.x)
        assert float(torch.linalg.norm(r)) < 1e-8


def test_solve_service_rejects_batched_rhs(poisson64):
    mesh, prob = poisson64
    svc = SolveService(prob)
    with pytest.raises(ValueError, match="single"):
        svc.submit(SolveRequest(uid=0, b=torch.zeros(mesh.n_global, 2,
                                                     dtype=torch.float64)))


# ------------------------------------ parity with the JAX service ----

# (precision, tol, x bound relative to max|x|, iteration slack as a
# share): bf16_x32 answers agree to the tolerance reached, not to fp32
# rounding, and its inner iterations within max(3, 10%), the bound of
# tests/test_torch_precision.py — the two frameworks round the bf16 inner
# iterates at other places, so the inner trajectories drift apart
PARITY = [(None, 1e-6, 1e-4, 0.0), ("bf16_x32", 1e-4, 1e-2, 0.1)]


@pytest.mark.parametrize("precision,tol,x_rtol,share", PARITY,
                         ids=["fp32", "bf16_x32"])
def test_service_matches_jax_service(precision, tol, x_rtol, share):
    """The same numpy right-hand sides, arriving in the same groups (3, 1,
    2), through the port's and the reference's services: per request the
    same status and rungs, iterations within +-1 (fp32; bf16_x32 within
    max(3, 10%)), x within `x_rtol`."""
    box = mesh_gen.box_mesh(2, 2, 1, 3)
    jbox = jmesh.box_mesh(2, 2, 1, 3)
    mesh = mesh_gen.deform_trilinear(box, seed=3)
    jm = jmesh.deform_trilinear(jbox, seed=3)
    prob = nekbone.setup_problem(mesh, variant="trilinear", device=CPU,
                                 precision=precision)
    jprob = jnek.setup_problem(jm, variant="trilinear", dtype=jnp.float32,
                               backend="reference", precision=precision)
    svc = SolveService(prob, max_batch=4, tol=tol, max_iter=400)
    jsvc = JService(jprob, max_batch=4, tol=tol, max_iter=400)
    rng = np.random.default_rng(11)
    ours, theirs = [], []
    for group in (3, 1, 2):
        for _ in range(group):
            b = _norm30(mesh, rng)
            ours.append(SolveRequest(uid=len(ours), b=b))
            theirs.append(JRequest(uid=len(theirs), b=jnp.asarray(b)))
            svc.submit(ours[-1])
            jsvc.submit(theirs[-1])
        svc.step()
        jsvc.step()
    assert svc.run_until_drained() == jsvc.run_until_drained() == 0
    for t, j in zip(ours, theirs):
        assert t.error is None and j.error is None
        assert t.report.status.tolist() == \
            np.asarray(j.report.status).tolist()
        assert t.report.rung == tuple(j.report.rung)
        it_t, it_j = int(t.report.iterations[0]), int(j.report.iterations[0])
        slack = 1 if not share else max(3, share * it_j)
        assert abs(it_t - it_j) <= slack, (it_t, it_j)
        jx = np.asarray(j.report.x, np.float64)
        rel = np.max(np.abs(t.report.x.double().numpy() - jx)) \
            / np.max(np.abs(jx))
        assert rel <= x_rtol, rel


def test_cli_serves_on_the_cpu(capsys):
    serve_solves.main(["--nx", "2", "--order", "3", "--max-batch", "4",
                       "--requests", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "warmup: 6 builds (bucket ladder (1, 2, 4))" in out
    assert "0 new builds after warmup (gate: 0), errors=0" in out
    assert out.count(": ok rung=initial") == 4
