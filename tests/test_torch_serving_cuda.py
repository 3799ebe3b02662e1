"""The solve service on the card: the bucketed block solves replayed from
the CUDA graphs that warm-up captures, through the hand-written kernels.

Checks: no capture after warm-up (the ladder's solver loops and
verification operators are all captured by `warmup`, without solving);
padded columns bitwise neutral at widths 3 -> 4 and 5 -> 8 against the
direct unpadded block solve; a bf16_x32 service (its fp32 fallback ladder
warmed too) that captures nothing after warm-up; the kernels launched
by a served stream (`ops.launch_counts`); and the column dot's bits at
block widths 1-8 on the card.

Every test carries the `cuda` marker and skips without a card, decided in
the `card` fixture at run time.  Run on the card:
``python -m pytest -q -m cuda tests/test_torch_serving_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mesh_gen, nekbone, pcg
from repro_torch.kernels.axhelm import ops
from repro_torch.resilience.retry import solve_resilient
from repro_torch.resilience.status import SolveStatus
from repro_torch.serving.solve_service import SolveRequest, SolveService

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(card, precision=None):
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(4, 4, 4, 7), seed=3)
    return nekbone.setup_problem(mesh, variant="trilinear", backend="cuda",
                                 device=card, precision=precision)


def _rhs(prob, n, seed):
    return [nekbone.rhs_from_solution(prob, nekbone.random_solution(
        prob, seed=seed + j)) for j in range(n)]


def test_service_captures_nothing_after_warmup(card):
    prob = _problem(card)
    svc = SolveService(prob, max_batch=8, tol=TOL, max_iter=1000)
    warm = svc.warmup()
    assert warm == 2 * len(svc.cache.buckets) == 8
    reqs = [SolveRequest(uid=i, b=b) for i, b in enumerate(_rhs(prob, 15,
                                                                 0))]
    depths = np.random.default_rng(1)
    pending = list(reqs)
    while pending:
        for _ in range(int(depths.integers(1, 9))):
            if pending:
                svc.submit(pending.pop(0))
        svc.step()
    svc.run_until_drained()
    assert svc.trace_count == warm
    assert svc.errors == 0
    assert all(r.done and r.report.converged for r in reqs)


@pytest.mark.parametrize("n,bucket", [(3, 4), (5, 8)])
def test_padded_columns_are_bit_neutral_on_the_card(card, n, bucket):
    prob = _problem(card)
    svc = SolveService(prob, max_batch=bucket, tol=TOL, max_iter=1000)
    svc.warmup()
    bs = _rhs(prob, n, 10)
    reqs = [SolveRequest(uid=i, b=b) for i, b in enumerate(bs)]
    for r in reqs:
        svc.submit(r)
    assert svc.step() == n
    ref = solve_resilient(prob, torch.stack(bs, dim=-1), tol=TOL,
                          max_iter=1000)
    assert ref.converged
    for j, req in enumerate(reqs):
        assert torch.equal(req.report.x, ref.x[..., j]), j
        assert int(req.report.iterations[0]) == int(ref.iterations[j])


def test_bf16_x32_service_captures_nothing_after_warmup(card):
    prob = _problem(card, precision="bf16_x32")
    svc = SolveService(prob, max_batch=4, tol=0.03, max_iter=3000)
    warm = svc.warmup()
    # the bf16_x32 ladder and its precision:float32 fallback ladder
    assert warm == 2 * 2 * len(svc.cache.buckets)
    reqs = []
    for j in range(3):
        b = nekbone.random_rhs(prob, nrhs=3)[:, j]
        reqs.append(SolveRequest(uid=j, b=b))
        svc.submit(reqs[-1])
    svc.run_until_drained()
    assert svc.trace_count == warm
    for r in reqs:
        assert r.report.converged, (r.error, r.report)


def test_served_stream_launches_the_kernels(card):
    prob = _problem(card)
    svc = SolveService(prob, max_batch=4, tol=TOL, max_iter=1000)
    svc.warmup()
    name = ops.entry_point("trilinear", torch.float32)
    ops.reset_launch_counts()
    reqs = [SolveRequest(uid=i, b=b) for i, b in enumerate(_rhs(prob, 3,
                                                                20))]
    for r in reqs:
        svc.submit(r)
    svc.step()
    launches = dict(ops.launch_counts)
    assert launches[name] > 0
    assert {k for k, v in launches.items() if v} == {name}
    for r in reqs:
        assert int(r.report.status[0]) == SolveStatus.CONVERGED


@pytest.mark.parametrize("n", [25992, 1442897])
def test_column_dot_is_width_independent_on_the_card(card, n):
    """`pcg._column_dot`: column 0 of blocks of width 1-8 (the other
    columns random) has the bits of the width-1 dot, and a column moved
    to another place keeps them."""
    gen = torch.Generator(device=card).manual_seed(0)
    u = torch.randn((n, 8), generator=gen, device=card)
    v = torch.randn((n, 8), generator=gen, device=card)
    ref = pcg._column_dot(u[:, :1], v[:, :1])[0]
    for width in range(1, 9):
        uu, vv = u[:, :width].contiguous(), v[:, :width].contiguous()
        assert torch.equal(pcg._column_dot(uu, vv)[0], ref), width
        rolled = pcg._column_dot(torch.roll(uu, 1, 1), torch.roll(vv, 1, 1))
        assert torch.equal(rolled[1 % width], ref), width
