"""Card tests of the plane body (`csrc/axhelm_plane.cu`): every entry
point, float32 and bfloat16 storage, at N1 = 25, 32 and 48, E = 5 and 64,
one and three columns (the factors held for every column), against its
plain PyTorch version; the launch counted under the entry point; a
captured application replayed twice, bitwise the eager one; an order-31
solve through the kernels against the reference backend; one past the
cap, the staged body.

Every test carries the `cuda` marker and skips without a card; whether a
card is present is decided in the `card` fixture, at run time.  This file
imports neither jax nor the reference package:

    python -m pytest -q -m cuda tests/test_torch_plane_cuda.py

Tolerance: max|y_kernel - y_plain| / max|y_plain| <= 1e-4 for float32 (the
kernel sums in another order than the einsums) and 8e-3 for bfloat16 (one
bf16 ulp of the largest entry: both round one float32 result once).
"""

import pytest
import torch

from repro_torch.core import mesh_gen, nekbone
from repro_torch.kernels.axhelm import ops
from repro_torch.resilience.status import SolveStatus

from test_torch_cuda import _VARIANT_EQUATIONS, _operands, card  # noqa: F401

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,ncols", [(5, 3), (64, 1)])
@pytest.mark.parametrize("n", [24, 31, 47])
@pytest.mark.parametrize("variant,helm", _VARIANT_EQUATIONS)
def test_plane_body_matches_plain_version(card, variant, helm, n, e,
                                          ncols, dtype):
    b, x, geom, kw = _operands(variant, n, e, ncols, helm, card,
                               dtype=dtype)
    assert ops.body_of(variant, b.n1) == "plane"
    name = ops.entry_point(variant, dtype)
    before = ops.launch_counts[name]
    y = ops.axhelm(x, b, variant, geom, **kw)
    torch.cuda.synchronize()
    assert y.dtype == dtype and ops.launch_counts[name] == before + 1
    y_plain = ops.reference(x, b, variant, geom, **kw).float()
    assert bool(torch.isfinite(y.float()).all())
    err = float((y.float() - y_plain).abs().max() / y_plain.abs().max())
    assert err <= RTOL[dtype], err


@pytest.mark.parametrize("ncols", [1, 3])
@pytest.mark.parametrize("variant,helm", _VARIANT_EQUATIONS)
def test_captured_application_replays_bitwise(card, variant, helm, ncols):
    """One fp32 application at N1 = 32, E = 64, captured in a CUDA graph
    (its scratch from the graph's pool) and replayed twice: each replay
    bitwise the eager call's output."""
    b, x, geom, kw = _operands(variant, 31, 64, ncols, helm, card)
    eager = ops.axhelm(x, b, variant, geom, **kw)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.axhelm(x, b, variant, geom, **kw)          # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = ops.axhelm(x, b, variant, geom, **kw)
    for _ in range(2):
        y.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, eager)
    del graph


@pytest.mark.parametrize("variant,helm", [("trilinear", False),
                                          ("partial", False),
                                          ("merged", True)])
def test_order_31_solve_matches_reference_backend(card, variant, helm):
    """2x1x1 at order 31 through the plane body, captured, against the
    plain version on the card: the same status, x within 1e-3, iterations
    within +-1 for Poisson and within 1% for unmasked Helmholtz, whose
    ~700 fp32 iterations drift with the order of the sums
    (chip_smoke.HIGH_ORDER_HELMHOLTZ_ITER_SHARE)."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 1, 1, 31), seed=3)
    out = {}
    for backend in ("cuda", "reference"):
        prob = nekbone.setup_problem(mesh, variant=variant, helmholtz=helm,
                                     backend=backend)
        b = nekbone.rhs_from_solution(prob, nekbone.random_solution(prob))
        out[backend] = nekbone.solve(prob, b, tol=1e-6, max_iter=2000)
    k, r = out["cuda"], out["reference"]
    assert int(k.status) == int(r.status) == SolveStatus.CONVERGED
    slack = max(1, int(0.01 * int(r.iterations))) if helm else 1
    assert abs(int(k.iterations) - int(r.iterations)) <= slack
    assert float((k.x - r.x).abs().max() / r.x.abs().max()) <= 1e-3


def test_above_the_cap_the_wrapper_and_setup_run_the_staged_body(card):
    """Order 48 (N1 = 49), one past the plane body's cap: the wrapper
    and setup on the card run the staged body, counted under the entry
    point, with no backend argument."""
    n_big = ops.N1_PLANE_MAX            # order 48, N1 = 49
    b, x, geom, kw = _operands("trilinear", n_big, 1, 1, False, card)
    assert ops.body_of("trilinear", b.n1) == "staged"
    name = ops.entry_point("trilinear", torch.float32)
    before = ops.launch_counts[name]
    y = ops.axhelm(x, b, "trilinear", geom, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts[name] == before + 1
    y_plain = ops.reference(x, b, "trilinear", geom, **kw)
    assert float((y - y_plain).abs().max() / y_plain.abs().max()) <= 1e-4
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(1, 1, 1, n_big))
    prob = nekbone.setup_problem(mesh, variant="trilinear")
    assert prob.backend == "cuda"
    before = ops.launch_counts[name]
    prob.op(nekbone.random_solution(prob))
    torch.cuda.synchronize()
    assert ops.launch_counts[name] == before + 1
