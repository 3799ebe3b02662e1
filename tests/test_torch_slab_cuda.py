"""Card tests of the slab body (`csrc/axhelm_slab.cu`): every entry point,
float32 and bfloat16 storage, at N1 = 17, 20 and 24, E = 5 and 216, one and
three columns (the factors held for every column), through its twin
`ops.slab` against its plain PyTorch version, counting nothing; a captured
application at the order-19 main path's shape, replayed twice, bitwise the
eager one; an order-19 solve through the kernels against the reference
backend.

Every test carries the `cuda` marker and skips without a card; whether a
card is present is decided in the `card` fixture, at run time.  This file
imports neither jax nor the reference package:

    python -m pytest -q -m cuda tests/test_torch_slab_cuda.py

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
@pytest.mark.parametrize("e,ncols", [(5, 3), (216, 1)])
@pytest.mark.parametrize("n", [16, 19, 23])
@pytest.mark.parametrize("variant,helm", _VARIANT_EQUATIONS)
def test_slab_body_matches_plain_version(card, variant, helm, n, e, ncols,
                                         dtype):
    b, x, geom, kw = _operands(variant, n, e, ncols, helm, card,
                               dtype=dtype)
    before = dict(ops.launch_counts)
    y = ops.slab(x, b, variant, geom, **kw)
    torch.cuda.synchronize()
    assert y.dtype == dtype and ops.launch_counts == before
    y_plain = ops.reference(x, b, variant, geom, **kw).float()
    assert bool(torch.isfinite(y.float()).all())
    err = float((y.float() - y_plain).abs().max() / y_plain.abs().max())
    assert err <= RTOL[dtype], err


@pytest.mark.parametrize("ncols", [1, 3])
@pytest.mark.parametrize("variant,helm", _VARIANT_EQUATIONS)
def test_captured_application_replays_bitwise(card, variant, helm, ncols):
    """One fp32 application at N1 = 20, E = 216 through the entry point,
    captured in a CUDA graph (its scratch from the graph's pool) and
    replayed twice: each replay bitwise the eager call's output, one launch
    of the entry point counted a replay."""
    b, x, geom, kw = _operands(variant, 19, 216, ncols, helm, card)
    assert ops.body_of(variant, b.n1) == "slab"
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
def test_order_19_solve_matches_reference_backend(card, variant, helm):
    """2x1x1 at order 19 through the kernels, captured, against the plain
    version on the card: the same status, x within 1e-3, iterations within
    +-1 for Poisson and within 1% for unmasked Helmholtz, whose hundreds of
    fp32 iterations drift with the order of the sums
    (chip_smoke.HIGH_ORDER_HELMHOLTZ_ITER_SHARE)."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 1, 1, 19), seed=3)
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
