"""Card tests of the staged body (`csrc/axhelm_staged.cu`): every entry
point, float32 and bfloat16 storage, at N1 = 49 and 64 (E = 3 with three
columns and E = 8 with one), at the N1 on each side of its switch from 32
to 16 lines an item (328 and 329, E = 1), and the timing-only
`ops.staged` twin at the plane body's N1 = 32, against its plain PyTorch
version, the launch counted once under the entry point (six CUDA kernels
an application); the 2x1x1 order-48 solve through the kernels against the
reference backend; the 2x2x2 order-63 solve captured against eager,
bitwise, and one application repeated bitwise.

Every test carries the `cuda` marker and skips without a card; whether a
card is present is decided in the `card` fixture, at run time.  This file
imports neither jax nor the reference package:

    python -m pytest -q -m cuda tests/test_torch_staged_cuda.py

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


def _against_plain(y, x, b, variant, geom, kw, dtype):
    assert y.dtype == dtype and bool(torch.isfinite(y.float()).all())
    y_plain = ops.reference(x, b, variant, geom, **kw).float()
    err = float((y.float() - y_plain).abs().max() / y_plain.abs().max())
    assert err <= RTOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,ncols", [(3, 3), (8, 1)])
@pytest.mark.parametrize("n", [48, 63])
@pytest.mark.parametrize("variant,helm", _VARIANT_EQUATIONS)
def test_staged_body_matches_plain_version(card, variant, helm, n, e,
                                           ncols, dtype):
    b, x, geom, kw = _operands(variant, n, e, ncols, helm, card,
                               dtype=dtype)
    assert ops.body_of(variant, b.n1) == "staged"
    name = ops.entry_point(variant, dtype)
    before = ops.launch_counts[name]
    y = ops.axhelm(x, b, variant, geom, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts[name] == before + 1
    assert ops.KERNELS_PER_APPLICATION["staged"] == 6
    _against_plain(y, x, b, variant, geom, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1", [ops.N1_STAGED_WIDE_MAX,
                                ops.N1_STAGED_WIDE_MAX + 1])
@pytest.mark.parametrize("variant,helm", _VARIANT_EQUATIONS)
def test_staged_body_on_each_side_of_its_switch(card, variant, helm, n1,
                                                dtype):
    """One element, one column, at the last N1 of 32 lines an item and the
    first of 16: the same answer as the plain version, and an application
    repeated gives the same bits."""
    b, x, geom, kw = _operands(variant, n1 - 1, 1, 1, helm, card,
                               dtype=dtype)
    assert ops.staged_launch(n1, 1, 1).lines == (
        ops.STAGED_TILE[1] if n1 == ops.N1_STAGED_WIDE_MAX
        else ops.STAGED_NARROW_LINES)
    y = ops.axhelm(x, b, variant, geom, **kw)
    again = ops.axhelm(x, b, variant, geom, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    _against_plain(y, x, b, variant, geom, kw, dtype)
    del again
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant,helm", _VARIANT_EQUATIONS)
def test_staged_twin_at_a_cluster_order(card, variant, helm, dtype):
    """`ops.staged` at N1 = 32, where `axhelm` runs the plane body:
    the same answer, no launch counted."""
    b, x, geom, kw = _operands(variant, 31, 5, 2, helm, card, dtype=dtype)
    before = dict(ops.launch_counts)
    y = ops.staged(x, b, variant, geom, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts == before
    _against_plain(y, x, b, variant, geom, kw, dtype)


@pytest.mark.parametrize("variant,helm", [("trilinear", False),
                                          ("partial", False),
                                          ("merged", True)])
def test_order_48_solve_matches_reference_backend(card, variant, helm):
    """2x1x1 at order 48 through the staged body, captured, against the
    plain version on the card: the same status, x within 1e-3, iterations
    within +-1 for Poisson and within 1% for unmasked Helmholtz, whose
    ~700 fp32 iterations drift with the order of the sums
    (chip_smoke.HIGH_ORDER_HELMHOLTZ_ITER_SHARE)."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 1, 1, 48), seed=3)
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


def test_order_63_solve_captured_is_bitwise_eager(card):
    """The 2x2x2 order-63 trilinear solve (2,048,383 dofs), 40 iterations
    captured and eager: the same status and iterations, x bitwise equal,
    entry-point launches counted for every operator application."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 2, 2, 63), seed=3)
    prob = nekbone.setup_problem(mesh, variant="trilinear")
    assert prob.backend == "cuda"
    b = nekbone.rhs_from_solution(prob, nekbone.random_solution(prob))
    name = ops.entry_point("trilinear", torch.float32)
    runs = {}
    for capture in (True, False):
        ops.reset_launch_counts()
        runs[capture] = nekbone.solve(prob, b, tol=1e-12, max_iter=40,
                                      capture=capture)
        torch.cuda.synchronize()
        assert ops.launch_counts[name] >= 40
    cap, eager = runs[True], runs[False]
    assert torch.equal(cap.status, eager.status)
    assert torch.equal(cap.iterations, eager.iterations)
    assert torch.equal(cap.x, eager.x)
