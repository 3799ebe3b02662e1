"""Card tests of the port: the hand-written CUDA axhelm kernels against
their plain PyTorch versions, the wrapper's refusals, the gather's
run-to-run behaviour and a solve through the kernels.

Every test carries the `cuda` marker and skips without a card; whether a
card is present is decided in the `card` fixture, at run time.  This file
imports neither jax nor the reference package, so it runs on a machine
with PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance for the kernels: max|y_kernel - y_plain| / max|y_plain| <= 1e-4
(float32; the kernel sums in another order than the einsums).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import gather_scatter as gs
from repro_torch.core import geometry, mesh_gen, nekbone
from repro_torch.core.spectral import basis
from repro_torch.kernels.axhelm import ops
from repro_torch.resilience.status import SolveStatus

pytestmark = pytest.mark.cuda

RTOL32 = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(variant, n, e, ncols, helm, device, seed=0):
    rng = np.random.default_rng(seed)
    b = basis(n)
    n1 = b.n1
    nx = int(np.ceil(e ** (1 / 3)))
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(nx, nx, nx, n))
    verts = torch.as_tensor(mesh.verts[:e], dtype=torch.float32,
                            device=device)
    if variant == "trilinear":
        geom = verts.contiguous()
    else:
        f = geometry.factors_discrete(geometry.node_coords(verts, b), b)
        geom = torch.cat([f.g, f.gwj[..., None]], dim=-1).contiguous()
    x = torch.as_tensor(rng.standard_normal((e, ncols, n1, n1, n1)),
                        dtype=torch.float32, device=device)
    kw = {}
    if helm:
        kw = dict(
            lam0=torch.as_tensor(1 + 0.3 * rng.random((e, n1, n1, n1)),
                                 dtype=torch.float32, device=device),
            lam1=torch.as_tensor(0.5 + 0.2 * rng.random((e, n1, n1, n1)),
                                 dtype=torch.float32, device=device),
            helmholtz=True)
    return b, x, geom, kw


@pytest.mark.parametrize("ncols", [1, 3])
@pytest.mark.parametrize("helm", [False, True])
@pytest.mark.parametrize("n", [3, 7])
@pytest.mark.parametrize("variant", ["precomputed", "trilinear"])
def test_kernel_matches_plain_version(card, variant, n, helm, ncols):
    b, x, geom, kw = _operands(variant, n, 37, ncols, helm, card)
    before = ops.launch_counts[variant]
    y = ops.axhelm(x, b, variant, geom, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts[variant] == before + 1
    y_plain = ops.reference(x, b, variant, geom, **kw)
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= RTOL32, err


@pytest.mark.parametrize("variant", ["precomputed", "trilinear"])
def test_wrapper_refuses_what_the_kernel_does_not_take(card, variant):
    b, x, geom, _ = _operands(variant, 7, 5, 2, False, card)
    with pytest.raises(TypeError, match="float32 only"):
        ops.axhelm(x.double(), b, variant, geom.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.axhelm(x.transpose(-1, -2), b, variant, geom)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.axhelm(x, b, variant, geom.cpu())
    b5, x5, geom5, _ = _operands(variant, 5, 5, 1, False, card)
    with pytest.raises(ValueError, match="instantiated"):
        ops.axhelm(x5, b5, variant, geom5)


def test_gather_index_add_is_not_bitwise_reproducible_but_exact(card):
    """`index_add_` on CUDA sums with atomics: the order of the up to 8
    contributions to a shared dof varies from run to run.  The sums agree
    with the float64 sum to fp32 rounding; bitwise identity is not
    promised (the test records it but does not require it)."""
    mesh = mesh_gen.box_mesh(8, 8, 8, 7)
    ids = torch.as_tensor(mesh.global_ids, dtype=torch.int64, device=card)
    rng = np.random.default_rng(1)
    yl64 = torch.as_tensor(rng.standard_normal(mesh.global_ids.shape),
                           device=card)
    exact = gs.gather(yl64, ids, mesh.n_global)
    # first-order bound of rounding 8 inputs to fp32 and adding them
    bound = 16 * 2.0 ** -24 * gs.gather(yl64.abs(), ids, mesh.n_global)
    runs = [gs.gather(yl64.float(), ids, mesh.n_global) for _ in range(5)]
    for r in runs:
        assert bool(((r.double() - exact).abs() <= bound).all())
    identical = all(torch.equal(r, runs[0]) for r in runs)
    print(f"index_add_ bitwise identical over 5 runs: {identical}")


@pytest.mark.parametrize("variant", ["precomputed", "trilinear"])
def test_solve_through_kernels_matches_reference_backend(card, variant):
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(4, 4, 4, 7), seed=3)
    results = {}
    for backend in ("cuda", "reference"):
        prob = nekbone.setup_problem(mesh, variant=variant, backend=backend)
        assert prob.backend == backend and prob.device.type == "cuda"
        x_true = nekbone.random_solution(prob, seed=0)
        b = nekbone.rhs_from_solution(prob, x_true)
        ops.reset_launch_counts()
        res = nekbone.solve(prob, b, tol=1e-6, max_iter=400)
        launches = ops.launch_counts[variant]
        results[backend] = (int(res.iterations), int(res.status),
                            nekbone.manufactured_error(prob, res.x, x_true),
                            launches)
    (it_k, st_k, err_k, n_k), (it_r, st_r, err_r, n_r) = \
        results["cuda"], results["reference"]
    assert st_k == st_r == SolveStatus.CONVERGED
    assert abs(it_k - it_r) <= 1
    assert err_k < 1e-4 and err_r < 1e-4
    assert n_k >= it_k + 1 and n_r == 0
