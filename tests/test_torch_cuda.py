"""Card tests of the port: the hand-written CUDA axhelm kernels (float32
and bfloat16 storage) against their plain PyTorch versions -- the K2 and
K5 column body and the K1, K3 and K4 line body also at ragged block
counts, against the correctly rounded result for bf16, and on solves that
must not reach their timing-only one-thread-per-node twins; the generic
body of every variant at orders 1 to 15, and beside the tuned bodies at
orders 3 and 7 -- the wrapper's refusals (a misaligned operand of the line
body and an order above N1_PLANE_MAX - 1 among them), the gather's run-to-run
behaviour, and solves through the kernels: float32 single and stacked
right-hand sides (the comparison with the reference backend), order 5
(through the tuned bodies), and the mixed-precision bf16_x32 refinement;
the solver loops as replayed CUDA graphs — bitwise equal to the same
loops run eagerly, no host sync in a replay, one capture per loop, a
fault striking inside a replayed chunk — and the resilient solve letting
a kernel failure raise.

Every test carries the `cuda` marker and skips without a card; whether a
card is present is decided in the `card` fixture, at run time.  This file
imports neither jax nor the reference package, so it runs on a machine
with PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance for the kernels: max|y_kernel - y_plain| / max|y_plain| <= 1e-4
(float32; the kernel sums in another order than the einsums), and 8e-3 for
bfloat16 storage (one bf16 ulp of the largest entry: both round one float32
result once, and the other summation order can move it across a rounding
boundary).
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import record
from repro_torch.analysis.contracts import (EntryArtifacts, NoHostTransfer,
                                            NoRetrace)
from repro_torch.core import axhelm as core_axhelm
from repro_torch.core import gather_scatter as gs
from repro_torch.core import graphs, mesh_gen, nekbone
from repro_torch.core.spectral import basis
from repro_torch.kernels.axhelm import ops
from repro_torch.resilience.status import SolveStatus

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda

RTOL32 = 1e-4
RTOL_BF16 = 8e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(variant, n, e, ncols, helm, device, seed=0,
              dtype=torch.float32, backend="cuda"):
    """x, geom and the lambda kwargs of one kernel call, stored in `dtype`:
    random lam0/lam1 for Helmholtz, merged's Lam2/Lam3 of them, partial's
    gScale; the parallelepiped kernel runs on an affinely deformed box.
    The operands of both backends are the same."""
    rng = np.random.default_rng(seed)
    b = basis(n)
    n1 = b.n1
    nx = int(np.ceil(e ** (1 / 3)))
    box = mesh_gen.box_mesh(nx, nx, nx, n)
    mesh = mesh_gen.deform_affine(box, seed=2) \
        if variant == "parallelepiped" else mesh_gen.deform_trilinear(box)
    verts = torch.as_tensor(mesh.verts[:e], dtype=torch.float32,
                            device=device)
    x = torch.as_tensor(rng.standard_normal((e, ncols, n1, n1, n1)),
                        dtype=torch.float32, device=device)
    lams = {}
    if helm:
        lams = dict(
            lam0=torch.as_tensor(1 + 0.3 * rng.random((e, n1, n1, n1)),
                                 dtype=torch.float32, device=device),
            lam1=torch.as_tensor(0.5 + 0.2 * rng.random((e, n1, n1, n1)),
                                 dtype=torch.float32, device=device))
    elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
        variant, b, verts, helmholtz=helm, dtype=dtype, backend=backend,
        device=device, **lams)
    geom = elem_ops.pop("geom")
    return b, x.to(dtype), geom, dict(elem_ops, helmholtz=helm)


# merged is Helmholtz only and partial Poisson only
_VARIANT_EQUATIONS = [(v, h) for v in ("precomputed", "trilinear",
                                       "parallelepiped")
                      for h in (False, True)] + [("merged", True),
                                                 ("partial", False)]


@pytest.mark.parametrize("ncols", [1, 3])
@pytest.mark.parametrize("n", [3, 7])
@pytest.mark.parametrize("variant,helm", _VARIANT_EQUATIONS)
def test_kernel_matches_plain_version(card, variant, helm, n, ncols):
    b, x, geom, kw = _operands(variant, n, 37, ncols, helm, card)
    name = ops.entry_point(variant, torch.float32)
    before = ops.launch_counts[name]
    y = ops.axhelm(x, b, variant, geom, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts[name] == before + 1
    y_plain = ops.reference(x, b, variant, geom, **kw)
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= RTOL32, err


@pytest.mark.parametrize("ncols", [1, 3, 6])
@pytest.mark.parametrize("n", [3, 7])
@pytest.mark.parametrize("variant,helm", _VARIANT_EQUATIONS)
def test_bf16_kernel_matches_plain_version(card, variant, helm, n, ncols):
    b, x, geom, kw = _operands(variant, n, 37, ncols, helm, card,
                               dtype=torch.bfloat16)
    name = ops.entry_point(variant, torch.bfloat16)
    before = ops.launch_counts[name]
    y = ops.axhelm(x, b, variant, geom, **kw)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    assert ops.launch_counts[name] == before + 1
    y_plain = ops.reference(x, b, variant, geom, **kw).float()
    err = float((y.float() - y_plain).abs().max() / y_plain.abs().max())
    assert err <= RTOL_BF16, err


@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_wrapper_refuses_what_the_kernel_does_not_take(card, variant):
    helm = variant == "merged"
    b, x, geom, kw = _operands(variant, 7, 5, 2, helm, card)
    with pytest.raises(TypeError, match="float32 or bfloat16 storage"):
        ops.axhelm(x.double(), b, variant, geom.double(), **kw)
    with pytest.raises(TypeError, match="x's dtype"):
        ops.axhelm(x.bfloat16(), b, variant, geom, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.axhelm(x.transpose(-1, -2), b, variant, geom, **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.axhelm(x, b, variant, geom.cpu(), **kw)
    # every order up to N1_STAGED_MAX - 1 runs (test_generic_body_*, above
    # N1_MAX - 1 tests/test_torch_plane_cuda.py, above N1_PLANE_MAX - 1
    # the staged body, tests/test_torch_staged_cuda.py); one past the
    # plane body's cap the wrapper runs.  Above N1_STAGED_MAX a staged
    # contraction block's panel does not fit in shared memory: the wrapper
    # raises before it reads the tensors, and so does setup on the card
    # (a stand-in basis: no 879^3 arrays)
    bb, xb, geomb, kwb = _operands(variant, ops.N1_PLANE_MAX, 2, 1, helm,
                                   card)
    assert ops.body_of(variant, bb.n1) == "staged"
    assert ops.axhelm(xb, bb, variant, geomb, **kwb).shape == xb.shape
    big = type("B", (), {"n1": ops.N1_STAGED_MAX + 1,
                         "n": ops.N1_STAGED_MAX})
    with pytest.raises(ValueError, match="N1_STAGED_MAX"):
        ops.axhelm(x, big, variant, geom, **kw)
    verts = mesh_gen.box_mesh(1, 1, 2, 1).verts
    with pytest.raises(ValueError, match="N1_STAGED_MAX"):
        core_axhelm.make_axhelm_elem_ops(variant, big, verts,
                                         helmholtz=helm, device=card)


def test_gather_is_bitwise_reproducible_and_exact(card):
    """The gather no longer sums with `index_add_` (whose atomics changed
    the order of the up to 8 contributions to a shared dof from run to
    run): it sums in its plan's fixed order, so repeated gathers are
    bitwise identical, equal to the same gather on the CPU, and agree with
    the float64 sum to fp32 rounding."""
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
    assert all(torch.equal(r, runs[0]) for r in runs)
    on_cpu = gs.gather(yl64.float().cpu(), ids.cpu(), mesh.n_global)
    assert torch.equal(runs[0].cpu(), on_cpu)


@pytest.mark.parametrize("variant,helm", [("precomputed", False),
                                          ("trilinear", False),
                                          ("parallelepiped", False),
                                          ("merged", True),
                                          ("partial", False)])
def test_solve_through_kernels_matches_reference_backend(card, variant,
                                                         helm):
    box = mesh_gen.box_mesh(4, 4, 4, 7)
    mesh = mesh_gen.deform_affine(box, seed=2) \
        if variant == "parallelepiped" else \
        mesh_gen.deform_trilinear(box, seed=3)
    results = {}
    # the gather sums in a fixed order, so the error this test reads is the
    # same in every run (with index_add_'s atomics the merged case once read
    # 1.054e-4 against its 1e-4 bound)
    for backend in ("cuda", "reference"):
        prob = nekbone.setup_problem(mesh, variant=variant,
                                     helmholtz=helm, backend=backend)
        assert prob.backend == backend and prob.device.type == "cuda"
        x_true = nekbone.random_solution(prob, seed=0)
        b = nekbone.rhs_from_solution(prob, x_true)
        ops.reset_launch_counts()
        res = nekbone.solve(prob, b, tol=1e-6, max_iter=1000)
        launches = ops.launch_counts[ops.entry_point(variant,
                                                     torch.float32)]
        results[backend] = (
            int(res.iterations), int(res.status),
            nekbone.manufactured_error(prob, res.x, x_true), launches)
    (it_k, st_k, err_k, n_k), (it_r, st_r, err_r, n_r) = \
        results["cuda"], results["reference"]
    print(f"{variant}: manufactured error {err_k:.6e} through the kernels, "
          f"{err_r:.6e} through the reference backend")
    assert st_k == st_r == SolveStatus.CONVERGED
    assert abs(it_k - it_r) <= 1
    assert err_k < 1e-4 and err_r < 1e-4
    assert n_k >= it_k + 1 and n_r == 0


def test_stacked_rhs_solve_through_kernels(card):
    """Block PCG on 3 stacked right-hand sides through the fp32 kernel: one
    launch per block application, each column within +-1 iteration of its
    own single-RHS solve."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(4, 4, 4, 7), seed=3)
    prob = nekbone.setup_problem(mesh, variant="trilinear", nrhs=3,
                                 backend="cuda", device=card)
    x_true = nekbone.random_solution(prob, seed=0, nrhs=3)
    b = nekbone.rhs_from_solution(prob, x_true)
    ops.reset_launch_counts()
    res = nekbone.solve(prob, b, tol=1e-6, max_iter=1000)
    launches = ops.launch_counts["axhelm_trilinear_f32"]
    assert res.x.shape == b.shape and res.status.shape == (3,)
    assert (res.status == SolveStatus.CONVERGED).all()
    assert launches >= int(res.iterations.max()) + 1
    for c in range(3):
        single = nekbone.solve(prob, b[:, c], tol=1e-6, max_iter=1000)
        assert abs(int(res.iterations[c]) - int(single.iterations)) <= 1
    assert nekbone.manufactured_error(prob, res.x, x_true) < 1e-4


def test_bf16_x32_solve_through_kernels_matches_reference_backend(card):
    """The 8^3 N=7 mixed-precision trilinear Poisson solve at tol 0.03
    (1e-3 of |b| = 30): CONVERGED on the bf16 kernel and on the reference
    backend, iterations within max(3, 5%), the fp32 true residual within
    1.5 tol, and one bf16 launch per inner operator application."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(8, 8, 8, 7), seed=3)
    rng = np.random.default_rng(0)
    b_np = rng.standard_normal(mesh.n_global)
    b_np[mesh.boundary] = 0.0
    b_np *= 30.0 / np.linalg.norm(b_np)
    tol = 0.03
    out = {}
    for backend in ("cuda", "reference"):
        prob = nekbone.setup_problem(mesh, variant="trilinear",
                                     precision="bf16_x32", backend=backend,
                                     device=card)
        b = torch.as_tensor(b_np, dtype=torch.float32, device=card)
        applications = {"n": 0}
        op_lo = prob.op_lo

        def counted(x):
            graphs.count(applications, "n")   # once per replay, too
            return op_lo(x)
        prob = prob._replace(op_lo=counted)
        ops.reset_launch_counts()
        res = nekbone.solve(prob, b, tol=tol, max_iter=3000)
        true = float(torch.linalg.norm(b - prob.op(res.x)))
        out[backend] = (int(res.status), int(res.iterations), true,
                        ops.launch_counts["axhelm_trilinear_bf16"],
                        applications["n"])
    (st_k, it_k, true_k, n_k, app_k), (st_r, it_r, true_r, n_r, _) = \
        out["cuda"], out["reference"]
    assert st_k == st_r == SolveStatus.CONVERGED, out
    assert abs(it_k - it_r) <= max(3, 0.05 * it_r), out
    assert true_k <= 1.5 * tol and true_r <= 1.5 * tol, out
    assert n_k == app_k >= it_k and n_r == 0, out


# The column body (csrc/axhelm_column.cu) of K2 and K5: ragged blocks (2
# elements a block at N1 = 8, 8 at N1 = 4), every column count the solves
# use, and the per-node fields it reads (K2's lam0 and lam1, K5's gScale).
_COLUMN_CASES = [("trilinear", False), ("trilinear", True),
                 ("partial", False)]


@functools.lru_cache(maxsize=None)
def _column_mesh_verts(n, e, affine=False):
    """float32 vertices of the first e elements of a deformed box (affinely
    deformed for the parallelepiped kernel)."""
    nx = int(np.ceil(e ** (1 / 3)))
    box = mesh_gen.box_mesh(nx, nx, nx, n)
    mesh = mesh_gen.deform_affine(box, seed=2) if affine else \
        mesh_gen.deform_trilinear(box, seed=3)
    return np.ascontiguousarray(mesh.verts[:e], dtype=np.float32)


def _column_operands(variant, helm, n, e, ncols, dtype, device):
    """x (E, ncols, N1^3), geom and kwargs: K2 and K3 with a per-node lam0
    field (and lam1 for Helmholtz), K4 with the Lam2/Lam3 of random lam0 and
    lam1, K5 with its gScale."""
    rng = np.random.default_rng(1000 * n + e + ncols)
    b = basis(n)
    n1 = b.n1
    verts = torch.as_tensor(
        _column_mesh_verts(n, e, variant == "parallelepiped"), device=device)
    x = torch.as_tensor(rng.standard_normal((e, ncols, n1, n1, n1)),
                        dtype=torch.float32, device=device)
    node = (e, n1, n1, n1)
    lams = {}
    if variant != "partial":
        lams["lam0"] = torch.as_tensor(1 + 0.3 * rng.random(node),
                                       dtype=torch.float32, device=device)
        if helm:
            lams["lam1"] = torch.as_tensor(0.5 + 0.2 * rng.random(node),
                                           dtype=torch.float32,
                                           device=device)
    elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
        variant, b, verts, helmholtz=helm, dtype=dtype, backend="cuda",
        device=device, **lams)
    geom = elem_ops.pop("geom")
    return b, x.to(dtype), geom, dict(elem_ops, helmholtz=helm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ncols", [1, 3, 6])
@pytest.mark.parametrize("e", [1, 37, 4096 + 3])
@pytest.mark.parametrize("n", [3, 7])
@pytest.mark.parametrize("variant,helm", _COLUMN_CASES)
def test_column_kernel_matches_plain_version(card, variant, helm, n, e,
                                             ncols, dtype):
    _check_against_plain_version(card, variant, helm, n, e, ncols, dtype)


def _check_against_plain_version(card, variant, helm, n, e, ncols, dtype):
    """One kernel call against its plain version; for bf16 also against the
    correctly rounded result, as chip_smoke.py phase 3b."""
    b, x, geom, kw = _column_operands(variant, helm, n, e, ncols, dtype,
                                      card)
    name = ops.entry_point(variant, dtype)
    before = ops.launch_counts[name]
    y = ops.axhelm(x, b, variant, geom, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts[name] == before + 1 and y.dtype == dtype
    y_plain = ops.reference(x, b, variant, geom, **kw)
    err = float((y.float() - y_plain.float()).abs().max()
                / y_plain.float().abs().max())
    assert err <= (RTOL32 if dtype == torch.float32 else RTOL_BF16), err
    if dtype == torch.bfloat16:
        exact = ops.unrounded(x, b, variant, geom, compute=torch.float64,
                              **kw).to(torch.bfloat16)
        d = chip_smoke.ulp_distance(y, exact)
        floor = chip_smoke.ULP_ABS_FLOOR * float(exact.float().abs().max())
        far = (d > 1) & ((y.float() - exact.float()).abs() > floor)
        assert float((d != 0).float().mean()) <= chip_smoke.ULP_RATE_BOUND
        assert int(far.sum()) == 0


def _count_library_calls(monkeypatch):
    """Wrap every symbol of the kernel library in a call counter; returns
    the counts by symbol (calls made by the host: a graph's replay makes
    none)."""
    from repro_torch.kernels.axhelm import build

    lib = build.library()
    called = {}
    for name in build.SIGNATURES:
        for suffix in ops.KERNEL_DTYPES.values():
            sym = build.symbol(name, suffix)
            fn = getattr(lib, sym)

            def counting(*args, _fn=fn, _sym=sym):
                called[_sym] = called.get(_sym, 0) + 1
                return _fn(*args)
            monkeypatch.setattr(lib, sym, counting)
    return called


def _solve_calls_only(prob, symbol, called):
    """Solve as users do (captured: warm-up and capture call the library,
    replays do not) and require that no symbol but `symbol` was called and
    that its launches, credited once per replay, equal the operator's
    applications; then solve eagerly, where every launch is one call of
    `symbol`."""
    applications = {"n": 0}
    op = prob.op

    def counted(x):
        graphs.count(applications, "n")       # once per replay, too
        return op(x)
    prob = prob._replace(op=counted)
    x_true = nekbone.random_solution(prob, seed=0)
    b = nekbone.rhs_from_solution(prob, x_true)
    for capture in (True, False):
        ops.reset_launch_counts()
        called.clear()
        applications["n"] = 0
        replays = prob.graphs.replays
        res = nekbone.solve(prob, b, tol=1e-6, max_iter=1000,
                            capture=capture)
        assert res.status == SolveStatus.CONVERGED
        assert set(called) == {symbol}, (capture, called)
        assert ops.launch_counts[symbol] == applications["n"] >= \
            int(res.iterations) + 1, capture
        if capture:
            assert prob.graphs.replays > replays
        else:
            assert prob.graphs.replays == replays
            assert called[symbol] == applications["n"]


def test_solve_through_column_kernel_never_reaches_the_node_body(
        card, monkeypatch):
    """A trilinear solve launches axhelm_trilinear_f32 once per operator
    application and none of the timing-only *_rowwise symbols, captured
    as users run it and eagerly."""
    called = _count_library_calls(monkeypatch)
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(4, 4, 4, 7), seed=3)
    prob = nekbone.setup_problem(mesh, variant="trilinear", backend="cuda",
                                 device=card)
    _solve_calls_only(prob, "axhelm_trilinear_f32", called)


# The line body (csrc/axhelm_line.cu) of K1, K3 and K4: persistent blocks
# over ragged groups (1 element a group at N1 = 8, 4 at N1 = 4), every
# column count the solves use, K1 and K3 with per-node lam0 (and lam1), K4
# with Lam2/Lam3.
_LINE_CASES = [("parallelepiped", False), ("parallelepiped", True),
               ("merged", True), ("precomputed", False),
               ("precomputed", True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ncols", [1, 3, 6])
@pytest.mark.parametrize("e", [1, 37, 4096 + 3])
@pytest.mark.parametrize("n", [3, 7])
@pytest.mark.parametrize("variant,helm", _LINE_CASES)
def test_line_kernel_matches_plain_version(card, variant, helm, n, e, ncols,
                                           dtype):
    _check_against_plain_version(card, variant, helm, n, e, ncols, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("helm", [False, True])
def test_precomputed_line_kernel_takes_four_stacked_columns(card, helm,
                                                           dtype):
    """K1 on the (E, nrhs=4, d=1, N1^3) layout of pcg_block and refine at
    nrhs 4: the four columns of an element, one stage each, each loading
    the element's factor planes again."""
    b, x, geom, kw = _column_operands("precomputed", helm, 7, 4099, 4,
                                      dtype, card)
    x = x[:, :, None].contiguous()
    y = ops.axhelm(x, b, "precomputed", geom, **kw)
    y_plain = ops.reference(x, b, "precomputed", geom, **kw)
    assert y.shape == x.shape
    err = float((y.float() - y_plain.float()).abs().max()
                / y_plain.float().abs().max())
    assert err <= (RTOL32 if dtype == torch.float32 else RTOL_BF16), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", ops.LINE_VARIANTS)
def test_line_kernel_refuses_a_misaligned_operand(card, variant, dtype):
    """The line body stages x (and K4's Lam2, Lam3) with 16-byte vector
    loads: a contiguous view one value into its storage raises, and
    launches nothing."""
    helm = variant == "merged"
    b, x, geom, kw = _column_operands(variant, helm, 7, 5, 1, dtype, card)
    name = ops.entry_point(variant, dtype)
    before = ops.launch_counts[name]
    shifted = torch.empty(x.numel() + 1, dtype=dtype, device=card)[1:]
    shifted = shifted.view(x.shape).copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte-aligned"):
        ops.axhelm(shifted, b, variant, geom, **kw)
    if variant == "merged":
        lam = torch.empty(kw["lam0"].numel() + 1, dtype=dtype,
                          device=card)[1:].view(kw["lam0"].shape)
        with pytest.raises(ValueError, match="16-byte-aligned"):
            ops.axhelm(x, b, variant, geom, **dict(kw, lam0=lam.copy_(
                kw["lam0"])))
    assert ops.launch_counts[name] == before


@pytest.mark.parametrize("variant,helm", [("parallelepiped", False),
                                          ("merged", True)])
def test_solve_through_line_kernel_never_reaches_the_node_body(
        card, monkeypatch, variant, helm):
    """An 8^3 parallelepiped (affine mesh) or merged solve launches its
    line entry point once per operator application and no other symbol,
    none of the timing-only *_rowwise among them, captured as users run it
    and eagerly."""
    called = _count_library_calls(monkeypatch)
    box = mesh_gen.box_mesh(8, 8, 8, 7)
    mesh = mesh_gen.deform_affine(box, seed=2) \
        if variant == "parallelepiped" else \
        mesh_gen.deform_trilinear(box, seed=3)
    prob = nekbone.setup_problem(mesh, variant=variant, helmholtz=helm,
                                 backend="cuda", device=card)
    _solve_calls_only(prob, ops.entry_point(variant, torch.float32), called)


# The generic body (csrc/axhelm.cu, the *_any symbols): every variant and
# storage type at orders 1 to 15 (N1 = 2 to 16), through `ops.generic`, and
# through `ops.axhelm` wherever N1 is not a tuned body's, where it must be
# the same launch.
_ALL_CASES = _LINE_CASES + [("trilinear", False), ("trilinear", True),
                            ("partial", False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", range(1, 16))
@pytest.mark.parametrize("variant,helm", _ALL_CASES)
def test_generic_body_matches_plain_version(card, variant, helm, n, dtype):
    b, x, geom, kw = _column_operands(variant, helm, n, 37, 2, dtype, card)
    name = ops.entry_point(variant, dtype)
    before = ops.launch_counts[name]
    y = ops.generic(x, b, variant, geom, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts[name] == before and y.dtype == dtype
    y_plain = ops.reference(x, b, variant, geom, **kw)
    err = float((y.float() - y_plain.float()).abs().max()
                / y_plain.float().abs().max())
    assert err <= (RTOL32 if dtype == torch.float32 else RTOL_BF16), err
    if b.n1 not in ops.KERNEL_N1:
        assert torch.equal(ops.axhelm(x, b, variant, geom, **kw), y)
        assert ops.launch_counts[name] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [3, 7])
@pytest.mark.parametrize("variant,helm", _ALL_CASES)
def test_generic_body_matches_tuned_bodies(card, variant, helm, n, dtype):
    """At the tuned bodies' N1 the generic body computes what they do."""
    b, x, geom, kw = _column_operands(variant, helm, n, 4099, 3, dtype,
                                      card)
    y = ops.generic(x, b, variant, geom, **kw).float()
    y_tuned = ops.axhelm(x, b, variant, geom, **kw).float()
    err = float((y - y_tuned).abs().max() / y_tuned.abs().max())
    assert err <= (RTOL32 if dtype == torch.float32 else RTOL_BF16), err


@pytest.mark.parametrize("variant,helm", [("precomputed", False),
                                          ("trilinear", False),
                                          ("parallelepiped", False),
                                          ("merged", True),
                                          ("partial", False)])
def test_order_5_solve_runs_the_generic_body(card, variant, helm):
    """`setup_problem` and `solve` at order 5 on the card: every operator
    application one launch of the entry point (the generic body's until
    the tuned bodies took N1 = 6; tests/test_torch_tuned_cuda.py solves
    through the generic body at order 16), and the iterations of the
    reference backend within +-1."""
    box = mesh_gen.box_mesh(4, 4, 4, 5)
    mesh = mesh_gen.deform_affine(box, seed=2) \
        if variant == "parallelepiped" else \
        mesh_gen.deform_trilinear(box, seed=3)
    results = {}
    for backend in ("auto", "reference"):
        prob = nekbone.setup_problem(mesh, variant=variant,
                                     helmholtz=helm, backend=backend)
        x_true = nekbone.random_solution(prob, seed=0)
        b = nekbone.rhs_from_solution(prob, x_true)
        ops.reset_launch_counts()
        res = nekbone.solve(prob, b, tol=1e-6, max_iter=1000)
        results[prob.backend] = (
            int(res.iterations), int(res.status),
            ops.launch_counts[ops.entry_point(variant, torch.float32)])
    (it_k, st_k, n_k), (it_r, st_r, n_r) = \
        results["cuda"], results["reference"]
    assert st_k == st_r == SolveStatus.CONVERGED
    assert abs(it_k - it_r) <= 1
    assert n_k >= it_k + 1 and n_r == 0


# The solver loops as CUDA graphs (core/graphs.py, core/pcg.py): each loop's
# chunk of _CHECK_EVERY bodies is warmed up, captured once and replayed.

def _solve_problem(card, precision=None, order=7, nrhs=1, variant="trilinear"):
    """A 4^3 trilinear Poisson problem through the kernels and its b: the
    manufactured one for fp32, `nekbone.random_rhs` for bf16_x32."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(4, 4, 4, order),
                                     seed=3)
    prob = nekbone.setup_problem(mesh, variant=variant, backend="cuda",
                                 device=card, precision=precision)
    if precision:
        return prob, nekbone.random_rhs(prob, nrhs=nrhs)
    x_true = nekbone.random_solution(prob, seed=0, nrhs=nrhs)
    return prob, nekbone.rhs_from_solution(prob, x_true)


# (name, precision, nrhs, tol): pcg, pcg_block and refine's inner sweeps
_LOOPS = [("pcg", None, 1, 1e-6), ("pcg_block", None, 3, 1e-6),
          ("refine", "bf16_x32", 1, 1e-3),
          ("refine_block", "bf16_x32", 3, 1e-3)]


@pytest.mark.parametrize("name,precision,nrhs,tol", _LOOPS,
                         ids=[c[0] for c in _LOOPS])
def test_captured_solve_equals_eager_solve(card, name, precision, nrhs, tol):
    """The replayed loop gives the eager loop's bits: x, statuses,
    iterations, and the kernel launches (counted once per replay)."""
    prob, b = _solve_problem(card, precision, nrhs=nrhs)
    out = {}
    for capture in (False, True, True):
        ops.reset_launch_counts()
        res = nekbone.solve(prob, b, tol=tol, max_iter=1000,
                            capture=capture)
        torch.cuda.synchronize()
        out.setdefault(capture, []).append((res, dict(ops.launch_counts)))
    eager, eager_launches = out[False][0]
    for res, launches in out[True]:
        assert torch.equal(res.x, eager.x)
        assert torch.equal(res.iterations, eager.iterations)
        assert torch.equal(res.status, eager.status)
        assert launches == eager_launches
    if precision is None:
        assert (eager.status == SolveStatus.CONVERGED).all()
    assert prob.graphs.captures == 1
    assert prob.graphs.replays > 0


def test_replay_makes_no_host_sync(card):
    """A replay of a captured chunk, under sync debug mode "error": no
    operation in it waits for the device (only the flag read between
    chunks does, outside the replay)."""
    prob, b = _solve_problem(card)
    nekbone.solve(prob, b, tol=1e-6, max_iter=1000)
    (loop,) = prob.graphs.loops.values()
    assert loop.graph is not None
    ops, _, _ = record.record_chunks(prob.graphs)
    art = EntryArtifacts("replay", ops=ops, meta={
        "replay_error": record.replay_sync_error(prob.graphs)})
    assert NoHostTransfer().check(art) == []


def test_no_recapture_on_repeat_or_new_tolerance(card):
    """A repeat solve, a solve at another tolerance, and refine's sweeps
    (a new inner tolerance in each) replay the graphs captured first."""
    prob, b = _solve_problem(card)
    first = nekbone.solve(prob, b, tol=1e-3, max_iter=1000)
    assert prob.graphs.captures == 1
    tight = nekbone.solve(prob, b, tol=1e-7, max_iter=1000)
    assert NoRetrace.counts(1, prob.graphs.captures, "new tolerance") == []
    assert int(tight.iterations) > int(first.iterations)
    fresh = nekbone.solve(prob, b, tol=1e-7, max_iter=1000, capture=False)
    assert torch.equal(tight.x, fresh.x)
    mixed, bm = _solve_problem(card, "bf16_x32")
    for tol in (0.03, 1e-3, 1e-4):
        nekbone.solve(mixed, bm, tol=tol, max_iter=3000)
    assert NoRetrace.counts(1, mixed.graphs.captures, "refine sweeps") == []
    assert len(mixed.graphs.capture_seconds) == 1


def test_block_solver_captures_once_per_width(card):
    prob, _ = _solve_problem(card)
    shapes = []
    solve_block = nekbone.make_block_solver(prob, tol=1e-6, max_iter=1000,
                                            on_capture=shapes.append)
    for width in (2, 4, 2, 4, 1, 1):
        b = nekbone.rhs_from_solution(
            prob, nekbone.random_solution(prob, seed=width, nrhs=width))
        b = b.reshape(b.shape[0], width)        # width 1 is a block too
        res = solve_block(b, torch.zeros_like(b))
        assert (res.status == SolveStatus.CONVERGED).all()
    ng = prob.mesh.n_global
    assert shapes == [(ng, 2), (ng, 4), (ng, 1)]


@pytest.mark.parametrize("variant,helm", [("trilinear", False),
                                          ("merged", True)])
def test_order_5_solve_captured_through_the_generic_body(card, variant,
                                                         helm):
    """At order 5 (the tuned bodies since they took N1 = 6) a captured
    solve launches as the eager one; tests/test_torch_tuned_cuda.py
    captures the bodies that opt in to dynamic shared memory at every
    launch, the generic body at order 16 and the column body at order
    15."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(4, 4, 4, 5), seed=3)
    prob = nekbone.setup_problem(mesh, variant=variant, helmholtz=helm,
                                 backend="cuda", device=card)
    b = nekbone.rhs_from_solution(prob, nekbone.random_solution(prob))
    name = ops.entry_point(variant, torch.float32)
    results = []
    for capture in (True, False):
        ops.reset_launch_counts()
        results.append((nekbone.solve(prob, b, tol=1e-6, max_iter=1000,
                                      capture=capture),
                         ops.launch_counts[name]))
    (cap, n_cap), (eager, n_eager) = results
    assert prob.graphs.captures == 1
    assert int(cap.status) == SolveStatus.CONVERGED
    assert torch.equal(cap.x, eager.x) and n_cap == n_eager > 0


@pytest.mark.parametrize("iteration", [3, 11])
def test_fault_strikes_inside_a_captured_chunk(card, iteration):
    """A NaN at iteration 3 (in the warm-up chunk on the first solve, in a
    replay on the second) or 11 (in a replay): DIVERGED at that iteration,
    x the eager faulted solve's bits."""
    from repro_torch.resilience.inject import FaultSpec

    prob, b = _solve_problem(card)
    spec = FaultSpec(mode="nan", iteration=iteration)
    eager = nekbone.solve(prob, b, tol=1e-6, max_iter=1000, fault=spec,
                          capture=False)
    for _ in range(2):
        res = nekbone.solve(prob, b, tol=1e-6, max_iter=1000, fault=spec)
        assert int(res.status) == SolveStatus.DIVERGED
        assert int(res.iterations) == iteration
        assert torch.equal(res.x, eager.x)
    assert prob.graphs.captures == 1


def test_kernel_failure_propagates_through_solve_resilient(card,
                                                           monkeypatch):
    """solve_resilient acts on statuses only: a kernel launch that fails
    raises through it."""
    from repro_torch.kernels.axhelm import build
    from repro_torch.resilience.retry import solve_resilient

    prob, b = _solve_problem(card)

    class Failing:
        def __getattr__(self, symbol):
            return lambda *args: 1            # cudaErrorInvalidValue

    monkeypatch.setattr(build, "library", lambda: Failing())
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        solve_resilient(prob, b, tol=1e-6, max_iter=1000)
