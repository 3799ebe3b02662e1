"""The plane body of the axhelm kernels (`csrc/axhelm_plane.cu`), which runs
every variant at N1 above the generic body's N1_MAX up to N1_PLANE_MAX, on
the CPU: what of it is not CUDA.

* Its three launches, written here in float64 in the kernel's order of
  sums: T = D_t x (per batch row, each output summed m upward); per
  (element, t-plane) and column, x_r and x_s on the plane, the factors
  per node (the generic body's `node_factors`), s_r and s_s, s_t written
  over T in place, and Ypart = mass x + D_r^T s_r + D_s^T s_s into the
  second scratch field; then y = Ypart + D_t^T S_t.  Against the
  reference package's jnp oracle in float64, <= 1e-12 relative (the same
  formulas in another order): all five geometry sources at N1 = 25, 32
  and 48, E = 2, c = 1 and 3.
* `ops.plane_launch`'s arithmetic at every N1 from 25 to 48 and the source's
  constants it mirrors: the grids,
  the threads, the scratch, and shared memory that fits the blocks an SM
  the source promises; the timing-only twin `ops.plane`'s range.
* Which C symbol `ops` reaches at N1 = 24 to the cap, with which arguments,
  and which launches it counts, through the stand-in library of
  tests/test_torch_axhelm_column.py; the orders `chip_smoke.py` runs it
  at (its ptxas parse: tests/test_torch_axhelm_generic.py).
* The slice against the JAX package: the port's order-25 solve on a 2x1x1
  mesh through the kernels' plain version, against the reference
  package's `backend="reference"` solve (the same status, iterations
  within +-1, x within tests/test_torch_solve.py's 1e-4), and one
  operator application at N1 = 26 against the reference's Pallas kernel
  in interpret mode (<= 1e-4 relative, float32).

The kernel itself runs on the card only: tests/test_torch_plane_cuda.py.
"""

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mesh_gen as jmesh
from repro.core import nekbone as jnek
from repro.core.spectral import basis as jbasis
from repro.kernels.axhelm import ops as jops
from repro_torch import convert
from repro_torch.core import axhelm as taxhelm
from repro_torch.core import nekbone as tnek
from repro_torch.core.spectral import basis as tbasis
from repro_torch.kernels.axhelm import build, ops
from repro_torch.resilience.status import SolveStatus

from test_torch_axhelm_column import _meta, fake_card  # noqa: F401
from test_torch_axhelm_generic import (WALK_CASES, _geom_meta, _lams_meta,
                                       _rel, node_factors)
from test_torch_axhelm_staged import _walk_operands

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _torch_x64 import x64  # noqa: F401,E402

RTOL64 = 1e-12
RTOL32 = 1e-4


def summed(a_mat, operand, axis):
    """sum_m A(p, m) operand(.., m, ..) along `axis` of `operand`, the
    output's axis in its place: the terms added one m at a time, m
    upward, as every sum of the kernel runs."""
    n1 = a_mat.shape[0]
    moved = np.moveaxis(operand, axis, 0)
    acc = np.zeros((n1,) + moved.shape[1:])
    for m in range(n1):
        acc = acc + a_mat[:, m].reshape((n1,) + (1,) * (moved.ndim - 1)) \
            * moved[m][None]
    return np.moveaxis(acc, 0, axis)


def plane_walk(x, dhat, xi, w3, variant, geom, lam0, lam1, helm):
    """The plane body in float64: x (E, C, N1^3) -> y, its three launches
    in order over the scratch T and Ypart (E C, N1^3), batch row e C + c,
    a batch row's nodes (k, j, i)."""
    e_count, ncols, n_p = x.shape
    n1 = len(xi)
    nc = n1 * n1
    xb = x.reshape(e_count * ncols, n1, n1, n1)
    # 1. T = D_t x: out(k, q) = sum_m D(k, m) x(m, q) on the lines q = (j, i)
    t = summed(dhat, xb, 1)
    ypart = np.empty_like(xb)
    # 2. a block per (element, plane k), the columns in turn: x_r, x_s on
    # the plane, the factors once a node (held for every column), s_t over
    # T in place, Ypart = mass x + D_r^T s_r + D_s^T s_s.  Each plane's
    # sums touch that plane alone, so the planes go together here.
    nodes = np.arange(n_p)
    i, j, k = nodes % n1, (nodes // n1) % n1, nodes // nc
    for e in range(e_count):
        g, mass = node_factors(variant, geom, lam0, lam1, helm, xi, w3, e,
                               nodes, i, j, k)
        for c in range(ncols):
            b = e * ncols + c
            plane = xb[b]                                 # X(k, j, i)
            xr = summed(dhat, plane, 2).reshape(-1)       # sum X(j,m) D(i,m)
            xs = summed(dhat, plane, 1).reshape(-1)       # sum D(j,m) X(m,i)
            xt = t[b].reshape(-1)
            s_r = g[:, 0] * xr + g[:, 1] * xs + g[:, 2] * xt
            s_s = g[:, 1] * xr + g[:, 3] * xs + g[:, 4] * xt
            t[b] = (g[:, 2] * xr + g[:, 4] * xs
                    + g[:, 5] * xt).reshape(n1, n1, n1)   # in place
            yp = (mass * plane.reshape(-1)).reshape(n1, n1, n1)
            yp = yp + summed(dhat.T, s_r.reshape(n1, n1, n1), 2)
            yp = yp + summed(dhat.T, s_s.reshape(n1, n1, n1), 1)
            ypart[b] = yp
    # 3. y = Ypart + D_t^T S_t
    y = ypart + summed(dhat.T, t, 1)
    return y.reshape(x.shape)


@pytest.mark.parametrize("ncols", [1, 3])
@pytest.mark.parametrize("n1", [25, 32, 48])
@pytest.mark.parametrize("variant,helm", WALK_CASES)
def test_plane_walk_matches_reference(x64, variant, helm, n1, ncols):
    """Two elements, random per-node lam0/lam1 (merged: the reference's
    Lam2/Lam3 of them; partial: its gScale); K1's factors are the port's
    float64 discrete ones, in planes for the walk and packed for the
    reference."""
    b, x, geom, ref_geom, lam0, lam1 = _walk_operands(
        n1, ncols, variant, helm, 1000 * n1 + 10 * ncols + len(variant))
    e = len(x)
    flat = {name: None if v is None else v.reshape(e, -1)
            for name, v in (("lam0", lam0), ("lam1", lam1))}
    ours = plane_walk(x, np.asarray(b.dhat), np.asarray(b.points),
                      np.asarray(b.w3).reshape(-1), variant, geom,
                      flat["lam0"], flat["lam1"], helm)
    shape = (e, ncols, 1) + (n1,) * 3
    kw = {name: jnp.asarray(v) for name, v in (("lam0", lam0),
                                               ("lam1", lam1))
          if v is not None}
    ref = jops.reference(jnp.asarray(x.reshape(shape)), b, variant,
                         jnp.asarray(ref_geom), helmholtz=helm, **kw)
    assert _rel(ours.reshape(shape), ref) <= RTOL64


@pytest.mark.parametrize("n1", range(ops.N1_MAX + 1, ops.N1_PLANE_MAX + 1))
def test_plane_launch_fits_every_order(n1):
    """Launches 1 and 3: one block per batch row and tile of
    PLANE_LINE_TILE lines, the tiles covering the N1^2 lines once, a warp
    per PLANE_REG output rows covering N1 rounded up to PLANE_REG; launch
    2: one block per (element, t-plane), its PLANE_REG x PLANE_REG tiles
    covering the plane in whole warps; the scratch, T and Ypart, 2 E ncols
    N1^3 fp32 words.  Shared memory: with one column, PLANE_MIN_BLOCKS
    plane blocks fit an SM (the source's __launch_bounds__ promise), each
    with its static words and the runtime's reserve; with several (the
    factors held) one block still fits; the line blocks fit too."""
    e, ncols = 64, 3
    lanes = ops.plane_lanes(n1)
    one = ops.plane_launch(n1, e, 1)
    many = ops.plane_launch(n1, e, ncols)
    assert one.kernels == many.kernels == ops.PLANE_KERNELS == 3
    assert ops.KERNELS_PER_APPLICATION["plane"] == ops.PLANE_KERNELS
    # launches 1 and 3
    tiles = many.line_grid[1]
    assert many.line_grid[0] == e * ncols
    assert (tiles - 1) * ops.PLANE_LINE_TILE < n1 * n1 \
        <= tiles * ops.PLANE_LINE_TILE
    assert many.line_threads == ops.PLANE_LINE_LANES * lanes
    assert many.line_threads // 32 * ops.PLANE_REG >= n1 \
        > (many.line_threads // 32 - 1) * ops.PLANE_REG
    assert many.line_smem_bytes == 4 * n1 * (ops.PLANE_REG * lanes
                                             + ops.PLANE_LINE_TILE)
    # launch 2
    assert many.plane_grid == one.plane_grid == e * n1
    assert lanes * ops.PLANE_REG >= n1 > (lanes - 1) * ops.PLANE_REG
    assert many.plane_threads % 32 == 0
    assert many.plane_threads - 32 < lanes * lanes <= many.plane_threads
    pitch = ops.plane_pitch(n1)
    assert pitch % 2 == 1 and n1 <= pitch <= n1 + 1
    assert one.plane_smem_bytes == ops.plane_smem_bytes(n1, False)
    assert many.plane_smem_bytes == ops.plane_smem_bytes(n1, True) \
        == one.plane_smem_bytes + 4 * ops.PLANE_FACTOR_WORDS * n1 * n1
    per_block = one.plane_smem_bytes + ops.PLANE_STATIC_SMEM \
        + ops.SMEM_RESERVED
    assert ops.PLANE_MIN_BLOCKS * per_block <= ops.SMEM_PER_SM
    assert many.plane_smem_bytes + ops.PLANE_STATIC_SMEM \
        <= ops.SMEM_PER_BLOCK
    assert many.line_smem_bytes <= ops.SMEM_PER_BLOCK
    # the scratch
    assert many.scratch_bytes == 2 * e * ncols * n1 ** 3 * 4
    assert one.scratch_bytes == 2 * e * n1 ** 3 * 4


def test_plane_constants_follow_the_source():
    """ops' mirror of the plane body's launch shape is the CUDA source's:
    the register tile, the line kernel's lanes and tile, the blocks an SM
    promised, the held words a node, the shared arrays, the largest N1 and
    the pitch."""
    source = (chip_smoke.ROOT / chip_smoke.SOURCE["plane"]).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             source).group(1))
    assert const("kReg") == ops.PLANE_REG
    assert const("kLineLanes") == ops.PLANE_LINE_LANES
    assert const("kPlaneMinBlocks") == ops.PLANE_MIN_BLOCKS
    assert const("kFactorWords") == ops.PLANE_FACTOR_WORDS
    assert const("kPlaneN1Max") == ops.N1_PLANE_MAX
    assert "kLineTileQ = kReg * kLineLanes" in source
    assert f"({ops.PLANE_ARRAYS} * n * pitch_of(n1)" in source
    assert "return n1 | 1;" in source
    assert "__shared__ float s_g[32];" in source \
        and ops.PLANE_STATIC_SMEM == 4 * 32


def test_the_plane_twin_runs_its_range_and_counts_nothing(fake_card):
    """`plane` (the plane body at any N1 up to N1_PLANE_MAX, timing only)
    takes the generic body's orders too (N1 = 17 to 24), counts no launch,
    and refuses above its range, where the staged body runs: its tiles'
    threads (12^2 at N1 = 48) and registers are sized for no more."""
    before = dict(ops.launch_counts)
    for n1 in (17, 20, 24, ops.N1_PLANE_MAX):
        b = tbasis(n1 - 1)
        ops.plane(_meta((3,) + (n1,) * 3), b, "trilinear",
                  _geom_meta("trilinear", 3, n1))
    assert [name for name, _ in fake_card.calls] == \
        [build.symbol("trilinear_plane", "f32")] * 4
    assert ops.launch_counts == before
    big = ops.N1_PLANE_MAX + 1
    with pytest.raises(ValueError, match="N1_PLANE_MAX"):
        _REAL_CHECK(_meta((3, 1, 1) + (big,) * 3), tbasis(big - 1),
                    "trilinear", _meta((3, 8, 3)), None, None, "plane")
    assert ops.plane_launch(ops.N1_PLANE_MAX, 1, 1).plane_threads == 160


_REAL_CHECK = ops._check_kernel_operands


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1", [ops.N1_MAX, ops.N1_MAX + 1, 32,
                                ops.N1_PLANE_MAX])
@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_axhelm_routes_large_orders_to_the_plane_body(fake_card, variant,
                                                      n1, dtype):
    """N1 above N1_TUNED_MAX up to N1_MAX reaches the slab body
    (`*_slab`), N1 above it the plane body (`*_plane`, the generic body's arguments plus the
    scratch, 2 ncols E N1^3 floats allocated at the call); either way the
    launch counts once under the entry point."""
    b = tbasis(n1 - 1)
    e, helm = 3, variant == "merged"
    before = dict(ops.launch_counts)
    ops.axhelm(_meta((e, 2, 1) + (n1,) * 3, dtype), b, variant,
               _geom_meta(variant, e, n1, dtype), helmholtz=helm,
               **_lams_meta(variant, e, n1, dtype))
    (name, args), = fake_card.calls
    entry = ops.entry_point(variant, dtype)
    assert n1 > ops.N1_TUNED_MAX
    body = "plane" if n1 > ops.N1_MAX else "slab"
    assert ops.body_of(variant, n1) == body
    assert name == f"{entry}_{body}" == build.symbol(
        f"{variant}_{body}", ops.KERNEL_DTYPES[dtype])
    assert len(args) == len(build.SIGNATURES[f"{variant}_{body}"])
    assert args[-1] == 7
    if body == "any":
        assert args[8:12] == (n1, e, 2, int(helm))
    else:
        assert args[9:13] == (n1, e, 2, int(helm))
    assert ops.launch_counts[entry] == before[entry] + 1
    assert sum(ops.launch_counts.values()) == sum(before.values()) + 1


def test_the_generic_twin_stops_at_n1_max():
    """`generic` (the generic body at any N1, timing only) refuses what its
    body cannot hold, though `axhelm` runs that order on the plane body."""
    n1 = ops.N1_MAX + 1
    x = _meta((3, 1, 1) + (n1,) * 3)
    with pytest.raises(ValueError, match="N1_MAX = 24"):
        ops._check_kernel_operands(x, tbasis(n1 - 1), "trilinear",
                                   _meta((3, 8, 3)), None, None, "any")
    # the entry point's own check passes the order and stops at the device
    with pytest.raises(ValueError, match="CUDA device"):
        ops._check_kernel_operands(x, tbasis(n1 - 1), "trilinear",
                                   _meta((3, 8, 3)), None, None)


def test_chip_smoke_checks_the_plane_body_where_it_runs():
    """The orders chip_smoke.py checks, solves and times the plane body at
    are ones it runs, the cap among them; its source holds the kernels."""
    n1s = [o + 1 for o in chip_smoke.PLANE_ORDERS]
    assert all(ops.N1_MAX < n1 <= ops.N1_PLANE_MAX for n1 in n1s)
    assert ops.N1_PLANE_MAX in n1s
    assert chip_smoke.HIGH_ORDER + 1 in n1s
    source = (chip_smoke.ROOT / chip_smoke.SOURCE["plane"]).read_text()
    assert "axhelm_plane_kernel" in source
    assert "axhelm_plane_line_kernel" in source
    assert all(o + 1 <= ops.N1_PLANE_MAX for o in chip_smoke.GENERIC_ORDERS)
    assert chip_smoke.STAGED_ORDER + 1 > ops.N1_PLANE_MAX


# ------------------------------------------- the slice against the JAX one

@pytest.fixture
def one_thread():
    """torch on one thread for a solve's many small operations: under the
    test run's parallel workers, its intra-op threads spent far longer
    handing work to each other than working (326 s against 6 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_order_25_solve_matches_reference(one_thread):
    """The port's 2x1x1 order-25 solve (N1 = 26, 34,476 dofs) on the CPU
    through the kernels' plain version, against the reference package's
    `backend="reference"` solve of the same manufactured problem."""
    mesh = jmesh.deform_trilinear(jmesh.box_mesh(2, 1, 1, 25), seed=3)
    x_true = np.random.default_rng(4).standard_normal(mesh.n_global)
    tol, max_iter = 1e-6, 1000
    prob = jnek.setup_problem(mesh, variant="trilinear", dtype=jnp.float32,
                              backend="reference")
    jres = jnek.solve(prob, jnek.rhs_from_solution(
        prob, jnp.asarray(x_true, jnp.float32)), tol=tol, max_iter=max_iter)
    tprob = tnek.setup_problem(convert.mesh_from_numpy(mesh),
                               variant="trilinear", backend="cuda",
                               device="cpu")
    assert tprob.backend == "cuda"
    b = tnek.rhs_from_solution(tprob, torch.as_tensor(x_true,
                                                      dtype=torch.float32))
    tres = tnek.solve(tprob, b, tol=tol, max_iter=max_iter)
    assert int(tres.status) == int(jres.status) == SolveStatus.CONVERGED
    assert abs(int(tres.iterations) - int(jres.iterations)) <= 1
    assert _rel(tres.x, jres.x) <= RTOL32


def test_n1_26_application_matches_the_pallas_kernel():
    """One application at N1 = 26 (order 25), two elements, two columns:
    the port's entry point on CPU tensors (its plain version) against the
    reference's Pallas kernel in interpret mode, float32."""
    n = 25
    mesh = jmesh.deform_trilinear(jmesh.box_mesh(2, 1, 1, n), seed=3)
    x = np.random.default_rng(7).standard_normal(
        (2, 2, 1) + (n + 1,) * 3).astype(np.float32)
    verts = np.asarray(mesh.verts, np.float32)
    y_pallas = jops.axhelm(jnp.asarray(x), jbasis(n), "trilinear",
                           jnp.asarray(verts), block_elems=1, interpret=True)
    elem_ops, apply, _ = taxhelm.make_axhelm_elem_ops(
        "trilinear", tbasis(n), torch.as_tensor(verts), backend="cuda",
        device="cpu")
    y = apply(torch.as_tensor(x), elem_ops)
    assert _rel(y, y_pallas) <= RTOL32


@pytest.mark.parametrize("order", [31, 47])
def test_setup_holds_at_high_orders(x64, order):
    """The GLL basis at N1 = 32 and the cap, and the precomputed problem's
    setup (factors, the fixed-order gather, the Jacobi diagonal) on a
    1x1x2 box, against the reference package's in float64: <= 1e-12
    relative (the same setup math; the operator's sums in another order).
    In float32 both packages' operators lie ~1e-4 from the float64 one at
    these orders, so float64 is where their setups can be told apart."""
    tb, jb = tbasis(order), jbasis(order)
    for name in ("points", "weights", "dhat", "w3"):
        assert _rel(getattr(tb, name), getattr(jb, name)) <= RTOL64
    mesh = jmesh.deform_trilinear(jmesh.box_mesh(1, 1, 2, order), seed=3)
    tprob = tnek.setup_problem(convert.mesh_from_numpy(mesh),
                               variant="precomputed", backend="reference",
                               dtype=torch.float64, device="cpu")
    jprob = jnek.setup_problem(mesh, variant="precomputed",
                               dtype=jnp.float64, backend="reference")
    x = np.random.default_rng(order).standard_normal(mesh.n_global)
    assert _rel(tprob.op(torch.as_tensor(x)), jprob.op(jnp.asarray(x))) \
        <= RTOL64
    assert _rel(tprob.diag, jprob.diag) <= RTOL64
