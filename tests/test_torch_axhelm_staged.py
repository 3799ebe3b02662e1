"""The staged body of the axhelm kernels (`csrc/axhelm_staged.cu`), which
runs every variant at N1 above the plane body's N1_PLANE_MAX, on the
CPU: what of it is not CUDA.

* Its walk, written here in the kernel's order: seven launches over fp32
  scratch S0, S1, S2 (and M for the Helmholtz mass) — the three
  contractions of x (D_r, D_s, D_t), the pointwise factors in place and
  the mass into M, then S0 = D_r^T S0 in place, S0 += D_s^T S1,
  y = S0 + D_t^T S2 (+ M x) — each contraction block by block: a block
  stages its panel (the whole contracted axis of its tile of lines), then
  sums each tile of output rows over D-hat's steps, zero-padded at the
  ragged edges, and stores only the outputs that exist.  Blocks run one
  after another on the arrays themselves, so a block that wrote lines
  another block still had to read would show.  Against the reference
  package's jnp oracle in float64, <= 1e-12 relative: all five geometry
  sources at N1 = 49 and 50, E = 2, c = 1 and 3, and at N1 = 7 with a
  tile of (4, 8, 3) (ragged in rows, lines and depth).
* `ops.staged_launch`'s arithmetic, `N1_STAGED_MAX`, and which C symbol
  `ops` reaches at N1 = 48, 49 and 64 with which arguments and counts,
  through the stand-in library of tests/test_torch_axhelm_column.py.
* The slice against the JAX package: one application at N1 = 49 through
  the port's CPU entry point against the reference's Pallas kernel in
  interpret mode (<= 1e-4 relative, float32), and the port's 2x1x1
  order-48 solve against the reference package's `backend="reference"`
  solve (the same status, iterations within +-1, x within 1e-4).

The kernel itself runs on the card only: tests/test_torch_staged_cuda.py.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import axhelm as jax_axhelm
from repro.core import mesh_gen as jmesh
from repro.core import nekbone as jnek
from repro.core.spectral import basis as jbasis
from repro.kernels.axhelm import ops as jops
from repro.kernels.axhelm import ref as jref
from repro_torch import convert
from repro_torch.core import axhelm as taxhelm
from repro_torch.core import geometry as tgeom
from repro_torch.core import nekbone as tnek
from repro_torch.core.spectral import basis as tbasis
from repro_torch.kernels.axhelm import build, ops
from repro_torch.resilience.status import SolveStatus

from test_torch_axhelm_column import _meta, fake_card  # noqa: F401
from test_torch_axhelm_generic import (WALK_CASES, _geom_meta, _lams_meta,
                                       _rel, node_factors)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _torch_x64 import x64  # noqa: F401,E402

RTOL64 = 1e-12
RTOL32 = 1e-4


def line_offsets(direction: str, n1: int):
    """Where each line of a batch row starts, and the stride along it: D_t
    lines q = (j, i), D_s lines q = (k, i), D_r lines q = (k, j)."""
    q = np.arange(n1 * n1)
    if direction == "t":
        return q, n1 * n1
    if direction == "s":
        return (q // n1) * n1 * n1 + q % n1, n1
    return q * n1, 1


def contraction(operand, a_mat, direction, tile, store):
    """One contraction launch: out(b, p, q) = sum_m A(p, m) in(b, m, q),
    block (b, line tile) after block.  Each block stages its panel of
    `operand` (B, N1^3) first, then per tile of output rows sums the steps
    of A, zero-padded past N1 as the kernel's shared tiles are, and hands
    the outputs that exist to `store(b, nodes, values)`."""
    rows, lines, depth = tile
    n1 = a_mat.shape[0]
    off, stride = line_offsets(direction, n1)
    m = np.arange(n1)
    a_pad = np.zeros((-(-n1 // rows) * rows, -(-n1 // depth) * depth))
    a_pad[:n1, :n1] = a_mat
    for b in range(operand.shape[0]):
        for q0 in range(0, n1 * n1, lines):
            q = np.arange(q0, q0 + lines)
            real = q < n1 * n1
            panel = np.zeros((a_pad.shape[1], lines))
            panel[:n1, real] = operand[b, off[q[real]][None, :]
                                       + m[:, None] * stride]
            for p0 in range(0, n1, rows):
                acc = np.zeros((rows, lines))
                for m0 in range(0, n1, depth):
                    acc += a_pad[p0:p0 + rows, m0:m0 + depth] \
                        @ panel[m0:m0 + depth]
                p = np.arange(p0, p0 + rows)
                keep = p < n1
                nodes = off[q[real]][None, :] + p[keep][:, None] * stride
                store(b, nodes, acc[np.ix_(keep, real)])


def into(comp):
    """A contraction's store that writes its outputs into `comp`."""
    def store(b, nodes, v):
        comp[b, nodes] = v
    return store


def staged_walk(x, dhat, xi, w3, variant, geom, lam0, lam1, helm,
                tile=ops.STAGED_TILE):
    """The staged body in float64: x (E, C, N1^3) -> y, its seven launches
    in order over the scratch S0, S1, S2 (E C, N1^3), batch row e C + c,
    and the mass M (E, N1^3)."""
    e_count, ncols, n_p = x.shape
    n1 = len(xi)
    nc = n1 * n1
    xb = x.reshape(e_count * ncols, n_p)
    s = {d: np.empty_like(xb) for d in "rst"}     # S0, S1, S2
    # 1-3: the gradient
    for d in "rst":
        contraction(xb, dhat, d, tile, into(s[d]))
    # 4: the factors and the mass, once a node, used by every column; the
    # components in place
    nodes = np.arange(n_p)
    i, j, k = nodes % n1, (nodes // n1) % n1, nodes // nc
    mass = np.empty((e_count, n_p))
    for e in range(e_count):
        g, mass[e] = node_factors(variant, geom, lam0, lam1, helm, xi, w3,
                                  e, nodes, i, j, k)
        for c in range(ncols):
            b = e * ncols + c
            xr, xs, xt = s["r"][b], s["s"][b], s["t"][b]
            s["r"][b], s["s"][b], s["t"][b] = (
                g[:, 0] * xr + g[:, 1] * xs + g[:, 2] * xt,
                g[:, 1] * xr + g[:, 3] * xs + g[:, 4] * xt,
                g[:, 2] * xr + g[:, 4] * xs + g[:, 5] * xt)
    # 5: S0 = D_r^T S0, in place
    contraction(s["r"], dhat.T, "r", tile, into(s["r"]))

    # 6: S0 += D_s^T S1
    def accumulate(b, at, v):
        s["r"][b, at] = s["r"][b, at] + v
    contraction(s["s"], dhat.T, "s", tile, accumulate)
    # 7: y = S0 + D_t^T S2 (+ M x)
    y = np.empty_like(xb)

    def last(b, at, v):
        yv = s["r"][b, at] + v
        if helm:
            yv = yv + mass[b // ncols, at] * xb[b, at]
        y[b, at] = yv
    contraction(s["t"], dhat.T, "t", tile, last)
    return y.reshape(x.shape)


def _walk_operands(n1, ncols, variant, helm, seed):
    """x, the walk's geometry and lambdas, and the reference's, on the
    2x1x1 box at order n1 - 1 (K1's factors are the port's float64
    discrete ones, in planes for the walk and packed for the reference)."""
    n = n1 - 1
    rng = np.random.default_rng(seed)
    b = jbasis(n)
    box = jmesh.box_mesh(2, 1, 1, n)
    mesh = jmesh.deform_affine(box, seed=2) if variant == "parallelepiped" \
        else jmesh.deform_trilinear(box, seed=3)
    verts = np.asarray(mesh.verts, np.float64)
    e = len(verts)
    node = (e, n1, n1, n1)
    x = rng.standard_normal((e, ncols, n1 ** 3))
    lam0, lam1 = 1 + 0.3 * rng.random(node), 0.5 + 0.2 * rng.random(node)
    ref_geom = geom = verts
    if variant == "precomputed":
        tb = tbasis(n)
        f = tgeom.factors_discrete(
            tgeom.node_coords(torch.as_tensor(verts), tb), tb)
        ref_geom = np.concatenate([f.g.numpy(), f.gwj[..., None].numpy()],
                                  axis=-1)
        geom = np.moveaxis(ref_geom, -1, 1).reshape(e, 7, -1)
    elif variant == "parallelepiped":
        ref_geom = geom = np.asarray(jref.gelem_from_verts(jnp.asarray(verts)))
    elif variant == "merged":
        lam2, lam3 = jax_axhelm.setup_merged_lambdas(
            jnp.asarray(verts), b, jnp.asarray(lam0), jnp.asarray(lam1))
        lam0, lam1 = np.asarray(lam2), np.asarray(lam3)
    elif variant == "partial":
        lam0 = np.asarray(jax_axhelm.setup_partial_gscale(jnp.asarray(verts),
                                                          b))
        lam1 = None
    if not helm:
        lam1 = None
    return b, x, geom, ref_geom, lam0, lam1


@pytest.mark.parametrize("n1,ncols,tile", [(49, 1, ops.STAGED_TILE),
                                           (49, 3, ops.STAGED_TILE),
                                           (50, 1, ops.STAGED_TILE),
                                           (50, 3, ops.STAGED_TILE),
                                           (7, 2, (4, 8, 3))])
@pytest.mark.parametrize("variant,helm", WALK_CASES)
def test_staged_walk_matches_reference(x64, variant, helm, n1, ncols, tile):
    """Two elements, random per-node lam0/lam1 (merged: the reference's
    Lam2/Lam3 of them; partial: its gScale).  At N1 = 49 and 50 the
    kernel's tile ragged in rows (64 against 49) and lines (2401 = 37 x 64
    + 33); at N1 = 7 a small tile, two row tiles (4 + 3), seven line tiles
    (49 = 6 x 8 + 1) and three steps of D-hat (3 + 3 + 1)."""
    b, x, geom, ref_geom, lam0, lam1 = _walk_operands(
        n1, ncols, variant, helm, 1000 * n1 + 10 * ncols + len(variant))
    e = len(x)
    flat = {name: None if v is None else v.reshape(e, -1)
            for name, v in (("lam0", lam0), ("lam1", lam1))}
    ours = staged_walk(x, np.asarray(b.dhat), np.asarray(b.points),
                       np.asarray(b.w3).reshape(-1), variant, geom,
                       flat["lam0"], flat["lam1"], helm, tile)
    shape = (e, ncols, 1) + (n1,) * 3
    kw = {name: jnp.asarray(v) for name, v in (("lam0", lam0),
                                               ("lam1", lam1))
          if v is not None}
    ref = jops.reference(jnp.asarray(x.reshape(shape)), b, variant,
                         jnp.asarray(ref_geom), helmholtz=helm, **kw)
    assert _rel(ours.reshape(shape), ref) <= RTOL64


def test_the_walk_sees_a_block_that_writes_lines_it_does_not_own():
    """The in-place pass is only right because a block owns whole lines:
    the same walk with D_r^T's lines split between two blocks along the
    contracted axis (half the panel each, the second reading what the
    first wrote) is wrong by far more than the tolerance."""
    n1, ncols = 9, 1
    rng = np.random.default_rng(3)
    a_mat = rng.standard_normal((n1, n1))
    operand = rng.standard_normal((2, n1 ** 3))
    want = operand.copy()
    contraction(operand.copy(), a_mat, "r", (4, 8, 3), into(want))
    owned = operand.copy()
    contraction(owned, a_mat, "r", (4, 8, 3), into(owned))
    assert _rel(owned, want) <= RTOL64

    split = operand.copy()
    off, _ = line_offsets("r", n1)
    for b in range(2):
        for half in (range(0, 5), range(5, n1)):   # rows p of each block
            p = np.array(list(half))
            lines = split[b, off[:, None] + np.arange(n1)]   # read now
            split[b, off[:, None] + p] = lines @ a_mat[p].T
    assert _rel(split, want) > 1e-3


@pytest.mark.parametrize("n1", [2, 25, 49, 50, 64, 65, 96, 128])
def test_staged_launch_covers_every_output_once(n1):
    """Each contraction: one block per batch row and tile of lines, the
    tiles covering the N1^2 lines once (the last ragged); its panel and a
    step of D-hat in shared memory; the pointwise pass's blocks covering
    each element's nodes once; the scratch three fp32 components, and for
    Helmholtz the mass of each node."""
    e, ncols = 3, 4
    launch = ops.staged_launch(n1, e, ncols)
    rows, lines, depth = launch.tile
    assert launch.tile == ops.STAGED_TILE == (64, 64, 16)
    assert launch.threads == ops.STAGED_THREADS == 256
    assert (rows // 16) * (lines // 16) * launch.threads == rows * lines
    assert launch.contract_grid == (e * ncols, -(-n1 * n1 // lines))
    covered = [q for t in range(launch.contract_grid[1])
               for q in range(t * lines, min((t + 1) * lines, n1 * n1))]
    assert covered == list(range(n1 * n1))
    chunks = launch.factor_grid // e
    assert chunks * launch.factor_threads >= n1 ** 3 > \
        (chunks - 1) * launch.factor_threads
    assert launch.smem_bytes == ops.staged_smem_bytes(n1) == \
        4 * (n1 * (lines + 1) + depth * rows)
    assert launch.scratch_bytes == 3 * 4 * e * ncols * n1 ** 3
    assert ops.staged_launch(n1, e, ncols, helmholtz=True).scratch_bytes \
        == launch.scratch_bytes + 4 * e * n1 ** 3
    assert launch.kernels == ops.STAGED_KERNELS == 7
    for d in "rst":                   # every node of a batch row, once
        off, stride = line_offsets(d, n1)
        nodes = (off[:, None] + np.arange(n1)[None, :] * stride).reshape(-1)
        assert sorted(nodes) == list(range(n1 ** 3))


def test_n1_staged_max_is_the_largest_panel_a_block_holds():
    """The staged body's one limit of its own: a contraction block's
    panel (N1 rows of 65 floats) and a 16 x 64 step of D-hat, 232,376
    bytes at N1 = 878 against the 232,448 a block may have; 2,048,383-dof
    order-63 meshes need 20,736 bytes a block."""
    assert ops.staged_smem_bytes(ops.N1_STAGED_MAX) <= ops.SMEM_PER_BLOCK \
        < ops.staged_smem_bytes(ops.N1_STAGED_MAX + 1)
    assert ops.N1_STAGED_MAX == 878
    assert ops.staged_smem_bytes(878) == 232376
    assert ops.staged_smem_bytes(64) == 20736
    assert ops.N1_PLANE_MAX < ops.N1_STAGED_MAX
    with pytest.raises(ValueError, match="N1_STAGED_MAX"):
        ops._check_kernel_operands(
            _meta((1, 1, 1, 1, 1, 1)),
            type("B", (), {"n1": ops.N1_STAGED_MAX + 1,
                           "n": ops.N1_STAGED_MAX}),
            "trilinear", _meta((1, 8, 3)), None, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1", [ops.N1_PLANE_MAX, ops.N1_PLANE_MAX + 1, 64])
@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_axhelm_routes_orders_above_the_cluster_cap_to_the_staged_body(
        fake_card, variant, n1, dtype):
    """N1 up to N1_PLANE_MAX reaches the plane body (`*_plane`), N1 above
    it the staged body (`*_staged`); both take the generic body's
    arguments plus the scratch they allocate at the call (the plane body 2
    ncols E N1^3 floats, the staged body (3 ncols + helmholtz) E N1^3);
    either way one launch of the entry point is counted, and its body
    records how many CUDA kernels an application launches (three for the
    plane body, seven for the staged body)."""
    b = tbasis(n1 - 1)
    e, ncols, helm = 3, 2, variant == "merged"
    before = dict(ops.launch_counts)
    ops.axhelm(_meta((e, ncols, 1) + (n1,) * 3, dtype), b, variant,
               _geom_meta(variant, e, n1, dtype), helmholtz=helm,
               **_lams_meta(variant, e, n1, dtype))
    (name, args), = fake_card.calls
    entry = ops.entry_point(variant, dtype)
    body = "staged" if n1 > ops.N1_PLANE_MAX else "plane"
    assert ops.body_of(variant, n1) == body
    assert name == f"{entry}_{body}" == build.symbol(
        f"{variant}_{body}", ops.KERNEL_DTYPES[dtype])
    assert len(args) == len(build.SIGNATURES[f"{variant}_{body}"])
    assert args[-1] == 7
    assert args[9:13] == (n1, e, ncols, int(helm))
    assert ops.launch_counts[entry] == before[entry] + 1
    assert sum(ops.launch_counts.values()) == sum(before.values()) + 1
    assert ops.KERNELS_PER_APPLICATION[body] == (7 if body == "staged"
                                                 else 3)


@pytest.mark.parametrize("n1", [25, 32, 48, 64])
@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_the_staged_twin_runs_any_order_and_counts_nothing(fake_card,
                                                           variant, n1):
    """`staged` (the staged body at any N1, timing only) takes the staged
    body at the plane body's orders too, and counts no launch."""
    b = tbasis(n1 - 1)
    e = 3
    before = dict(ops.launch_counts)
    ops.staged(_meta((e,) + (n1,) * 3), b, variant,
               _geom_meta(variant, e, n1), helmholtz=variant == "merged",
               **_lams_meta(variant, e, n1))
    assert [name for name, _ in fake_card.calls] == [
        build.symbol(f"{variant}_staged", "f32")]
    assert ops.launch_counts == before


_STAGED_REPORT = """\
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__4a0d319b_16_axhelm_staged_cu_06f277b429axhelm_staged_contract_kernelILi0ELi1E13__nv_bfloat16EEvNS_10StagedArgsIT1_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__4a0d319b_16_axhelm_staged_cu_06f277b429axhelm_staged_contract_kernelILi0ELi1E13__nv_bfloat16EEvNS_10StagedArgsIT1_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__4a0d319b_16_axhelm_staged_cu_06f277b429axhelm_staged_contract_kernelILi2ELi3EfEEvNS_10StagedArgsIT1_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__4a0d319b_16_axhelm_staged_cu_06f277b429axhelm_staged_contract_kernelILi2ELi3EfEEvNS_10StagedArgsIT1_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__4a0d319b_16_axhelm_staged_cu_06f277b428axhelm_staged_factors_kernelILN13axhelm_detail10GeomSourceE3EfEEvNS_10StagedArgsIT0_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__4a0d319b_16_axhelm_staged_cu_06f277b428axhelm_staged_factors_kernelILN13axhelm_detail10GeomSourceE3EfEEvNS_10StagedArgsIT0_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 128 bytes smem
"""


def test_ptxas_report_names_the_staged_body():
    """The staged body's kernels as phase 2 parses them: two contractions
    every variant shares (variant None) and a variant's pointwise pass
    (names as nvcc 12.9 mangles them for sm_90a)."""
    shared, last, factors = chip_smoke.ptxas_instantiations(_STAGED_REPORT)
    spills = {"spill_stores": 0, "spill_loads": 0}
    assert shared == {"variant": None, "body": "staged", "pass": "first_r",
                      "n1": None, "dtype": "bf16", **spills,
                      "registers": 48, "smem_bytes": 0}
    assert last == {"variant": None, "body": "staged",
                    "pass": "last_t", "n1": None, "dtype": "f32", **spills,
                    "registers": 64, "smem_bytes": 0}
    assert factors == {"variant": "merged", "body": "staged",
                       "pass": "factors", "n1": None, "dtype": "f32",
                       **spills, "registers": 40, "smem_bytes": 128}
    assert {"grad_r", "grad_s", "grad_t", "first_r", "accumulate_s",
            "last_t"} == set(chip_smoke.STAGED_SHARED_PASSES)
    assert chip_smoke.STAGED_VARIANT_PASSES == ("factors",)


def test_chip_smoke_checks_the_staged_body_where_it_runs():
    """The orders chip_smoke.py checks the staged body at run it, its main
    path's among them; its source holds the kernels."""
    n1s = [o + 1 for o in chip_smoke.STAGED_ORDERS]
    assert all(n1 > ops.N1_PLANE_MAX for n1 in n1s)
    assert chip_smoke.STAGED_ORDER + 1 in n1s
    assert chip_smoke.STAGED_SMALL_ORDER + 1 > ops.N1_PLANE_MAX
    assert all(o + 1 <= ops.N1_PLANE_MAX
               for o in chip_smoke.STAGED_TWIN_ORDERS)
    source = (chip_smoke.ROOT / chip_smoke.SOURCE["staged"]).read_text()
    assert "axhelm_staged_contract_kernel" in source
    assert "axhelm_staged_factors_kernel" in source


# ------------------------------------------- the slice against the JAX one

@pytest.fixture
def one_thread():
    """torch on one thread for a solve's many small operations (see
    tests/test_torch_axhelm_plane.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_n1_49_application_matches_the_pallas_kernel():
    """One application at N1 = 49 (order 48), two elements, two columns:
    the port's entry point on CPU tensors (its plain version) against the
    reference's Pallas kernel in interpret mode, float32."""
    n = 48
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


def test_order_48_solve_matches_reference(one_thread):
    """The port's 2x1x1 order-48 solve (N1 = 49, 232,897 dofs) on the CPU
    through the kernels' plain version, against the reference package's
    `backend="reference"` solve of the same manufactured problem, at tol
    1e-4 (about 270 iterations: a bounded run of a few seconds each)."""
    mesh = jmesh.deform_trilinear(jmesh.box_mesh(2, 1, 1, 48), seed=3)
    x_true = np.random.default_rng(4).standard_normal(mesh.n_global)
    tol, max_iter = 1e-4, 1000
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
