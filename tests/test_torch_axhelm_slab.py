"""The slab body of the axhelm kernels (`csrc/axhelm_slab.cu`), which runs
every variant at the N1 from N1_TUNED_MAX + 1 to N1_SLAB_MAX that
`ops.body_of` routes to it, on the CPU: what of it is not CUDA.

* Its two launches, written here in float64 in the kernel's order of
  sums: per (element, slab of SLAB_PLANES t-planes) and column, the whole
  element's x staged, x_t across the slab's planes and x_r, x_s in each,
  the factors per node (the generic body's `node_factors`), s_t into the
  first scratch field and Ypart = mass x + D_r^T s_r + D_s^T s_s into the
  second; then y = Ypart + D_t^T S_t.  Against the reference package's
  jnp oracle in float64, <= 1e-12 relative (the same formulas in another
  order): all five geometry sources at N1 = 17, 20 and 24, E = 2, c = 1
  and 3.
* `ops.slab_launch` at every N1 from 17 to 24: the kernel's index
  arithmetic (slabs, register tiles, the column walk of the factors and
  of S_t's stores, launch 2's lines) covers every output once, the copy of
  x covers the column at every offset inside its shared memory, the
  threads fit the source's bound, shared memory the blocks an SM the
  design counts on; the source's constants it mirrors; the timing-only
  twin `ops.slab`'s range, counting nothing.
* Which C symbol `ops` reaches at N1 = 17 to 24, with which arguments,
  through the stand-in library of tests/test_torch_axhelm_column.py;
  where `chip_smoke.py` checks and times the body, and its ptxas parse.
* The slice against the JAX package: one operator application at N1 = 18
  against the reference's Pallas kernel in interpret mode (<= 1e-4
  relative, float32).

The kernel itself runs on the card only: tests/test_torch_slab_cuda.py.
"""

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mesh_gen as jmesh
from repro.core.spectral import basis as jbasis
from repro.kernels.axhelm import ops as jops
from repro_torch.core import axhelm as taxhelm
from repro_torch.core.spectral import basis as tbasis
from repro_torch.kernels.axhelm import build, ops

from test_torch_axhelm_column import _meta, fake_card  # noqa: F401
from test_torch_axhelm_generic import (WALK_CASES, _geom_meta, _lams_meta,
                                       _rel, node_factors)
from test_torch_axhelm_staged import _walk_operands

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _torch_x64 import x64  # noqa: F401,E402

RTOL64 = 1e-12
RTOL32 = 1e-4
MIDDLE_N1 = range(ops.N1_TUNED_MAX + 1, ops.N1_SLAB_MAX + 1)


def contract(a_mat, operand, axis):
    """sum_m A(p, m) operand(.., m, ..) along `axis` of `operand`, the
    output's axis (A's rows) in its place: the terms added one m at a time,
    m upward, as every sum of the kernel runs."""
    moved = np.moveaxis(operand, axis, 0)
    acc = np.zeros((a_mat.shape[0],) + moved.shape[1:])
    for m in range(a_mat.shape[1]):
        acc = acc + a_mat[:, m].reshape((-1,) + (1,) * (moved.ndim - 1)) \
            * moved[m][None]
    return np.moveaxis(acc, 0, axis)


def slab_walk(x, dhat, xi, w3, variant, geom, lam0, lam1, helm):
    """The slab body in float64: x (E, C, N1^3) -> y, its two launches in
    order over the scratch S_t and Ypart, every scratch word written once
    before launch 2 reads it."""
    e_count, ncols, _ = x.shape
    n1 = len(xi)
    nc = n1 * n1
    launch = ops.slab_launch(n1, e_count, ncols)
    xb = x.reshape(e_count, ncols, n1, n1, n1)
    st = np.full_like(xb, np.nan)
    ypart = np.full_like(xb, np.nan)
    # 1. a block per (element, slab), the columns in turn
    for e in range(e_count):
        for slab in range(launch.slabs):
            ks = np.arange(slab * ops.SLAB_PLANES,
                           min((slab + 1) * ops.SLAB_PLANES, n1))
            nodes = (ks[:, None] * nc + np.arange(nc)[None]).reshape(-1)
            i, j, k = nodes % n1, (nodes // n1) % n1, nodes // nc
            g, mass = node_factors(variant, geom, lam0, lam1, helm, xi, w3,
                                   e, nodes, i, j, k)
            shape = (len(ks), n1, n1)
            for c in range(ncols):
                s_x = xb[e, c]                        # the whole element
                xt = contract(dhat[ks], s_x, 0).reshape(-1)
                xr = contract(dhat, s_x[ks], 2).reshape(-1)
                xs = contract(dhat, s_x[ks], 1).reshape(-1)
                s_r = (g[:, 0] * xr + g[:, 1] * xs
                       + g[:, 2] * xt).reshape(shape)
                s_s = (g[:, 1] * xr + g[:, 3] * xs
                       + g[:, 4] * xt).reshape(shape)
                assert np.isnan(st[e, c, ks]).all()
                st[e, c, ks] = (g[:, 2] * xr + g[:, 4] * xs
                                + g[:, 5] * xt).reshape(shape)
                yp = (mass * s_x[ks].reshape(-1)).reshape(shape)
                yp = yp + contract(dhat.T, s_r, 2)
                ypart[e, c, ks] = yp + contract(dhat.T, s_s, 1)
    # 2. y = Ypart + D_t^T S_t, a thread a line
    assert not np.isnan(st).any() and not np.isnan(ypart).any()
    y = ypart + contract(dhat.T, st, 2)
    return y.reshape(x.shape)


@pytest.mark.parametrize("ncols", [1, 3])
@pytest.mark.parametrize("n1", [17, 20, 24])
@pytest.mark.parametrize("variant,helm", WALK_CASES)
def test_slab_walk_matches_reference(x64, variant, helm, n1, ncols):
    """Two elements, random per-node lam0/lam1 (merged: the reference's
    Lam2/Lam3 of them; partial: its gScale); K1's factors are the port's
    float64 discrete ones, in planes for the walk and packed for the
    reference.  N1 = 17 leaves a last slab of one plane, 20 none, 24 six
    slabs of four."""
    b, x, geom, ref_geom, lam0, lam1 = _walk_operands(
        n1, ncols, variant, helm, 2000 * n1 + 10 * ncols + len(variant))
    e = len(x)
    flat = {name: None if v is None else v.reshape(e, -1)
            for name, v in (("lam0", lam0), ("lam1", lam1))}
    ours = slab_walk(x, np.asarray(b.dhat), np.asarray(b.points),
                     np.asarray(b.w3).reshape(-1), variant, geom,
                     flat["lam0"], flat["lam1"], helm)
    shape = (e, ncols, 1) + (n1,) * 3
    kw = {name: jnp.asarray(v) for name, v in (("lam0", lam0),
                                               ("lam1", lam1))
          if v is not None}
    ref = jops.reference(jnp.asarray(x.reshape(shape)), b, variant,
                         jnp.asarray(ref_geom), helmholtz=helm, **kw)
    assert _rel(ours.reshape(shape), ref) <= RTOL64


def _launch1_outputs(n1, threads, slabs):
    """The nodes (k, j, i) launch 1's blocks of one element write, as the
    kernel's index arithmetic gives them: x_r, x_s and Ypart from the (p,
    tj, ti) tiles, x_t from the (tjt, ti) tiles, the weighted components
    and S_t from the walk over node columns r (each column's planes)."""
    lanes = ops.plane_lanes(n1)
    reg = ops.PLANE_REG
    tiles, xt, coalesced = [], [], []
    for slab in range(slabs):
        k0 = slab * ops.SLAB_PLANES
        planes = min(ops.SLAB_PLANES, n1 - k0)
        for t in range(threads):
            tp, tile = divmod(t, lanes * lanes)
            tj, ti = divmod(tile, lanes)
            tjt = t // lanes
            for u in range(reg):
                for v in range(reg):
                    j, i = tj + u * lanes, ti + v * lanes
                    if tp < planes and j < n1 and i < n1:
                        tiles.append((k0 + tp, j, i))
                    i = ti + v * lanes
                    if tjt < n1 and u < planes and i < n1:
                        xt.append((k0 + u, tjt, i))
        for t in range(threads):
            for r in range(t, n1 * n1, threads):
                for p in range(planes):
                    coalesced.append((k0 + p, r // n1, r % n1))
    return tiles, xt, coalesced


def _x_words(n1):
    """The source's x_words: the copy of x, N1^3 words behind a shift of up
    to 7, in whole 16-byte units."""
    return (n1 ** 3 + 14) // 8 * 8


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n1", [17, 18, 20, 23, 24])
def test_copy_of_x_covers_the_column_at_every_offset(n1, itemsize):
    """stage_x: a column of N1^3 values starting `offset` bytes into a
    16-byte unit (every offset the storage type allows) lands at shift =
    offset / itemsize in the copy, its 16-byte units covering the column
    from the unit of its first value to the unit of its last, every unit
    whole and aligned at both ends, all inside x_words (the margins hold
    the values beside the column, which nothing reads)."""
    count = n1 ** 3
    per_unit = 16 // itemsize
    for offset in range(0, 16, itemsize):
        shift = offset // itemsize
        units = (shift + count + per_unit - 1) // per_unit
        assert units * per_unit >= shift + count
        assert (units - 1) * per_unit < shift + count
        assert units * per_unit <= _x_words(n1)
        assert shift + count <= _x_words(n1)


@pytest.mark.parametrize("n1", MIDDLE_N1)
def test_slab_launch_fits_every_order(n1):
    """Launch 1: one block per (element, slab of SLAB_PLANES t-planes),
    the slabs covering the N1 planes (the last ragged); SLAB_PLANES
    plane_lanes(N1)^2 threads in whole warps, at most the source's
    kSlabThreadsMax (160), enough for x_t's N1 plane_lanes(N1) tiles; its
    tiles and its column walk write every node once.  Shared memory: D-hat,
    the copy of x and the three slab arrays, 53,872 bytes at N1 = 20 and
    86,528 at 24, so that with the static words and the runtime's reserve
    an SM holds the blocks its registers allow (three of four warps at N1
    <= 20, two of five above); the held factors still fit a block.  Launch
    2: a thread a line of every batch row.  The scratch, S_t and Ypart, 2 E
    ncols N1^3 fp32 words."""
    e, ncols = 216, 3
    one, many = ops.slab_launch(n1, e, 1), ops.slab_launch(n1, e, ncols)
    lanes = ops.plane_lanes(n1)
    assert one.kernels == many.kernels == ops.SLAB_KERNELS == 2
    assert ops.KERNELS_PER_APPLICATION["slab"] == ops.SLAB_KERNELS
    slabs = many.slabs
    assert (slabs - 1) * ops.SLAB_PLANES < n1 <= slabs * ops.SLAB_PLANES
    assert many.grid == one.grid == e * slabs
    threads = many.threads
    assert threads % 32 == 0 and threads <= 160
    assert threads - 32 < ops.SLAB_PLANES * lanes * lanes <= threads
    assert n1 * lanes <= threads
    tiles, xt, coalesced = _launch1_outputs(n1, threads, slabs)
    every = sorted((k, j, i) for k in range(n1) for j in range(n1)
                   for i in range(n1))
    assert sorted(tiles) == sorted(xt) == sorted(coalesced) == every
    pitch = ops.plane_pitch(n1)
    x_words = _x_words(n1)
    assert one.smem_bytes == ops.slab_smem_bytes(n1, False) == 4 * (
        -(-n1 * pitch // 4) * 4 + x_words
        + ops.SLAB_ARRAYS * ops.SLAB_PLANES * n1 * pitch)
    assert many.smem_bytes == one.smem_bytes \
        + 4 * ops.PLANE_FACTOR_WORDS * ops.SLAB_PLANES * n1 * n1
    per_block = one.smem_bytes + ops.SLAB_STATIC_SMEM + ops.SMEM_RESERVED
    assert ops.SMEM_PER_SM // per_block >= (3 if n1 <= 20 else 2)
    assert threads == (128 if n1 <= 20 else 160)
    assert many.smem_bytes + ops.SLAB_STATIC_SMEM <= ops.SMEM_PER_BLOCK
    # launch 2: a thread a line (j, i) of each batch row
    lines = e * ncols * n1 * n1
    assert many.last_threads == ops.SLAB_LAST_THREADS
    assert (many.last_grid - 1) * many.last_threads < lines \
        <= many.last_grid * many.last_threads
    assert many.scratch_bytes == 2 * e * ncols * n1 ** 3 * 4


def test_slab_constants_follow_the_source():
    """ops' mirror of the slab body's launch shape is the CUDA source's:
    the register tile, the planes a slab, the blocks an SM promised, the
    held words a node, the largest N1, the shared arrays and the pitch;
    launch 2 is the slab body's own kernel, a thread a line, not the
    plane body's line kernel."""
    source = (chip_smoke.ROOT / chip_smoke.SOURCE["slab"]).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             source).group(1))
    assert const("kReg") == ops.PLANE_REG
    assert const("kSlabPlanes") == ops.SLAB_PLANES
    assert const("kSlabMinBlocks") == ops.SLAB_MIN_BLOCKS
    assert const("kFactorWords") == ops.PLANE_FACTOR_WORDS
    assert const("kSlabN1Max") == ops.N1_SLAB_MAX == ops.N1_MAX
    assert const("kLastThreads") == ops.SLAB_LAST_THREADS
    assert f"{ops.SLAB_ARRAYS} * kSlabPlanes * n * pitch_of(n1)" in source
    assert "return (n1 * n1 * n1 + 7 + 7) / 8 * 8;" in source
    assert "return (n1 * pitch_of(n1) + 3) / 4 * 4;" in source
    assert "return n1 | 1;" in source
    assert "__shared__ float s_g[32];" in source
    assert "__shared__ float s_e[uses_vertices(SRC) ? 36 : 1];" in source
    assert ops.SLAB_STATIC_SMEM == 4 * (32 + 36)
    assert "axhelm_slab_last_kernel" in source


def test_the_slab_twin_runs_its_range_and_counts_nothing(fake_card):
    """`slab` (the slab body at any N1 up to N1_SLAB_MAX, timing only)
    reaches `*_slab` with the plane body's arguments and its scratch,
    counts no launch, and refuses above its range, where no block holds
    the element's x beside its slab."""
    before = dict(ops.launch_counts)
    for n1 in (2, 8, 17, 20, ops.N1_SLAB_MAX):
        ops.slab(_meta((3,) + (n1,) * 3), tbasis(n1 - 1), "trilinear",
                 _geom_meta("trilinear", 3, n1))
    assert [name for name, _ in fake_card.calls] == \
        [build.symbol("trilinear_slab", "f32")] * 5
    assert all(len(args) == len(build.SIGNATURES["trilinear_slab"])
               for _, args in fake_card.calls)
    assert ops.launch_counts == before
    big = ops.N1_SLAB_MAX + 1
    with pytest.raises(ValueError, match="N1_SLAB_MAX"):
        _REAL_CHECK(_meta((3, 1, 1) + (big,) * 3), tbasis(big - 1),
                    "trilinear", _meta((3, 8, 3)), None, None, "slab")


_REAL_CHECK = ops._check_kernel_operands


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1", MIDDLE_N1)
@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_axhelm_routes_middle_orders_to_their_body(fake_card, variant, n1,
                                                   dtype):
    """N1 from 17 to 24 reaches the slab body, which takes the generic
    body's arguments plus its scratch; the launch counts once under the
    entry point."""
    b = tbasis(n1 - 1)
    e, helm = 3, variant == "merged"
    before = dict(ops.launch_counts)
    ops.axhelm(_meta((e, 2, 1) + (n1,) * 3, dtype), b, variant,
               _geom_meta(variant, e, n1, dtype), helmholtz=helm,
               **_lams_meta(variant, e, n1, dtype))
    (name, args), = fake_card.calls
    entry = ops.entry_point(variant, dtype)
    assert ops.body_of(variant, n1) == "slab"
    assert name == f"{entry}_slab" == build.symbol(
        f"{variant}_slab", ops.KERNEL_DTYPES[dtype])
    assert len(args) == len(build.SIGNATURES[f"{variant}_slab"])
    assert args[9:13] == (n1, e, 2, int(helm)) and args[-1] == 7
    assert ops.launch_counts[entry] == before[entry] + 1
    assert sum(ops.launch_counts.values()) == sum(before.values()) + 1


def test_middle_orders_route_as_the_turns_measured():
    """Every variant at every N1 from 17 to 24 runs the slab body, the
    fastest for nine or ten of the ten entry points at N1 = 17 and for all
    ten above in the --generic turns (PERF.md); the N1 on either side run
    the tuned and plane bodies, and the twins keep their own bodies."""
    tuned = {v: "column" if v in ops.COLUMN_VARIANTS else "line"
             for v in ops.KERNEL_VARIANTS}
    for v in ops.KERNEL_VARIANTS:
        assert [ops.body_of(v, n1) for n1 in MIDDLE_N1] == \
            ["slab"] * len(MIDDLE_N1)
        assert ops.body_of(v, MIDDLE_N1[0] - 1) == tuned[v]
        assert ops.body_of(v, MIDDLE_N1[-1] + 1) == "plane"
        assert ops.body_of(v, MIDDLE_N1[0], "any") == "any"
    assert tuple(MIDDLE_N1) == tuple(range(17, 25))


_SLAB_REPORT = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__5c1f0a2e_14_axhelm_slab_cu_3d0c6f1e18axhelm_slab_kernelILN13axhelm_detail10GeomSourceE4E13__nv_bfloat16EEvNS_8SlabArgsIT0_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__5c1f0a2e_14_axhelm_slab_cu_3d0c6f1e18axhelm_slab_kernelILN13axhelm_detail10GeomSourceE4E13__nv_bfloat16EEvNS_8SlabArgsIT0_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, used 1 barriers, 272 bytes smem
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__5c1f0a2e_14_axhelm_slab_cu_3d0c6f1e23axhelm_slab_last_kernelIfEEvPT_PKfS5_S5_il' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__5c1f0a2e_14_axhelm_slab_cu_3d0c6f1e23axhelm_slab_last_kernelIfEEvPT_PKfS5_S5_il
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers, used 1 barriers, 2304 bytes smem
"""


def test_chip_smoke_checks_the_slab_body_where_it_runs():
    """chip_smoke.py checks the slab body at every N1 from 17 to 24 on
    SLAB_ELEMS elements (one, a few, the 6x6x6 box), times it beside the
    generic body and the plane twin at GENERIC_ORDERS (its main path's
    order among them), and parses its kernels from the ptxas report (names
    as nvcc 12.9 mangles them for sm_90a: a variant's pass over its slabs,
    and launch 2 every variant shares, variant None); its source holds the
    kernels."""
    assert tuple(chip_smoke.SLAB_N1) == tuple(MIDDLE_N1)
    assert chip_smoke.SLAB_ELEMS == (1, 3, 216)
    assert chip_smoke.SOURCE["slab"].endswith("csrc/axhelm_slab.cu")
    assert build.SLAB_SHARED_PASSES == ("last",)
    assert build.SLAB_VARIANT_PASSES == ("slab",)
    assert all(o + 1 in MIDDLE_N1 for o in chip_smoke.GENERIC_ORDERS)
    assert chip_smoke.GENERIC_MAIN_ORDER in chip_smoke.GENERIC_ORDERS
    assert "axhelm_slab_kernel" in (chip_smoke.ROOT
                                    / chip_smoke.SOURCE["slab"]).read_text()
    inst, last = build.ptxas_instantiations(_SLAB_REPORT)
    assert inst == {"variant": "partial", "body": "slab", "pass": "slab",
                    "n1": None, "dtype": "bf16", "spill_stores": 0,
                    "spill_loads": 0, "registers": 166, "smem_bytes": 272}
    assert last == {"variant": None, "body": "slab", "pass": "last",
                    "n1": None, "dtype": "f32", "spill_stores": 0,
                    "spill_loads": 0, "registers": 110, "smem_bytes": 2304}


# ------------------------------------------- the slice against the JAX one

def test_n1_18_application_matches_the_pallas_kernel():
    """One application at N1 = 18 (order 17), two elements, two columns:
    the port's entry point on CPU tensors (its plain version) against the
    reference's Pallas kernel in interpret mode, float32."""
    n = 17
    mesh = jmesh.deform_trilinear(jmesh.box_mesh(2, 1, 1, n), seed=3)
    x = np.random.default_rng(8).standard_normal(
        (2, 2, 1) + (n + 1,) * 3).astype(np.float32)
    verts = np.asarray(mesh.verts, np.float32)
    y_pallas = jops.axhelm(jnp.asarray(x), jbasis(n), "trilinear",
                           jnp.asarray(verts), block_elems=1, interpret=True)
    elem_ops, apply, _ = taxhelm.make_axhelm_elem_ops(
        "trilinear", tbasis(n), torch.as_tensor(verts), backend="cuda",
        device="cpu")
    y = apply(torch.as_tensor(x), elem_ops)
    assert _rel(y, y_pallas) <= RTOL32
