"""The line body of the K1 (precomputed), K3 (parallelepiped) and K4
(merged) axhelm kernels, `csrc/axhelm_line.cu`, on the CPU: what of it is
not CUDA.

* Its phases, written here in the kernel's order on its padded shared
  layout (the r and s lines and the node columns of an element, the
  factors applied by the column owner, the transposes on the lines, the
  three sums), against the reference package's jnp oracle: float64,
  <= 1e-12 relative (the same formulas in another order), K1 and K3
  Poisson and Helmholtz with per-node lambdas (K1's factors read from its
  planar (E, 7, N1^3) operand, plane p of node n at p N1^3 + n) and K4,
  N in {3, 7}.
* That the roles cover every line and column of an element once, and that
  the layout is free of bank conflicts at N1 = 8, as the source note counts.
* The wrapper's persistent launch arithmetic (every element exactly once
  over the blocks' walk), the by-value D-hat and xi and the storage-rounded
  w3 on the device, the arguments `ops` passes to each new entry point,
  its refusal of a misaligned staged operand, and `chip_smoke.py`'s
  knowledge of the body.

The kernels themselves run on the card only: tests/test_torch_cuda.py.
"""

import ctypes
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import axhelm as jax_axhelm
from repro.core import geometry as jgeom
from repro.core import mesh_gen as jmesh
from repro.core.spectral import basis as jbasis
from repro.kernels.axhelm import ops as jops
from repro.kernels.axhelm import ref as jref
from repro_torch.core.spectral import basis as tbasis
from repro_torch.kernels.axhelm import build, ops

from test_torch_axhelm_column import (_comment_table, _meta,  # noqa: F401
                                      _source_table, _wavefront_ways,
                                      column_geometry, fake_card)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import chip_smoke  # noqa: E402
import line_staging_sweep  # noqa: E402
from _torch_x64 import x64  # noqa: F401

RTOL64 = 1e-12


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def slab_stride(n1, itemsize):
    """The kernel's slab_stride: values of a k-slab in shared memory."""
    return n1 * n1 + 16 // itemsize


def s_plane(n1, q):
    """The kernel's k'' of the s lines of threads q N1 .. q N1 + N1 - 1: a
    permutation of 0..N1-1 (2q mod N1 + 2q / N1 at even N1, 2q mod N1 at
    odd)."""
    return (2 * q) % n1 + ((2 * q) // n1 if n1 % 2 == 0 else 0)


def roles(n1):
    """Per thread t of an element: its node column (i, j), its r line
    (j', k') and its s line (i', k''), as the kernel assigns them."""
    out = []
    for t in range(n1 * n1):
        q = t // n1
        out.append({"col": (t % n1, t // n1), "r": (t // n1, t % n1),
                    "s": (t % n1, s_plane(n1, q))})
    return out


def sr_index(n1, sp, k, j, i):
    """Where s_r (and s_s) hold node (i, j, k)."""
    return k * sp + j * n1 + i


def line_body(x, dhat, xi, w3, variant, geom, lam0, lam1, helmholtz):
    """The kernel's phases in float64: x (E, C, N1^3) -> y, one element
    column at a time, through the padded slabs of s_x, s_r and s_s; each
    phase vectorised over the element's threads, each thread's role as
    `roles` gives it."""
    e_count, ncols = x.shape[:2]
    n1 = len(xi)
    nc, m = n1 * n1, np.arange(n1)
    sx = sp = slab_stride(n1, 4)
    if variant == "merged":                               # (E, k, j, i, 6)
        _, adj, _, _, _ = column_geometry(geom, xi, w3.reshape((n1,) * 3))
    t = np.arange(nc)
    rs = roles(n1)
    rj, rk = (np.array([r["r"][a] for r in rs]) for a in (0, 1))
    si, sk = (np.array([r["s"][a] for r in rs]) for a in (0, 1))
    row_x = rk[:, None] * sx + rj[:, None] * n1 + m        # (threads, m)
    row_p = rk[:, None] * sp + rj[:, None] * n1 + m
    sline_x = sk[:, None] * sx + m * n1 + si[:, None]
    sline_p = sk[:, None] * sp + m * n1 + si[:, None]
    col_x = m[:, None] * sx + t                            # (m, threads)
    y = np.empty_like(x)
    for e in range(e_count):
        for c in range(ncols):
            xs = np.zeros(n1 * sx)
            # the Stager: thread t's N1 values at t N1 % N1^2 of slab
            # t N1 / N1^2
            xs[((t * n1 // nc) * sx + t * n1 % nc)[:, None] + m] = \
                x[e, c].reshape(nc, n1)
            pr, ps = np.zeros(n1 * sp), np.zeros(n1 * sp)
            pr[row_p] = xs[row_x] @ dhat.T                 # (A)
            ps[sline_p] = xs[sline_x] @ dhat.T
            xt = dhat @ xs[col_x]                          # (n, threads)
            yv = np.zeros((n1, nc))                        # (B)
            for k in range(n1):
                o, node = k * sp + t, k * nc + t
                gr, gs, gt = pr[o], ps[o], xt[k]
                if variant == "merged":
                    g = adj[e, k].reshape(nc, 6).T
                    scale, mass = lam0[e, node], lam1[e, node]
                elif variant == "precomputed":     # planar (E, 7, N1^3)
                    g = geom[e, :6][:, node]
                    scale = 1 if lam0 is None else lam0[e, node]
                    mass = geom[e, 6, node] * (
                        1 if lam1 is None else lam1[e, node])
                else:
                    g = np.broadcast_to(geom[e, :6, None], (6, nc))
                    scale = w3[node] * (1 if lam0 is None else lam0[e, node])
                    mass = geom[e, 6] * w3[node] * (
                        1 if lam1 is None else lam1[e, node])
                gr, gs, gt = gr * scale, gs * scale, gt * scale
                pr[o] = g[0] * gr + g[1] * gs + g[2] * gt
                ps[o] = g[1] * gr + g[3] * gs + g[4] * gt
                yv += dhat[k][:, None] * (g[2] * gr + g[4] * gs + g[5] * gt)
                if helmholtz:
                    yv[k] += mass * xs[k * sx + t]
            pr[row_p] = pr[row_p] @ dhat                   # (C)
            ps[sline_p] = ps[sline_p] @ dhat
            for k in range(n1):                            # (D)
                y[e, c, k * nc + t] = yv[k] + ps[k * sp + t] + pr[
                    sr_index(n1, sp, k, t // n1, t % n1)]
    return y


LINE_CASES = [("parallelepiped", False), ("parallelepiped", True),
              ("merged", True), ("precomputed", False), ("precomputed", True)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 9, 12, 15])
@pytest.mark.parametrize("variant,helm", LINE_CASES)
def test_line_phases_match_reference(x64, variant, helm, n):
    """K1 and K3 with per-node lam0 (and lam1) fields, K4 with the
    reference's Lam2/Lam3 of random lambdas; two columns an element; N1 =
    2, 3, 4, 5, 6, 8, 10, 13 and 16.  K1's factors are the reference's
    discrete ones, laid out in planes for the model and packed for the
    reference."""
    rng = np.random.default_rng(10 * n + helm)
    b = jbasis(n)
    n1 = b.n1
    box = jmesh.box_mesh(2, 1, 2, n) if n1 <= 8 else jmesh.box_mesh(2, 1, 1,
                                                                     n)
    ref_geom = None
    if variant == "parallelepiped":
        verts = np.asarray(jmesh.deform_affine(box, seed=2).verts)
        geom = np.asarray(jref.gelem_from_verts(jnp.asarray(verts)))
    elif variant == "precomputed":
        verts = jnp.asarray(jmesh.deform_trilinear(box, seed=3).verts)
        f = jgeom.factors_discrete(jgeom.node_coords(verts, b), b)
        ref_geom = np.concatenate([np.asarray(f.g),
                                   np.asarray(f.gwj)[..., None]], axis=-1)
        geom = np.moveaxis(ref_geom, -1, 1).reshape(len(verts), 7, -1)
    else:
        geom = np.asarray(jmesh.deform_trilinear(box, seed=3).verts)
    e = len(geom)
    x = rng.standard_normal((e, 2, n1 ** 3))
    lam0 = 1 + 0.3 * rng.random((e, n1 ** 3))
    lam1 = 0.5 + 0.2 * rng.random((e, n1 ** 3)) if helm else None
    if variant == "merged":
        node = (e, n1, n1, n1)
        lam2, lam3 = jax_axhelm.setup_merged_lambdas(
            jnp.asarray(geom), b, jnp.asarray(lam0.reshape(node)),
            jnp.asarray(lam1.reshape(node)))
        lam0 = np.asarray(lam2).reshape(e, -1)
        lam1 = np.asarray(lam3).reshape(e, -1)
    ours = line_body(x, np.asarray(b.dhat), np.asarray(b.points),
                     np.asarray(b.w3).reshape(-1), variant, geom, lam0, lam1,
                     helm)
    shape = (e, 2) + (n1,) * 3
    kw = {"lam0": jnp.asarray(lam0.reshape((e,) + (n1,) * 3))}
    if lam1 is not None:
        kw["lam1"] = jnp.asarray(lam1.reshape((e,) + (n1,) * 3))
    ref = jops.reference(jnp.asarray(x.reshape(shape)), b, variant,
                         jnp.asarray(geom if ref_geom is None else ref_geom),
                         helmholtz=helm, **kw)
    assert _rel(ours.reshape(shape), ref) <= RTOL64


@pytest.mark.parametrize("n1", ops.KERNEL_N1)
def test_roles_cover_every_line_and_column_once(n1):
    rs = roles(n1)
    full = sorted((a, b) for a in range(n1) for b in range(n1))
    for role in ("col", "r", "s"):
        assert sorted(r[role] for r in rs) == full


def _wavefronts(addresses, width):
    """Shared-memory wavefronts of one warp instruction: `addresses` the
    lanes' byte addresses, `width` bytes a lane.  A 16-byte access runs in
    phases of 8 lanes, an 8-byte one of 16, narrower ones in one; a phase
    takes as many wavefronts as the most distinct 4-byte words in one of
    the 32 banks."""
    lanes = {16: 8, 8: 16}.get(width, 32)
    total = 0
    for p in range(0, len(addresses), lanes):
        banks = {}
        for a in addresses[p:p + lanes]:
            for w in range(a // 4, (a + max(width, 4) - 1) // 4 + 1):
                banks.setdefault(w % 32, set()).add(w)
        total += max(len(words) for words in banks.values())
    return total


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("access", ["column", "s_line", "stager"])
def test_staged_x_layout_is_free_of_bank_conflicts(access, itemsize):
    """At N1 = 8 each warp instruction on the staged x takes the fewest
    wavefronts its bytes allow -- the owner's column reads at fixed k, the
    s lines' reads at fixed m (and s_s, fp32 with the same stride, as the
    f32 case) -- but the Stager's 16-byte stores (thread t's N1 values at
    offset t N1 % N1^2 of slab t N1 / N1^2), which conflict two ways in
    fp32, as the source note counts."""
    n1 = 8
    sx = slab_stride(n1, itemsize)
    for warp in (0, 1):
        threads = range(32 * warp, 32 * warp + 32)
        lanes = [roles(n1)[t] for t in threads]
        if access == "stager":
            for q in range(n1 * itemsize // 16):
                addr = [((t * n1 // 64) * sx + t * n1 % 64) * itemsize
                        + 16 * q for t in threads]
                assert _wavefronts(addr, 16) == {4: 8, 2: 4}[itemsize]
        elif access == "column":
            for k in range(n1):
                addr = [(k * sx + r["col"][0] + n1 * r["col"][1]) * itemsize
                        for r in lanes]
                assert _wavefronts(addr, itemsize) == 1
        else:
            for m in range(n1):
                addr = [(r["s"][1] * sx + m * n1 + r["s"][0]) * itemsize
                        for r in lanes]
                assert _wavefronts(addr, itemsize) == 1


@pytest.mark.parametrize("access", ["r_line", "column"])
def test_r_components_layout_is_free_of_bank_conflicts(access):
    """s_r (fp32) at N1 = 8: the r lines' 16-byte row accesses, the eight
    lanes of a vector phase k' = 0..7 at fixed j', start 17 k' + 2 j'
    16-byte words apart; the owner reads 32 consecutive words at fixed
    k."""
    n1 = 8
    sp = slab_stride(n1, 4)
    for warp in (0, 1):
        lanes = [roles(n1)[t] for t in range(32 * warp, 32 * warp + 32)]
        if access == "r_line":
            for q in range(2):
                addr = [4 * sr_index(n1, sp, r["r"][1], r["r"][0], 4 * q)
                        for r in lanes]
                assert _wavefronts(addr, 16) == 4
        else:
            for k in range(n1):
                addr = [4 * sr_index(n1, sp, k, r["col"][1], r["col"][0])
                        for r in lanes]
                assert _wavefronts(addr, 4) == 1


def line_bank_ways(n1, itemsize):
    """The ways of the worst phase of each of the line body's shared
    accesses over every warp of a block (`_wavefront_ways`): the Stager's
    stores ("stager", vectors of `ops.staged_alignment`), the r lines'
    rows, the s lines' reads at fixed m and the owner's at fixed k, of x
    ("x row", "x s", "x col", in the storage type, rows as `load_row`
    reads them) and of s_r, s_s ("p row", "p s", "p col", fp32); slabs
    padded by 16 bytes, element e of a block N1 slabs after e - 1."""
    nc = n1 * n1
    sx, sp = slab_stride(n1, itemsize), slab_stride(n1, 4)
    vec = ops.staged_alignment(n1, itemsize)
    wx = next((v for v in (16, 8, 4) if (n1 * itemsize) % v == 0), itemsize)
    wp = next(v for v in (16, 8, 4) if (4 * n1) % v == 0)
    threads = ops.line_threads(n1)
    ways = dict.fromkeys(("stager", "x row", "x s", "x col", "p row", "p s",
                          "p col"), 0)

    def add(name, addresses, width):
        ways[name] = max(ways[name], _wavefront_ways(addresses, width))
    rs = roles(n1)
    for w0 in range(0, threads, 32):
        lanes = [(th // nc, th % nc, rs[th % nc])
                 for th in range(w0, min(w0 + 32, threads))]
        ex = [le * n1 * sx for le, _, _ in lanes]
        ep = [le * n1 * sp for le, _, _ in lanes]
        for q in range(n1 * itemsize // vec):
            add("stager", [itemsize * (b + (u * n1 // nc) * sx + u * n1 % nc)
                           + vec * q for b, (_, u, _) in zip(ex, lanes)], vec)
        for q in range(n1 * itemsize // wx):
            add("x row", [itemsize * (b + r["r"][1] * sx + r["r"][0] * n1)
                          + wx * q for b, (_, _, r) in zip(ex, lanes)], wx)
        for q in range(4 * n1 // wp):
            add("p row", [4 * (b + r["r"][1] * sp + r["r"][0] * n1) + wp * q
                          for b, (_, _, r) in zip(ep, lanes)], wp)
        for m in range(n1):
            add("x s", [itemsize * (b + r["s"][1] * sx + m * n1 + r["s"][0])
                        for b, (_, _, r) in zip(ex, lanes)], itemsize)
            add("p s", [4 * (b + r["s"][1] * sp + m * n1 + r["s"][0])
                        for b, (_, _, r) in zip(ep, lanes)], 4)
            add("x col", [itemsize * (b + m * sx + u)
                          for b, (_, u, _) in zip(ex, lanes)], itemsize)
            add("p col", [4 * (b + m * sp + u)
                          for b, (_, u, _) in zip(ep, lanes)], 4)
    return ways


LINE_BANK_ROWS = ("stager", "x row", "x s", "x col", "p row", "p s", "p col")


@pytest.mark.parametrize("n1", ops.KERNEL_N1)
def test_line_bank_conflicts_are_what_the_source_states(n1):
    """The model's ways of each access, fp32 and bf16, are the source
    note's tables (bf16's s_r and s_s are fp32's); at N1 = 8 they are the
    conflict-free layout the tests above count, but for the fp32 Stager."""
    text = (ROOT / chip_smoke.SOURCE["line"]).read_text()
    for itemsize, first, rows in ((4, "fp32 N1:", LINE_BANK_ROWS),
                                  (2, "bf16 N1:", LINE_BANK_ROWS[:4])):
        table = _comment_table(text, first, rows)
        ways = line_bank_ways(n1, itemsize)
        assert {k: ways[k] for k in rows} == {k: table[k][n1] for k in rows}
    if n1 == 8:
        assert line_bank_ways(8, 4) == dict(
            dict.fromkeys(LINE_BANK_ROWS, 1), stager=2)
        assert set(line_bank_ways(8, 2).values()) == {1}


@pytest.mark.parametrize("n_sm", [1, 2, 132])
@pytest.mark.parametrize("n_elem", [1, 2, 3, 37, 4096, 4099])
@pytest.mark.parametrize("n1", ops.KERNEL_N1)
def test_line_launch_covers_every_element_once(n1, n_elem, n_sm):
    """The kernel's walk: block b takes groups b, b + grid, ...; group g
    holds elements g * per_block + l, the absent ones of the last group
    masked.  The elements a block fill whole warps but for a few lanes of
    the last (LINE_THREADS at N1 = 4 and 8), at most 16 warps an SM and
    about 128 registers a thread (one block, up to 255, where the lines'
    products stay unrolled from LINE_ONE_BLOCK_FROM), and a block's shared
    memory (and the SM's blocks') fits, for every variant and storage type;
    the grid takes the blocks an SM it is given (what the card holds)."""
    threads = ops.line_threads(n1)
    warps = -(-threads // 32)
    assert ops.line_elems(n1) >= 1 and threads <= 256
    if n1 in (4, 8):
        assert threads == ops.LINE_THREADS
    assert threads >= 0.75 * 32 * warps
    for variant in ops.LINE_VARIANTS:
        blocks = ops.line_min_blocks(n1, variant)
        assert blocks * warps <= 16 and 65536 // (blocks * warps * 32) >= 128
        wide = n1 >= ops.LINE_ONE_BLOCK_FROM and \
            not ops.line_rolls(variant, n1)
        assert (blocks == 1) >= wide
        assert ops.line_rolls(variant, n1) == (
            variant != "parallelepiped" and
            n1 >= {"precomputed": 12, "merged": 11}[variant])
        for itemsize in (4, 2):
            smem = ops.line_smem_bytes(n1, variant, itemsize)
            assert smem <= ops.SMEM_PER_BLOCK and blocks * smem <= 233472
    blocks = 3
    per_block, grid = ops.line_launch(n1, n_elem, n_sm, blocks)
    assert per_block == ops.line_elems(n1)
    groups = -(-n_elem // per_block)
    assert 1 <= grid == min(groups, n_sm * blocks)
    seen = []
    for block in range(grid):
        for g in range(block, groups, grid):
            seen += [g * per_block + le for le in range(per_block)
                     if g * per_block + le < n_elem]
    assert sorted(seen) == list(range(n_elem))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [3, 7])
def test_parallelepiped_takes_dhat_xi_by_value_and_w3_on_the_device(
        fake_card, n, dtype):
    """K3's launch: the column body's by-value D-hat and xi, and the w3
    array the plain version computes with, on x's device."""
    b = tbasis(n)
    n1 = b.n1
    x = torch.zeros((3, 1, 1) + (n1,) * 3, dtype=dtype)
    ops._launch(x, b, "parallelepiped", torch.zeros((3, 7), dtype=dtype),
                None, None, False)
    (name, args), = fake_card.calls
    dhat, xi, w3 = ops._constants(n, dtype, torch.device("cpu"))
    assert name == ops.entry_point("parallelepiped", dtype)
    assert args[5] == w3.data_ptr()
    assert args[6] == ops._column_consts(n, dtype).data_ptr()
    assert w3.dtype == torch.float32 and w3.is_contiguous()
    assert w3.shape == (n1, n1, n1)


def test_bf16_w3_holds_the_rounded_products():
    """At bf16 storage w3 is the bf16 rounding of the products w_i w_j w_k,
    as the plain version holds it -- not the fp32 products."""
    b = tbasis(7)
    _, _, w3 = ops._constants(7, torch.bfloat16, torch.device("cpu"))
    assert torch.equal(w3, w3.bfloat16().float())
    exact = torch.as_tensor(np.asarray(b.w3))
    assert torch.equal(w3, exact.bfloat16().float())
    assert not torch.equal(w3, exact.float())


def _line_call(variant, dtype, x):
    e = x.shape[0]
    geom = _meta((e, 7) if variant == "parallelepiped" else (e, 8, 3), dtype)
    kw = {}
    if variant == "merged":
        kw = {name: _meta((e, 8, 8, 8), dtype) for name in ("lam0", "lam1")}
    return geom, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ops.LINE_VARIANTS)
def test_wrapper_passes_line_entry_points_their_arguments(fake_card, variant,
                                                          dtype):
    b = tbasis(7)
    e, helm = 37, variant == "merged"
    x = _meta((e, 2, 3, 8, 8, 8), dtype)
    geom, kw = _line_call(variant, dtype, x)
    before = dict(ops.launch_counts)
    ops.axhelm(x, b, variant, geom, helmholtz=helm, **kw)
    (name, args), = fake_card.calls
    assert name == ops.entry_point(variant, dtype) == build.symbol(
        variant, ops.KERNEL_DTYPES[dtype])
    assert len(args) == len(build.SIGNATURES[variant])
    assert ops.launch_counts[name] == before[name] + 1
    assert args[-1] == 7                                   # the stream
    assert args[-3:-1] == ops.line_launch(8, e, 132, ops.LINE_BLOCKS_PER_SM)
    # parallelepiped passes w3 before the constants, helmholtz after the
    # sizes
    at = 6 if variant == "parallelepiped" else 5
    assert args[at] == ops._column_consts(7, dtype).data_ptr()
    assert args[at + 1:at + 4] == (8, e, 6)
    if variant == "parallelepiped":
        assert args[at + 4] == 0                           # helmholtz


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ops.LINE_VARIANTS)
def test_misaligned_staged_operand_raises(fake_card, variant, dtype):
    """A contiguous x one value into its storage is not 16-byte aligned:
    the wrapper raises before any launch, and counts none."""
    b = tbasis(7)
    x = _meta((5 * 512 + 1,), dtype)[1:].view(5, 8, 8, 8)
    assert x.is_contiguous() and x.data_ptr() % 16
    geom, kw = _line_call(variant, dtype, x)
    before = dict(ops.launch_counts)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        ops.axhelm(x, b, variant, geom, helmholtz=variant == "merged", **kw)
    assert fake_card.calls == [] and ops.launch_counts == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1", [4, 8])
@pytest.mark.parametrize("variant", ops.LINE_VARIANTS)
def test_misaligned_x_still_raises_at_n1_4_and_8(fake_card, variant, n1,
                                                 dtype):
    """A contiguous x one 8-byte step (fp32) or one 4-byte step (bf16) off
    a 16-byte boundary: N1 = 4 and 8 stage with 16- (or, bf16 N1 = 4,
    8-) byte vectors, which refuse it, as before N1 2-16 ran here."""
    b = tbasis(n1 - 1)
    np_ = n1 ** 3
    step = 2
    x = _meta((5 * np_ + step,), dtype)[step:].view(5, n1, n1, n1)
    assert x.data_ptr() % ops.staged_alignment(n1, x.element_size())
    geom, kw = _line_call_n1(variant, dtype, x, n1)
    with pytest.raises(ValueError, match="aligned address"):
        ops.axhelm(x, b, variant, geom, helmholtz=variant == "merged", **kw)
    assert fake_card.calls == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1", [2, 3, 5, 6, 7, 9, 10, 13, 16])
@pytest.mark.parametrize("variant", ops.LINE_VARIANTS)
def test_operands_at_an_element_offset_are_taken(fake_card, variant, n1,
                                                 dtype):
    """x, Lam2 and Lam3 from element 1 of a batch on (a shard's interior
    launch takes such views): at odd N1 an element's N1^3 values end off
    any vector boundary, and the Stager there moves one value a load
    (`staged_alignment`), so the wrapper takes them and launches; at even
    N1 the element offset keeps the vectors' alignment."""
    b = tbasis(n1 - 1)
    np_ = n1 ** 3
    x = _meta((6, np_), dtype)[1:].view(5, n1, n1, n1)
    need = ops.staged_alignment(n1, x.element_size())
    assert x.data_ptr() % need == 0
    assert (n1 % 2 == 1) == (need == x.element_size())
    if n1 % 2:
        assert (np_ * x.element_size()) % 8
    geom, kw = _line_call_n1(variant, dtype, x, n1)
    kw = {k: _meta((6, np_), dtype)[1:].view(5, n1, n1, n1) for k in kw}
    ops.axhelm(x, b, variant, geom, helmholtz=variant == "merged", **kw)
    (name, args), = fake_card.calls
    assert name == ops.entry_point(variant, dtype)
    assert args[-3:-1] == ops.line_launch(n1, 5, 132,
                                          ops.line_min_blocks(n1, variant))


def _line_call_n1(variant, dtype, x, n1):
    e = x.shape[0]
    geom = _meta({"parallelepiped": (e, 7),
                  "precomputed": (e, 7, n1, n1, n1)}.get(variant, (e, 8, 3)),
                 dtype)
    kw = {}
    if variant == "merged":
        kw = {name: _meta((e, n1, n1, n1), dtype) for name in ("lam0", "lam1")}
    return geom, kw


@pytest.mark.parametrize("slot", ["lam0", "lam1"])
def test_misaligned_merged_lambda_raises(fake_card, slot):
    b = tbasis(7)
    x = _meta((5, 8, 8, 8))
    geom, kw = _line_call("merged", torch.float32, x)
    kw[slot] = _meta((5 * 512 + 1,))[1:].view(5, 8, 8, 8)
    with pytest.raises(ValueError, match=f"stages {slot}"):
        ops.axhelm(x, b, "merged", geom, helmholtz=True, **kw)
    assert fake_card.calls == []


def test_rowwise_of_line_variants_skips_the_alignment_check(fake_card):
    """The timing-only node body reads x with plain loads."""
    x = _meta((5 * 512 + 1,))[1:].view(5, 8, 8, 8)
    ops.rowwise(x, tbasis(7), "parallelepiped", _meta((5, 7)))
    (name, _), = fake_card.calls
    assert name == "axhelm_parallelepiped_f32_rowwise"


_LINE_REPORT = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__2b1c9d31_14_axhelm_line_cu_5e0a51b118axhelm_line_kernelILi8ELN13axhelm_detail10GeomSourceE3E13__nv_bfloat16EEvPKT1_PS4_S6_S6_S6_NS_10LineConstsIXT_EEEiii' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__2b1c9d31_14_axhelm_line_cu_5e0a51b118axhelm_line_kernelILi8ELN13axhelm_detail10GeomSourceE3E13__nv_bfloat16EEvPKT1_PS4_S6_S6_S6_NS_10LineConstsIXT_EEEiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 21248 bytes smem, 2736 bytes cmem[0]
"""


def test_ptxas_report_names_the_line_body():
    (line,) = build.ptxas_instantiations(_LINE_REPORT)
    assert line == {"variant": "merged", "body": "line", "n1": 8,
                    "dtype": "bf16", "spill_stores": 0, "spill_loads": 0,
                    "registers": 90, "smem_bytes": 21248}


def test_chip_smoke_names_the_line_source():
    assert {v for v, body in chip_smoke.BODY.items() if body == "line"} \
        == set(ops.LINE_VARIANTS)
    assert chip_smoke.SOURCE["line"].endswith("csrc/axhelm_line.cu")
    assert (chip_smoke.ROOT / chip_smoke.SOURCE["line"]).is_file()
    assert set(ops.ROWWISE_VARIANTS) == set(ops.COLUMN_VARIANTS) | set(
        ops.LINE_VARIANTS)


def test_sweep_finds_the_shipped_stager():
    """scripts/line_staging_sweep.py swaps the Stager of the shipped source
    (vector loads) for its bulk-copy one: exactly one matches, and the swap
    leaves the rest of the source as it was."""
    text = (ROOT / chip_smoke.SOURCE["line"]).read_text()
    found = line_staging_sweep._STAGER.findall(text)
    assert len(found) == 1 and "bulk_copy" not in found[0]
    swapped = line_staging_sweep._STAGER.sub(
        lambda _: line_staging_sweep.BULK_STAGER, text, count=1)
    assert swapped.replace(line_staging_sweep.BULK_STAGER, found[0]) == text
    assert "cp.async.bulk" in swapped and "\\n.reg" in swapped
    for name in ("kLineThreads = ", "kLineMinBlocks = ", "kStages = "):
        assert text.count(name) == 1


def test_launch_constants_follow_the_source():
    """The wrapper's launch arithmetic mirrors the line body's constants:
    threads a block and blocks an SM at N1 = 4 and 8 (the sweep changes
    both sides), the elements a block at every other N1, and the N1 up to
    which it holds K3's w3 and stages K4's fields."""
    text = (ROOT / chip_smoke.SOURCE["line"]).read_text()

    def const(name):
        return re.search(rf"{name} = (\w+);", text).group(1)
    assert int(const("kLineThreads")) == ops.LINE_THREADS
    assert int(const("kLineMinBlocks")) == ops.LINE_BLOCKS_PER_SM
    assert int(const("kLineHoldMax")) == ops.LINE_HOLD_MAX
    assert int(const("kLineOneBlockFrom")) == ops.LINE_ONE_BLOCK_FROM
    roll = re.search(r"return src == kPrecomputed \? (\d+) : src == kMerged "
                     r"\? (\d+) : (\d+);", text).groups()
    assert dict(zip(("precomputed", "merged"), map(int, roll[:2]))) == \
        ops.LINE_ROLL_FROM and int(roll[2]) > ops.N1_TUNED_MAX
    elems = _source_table(text, "elems")
    assert {n1: elems[n1] for n1 in ops.LINE_ELEMS} == ops.LINE_ELEMS
    assert elems[4] == elems[8] == 0             # kLineThreads / N1^2 there
    assert set(ops.LINE_ELEMS) | {4, 8} == set(ops.KERNEL_N1)


@pytest.mark.parametrize("stager", ["loads", "bulk"])
def test_sweep_patches_in_bulk_copied_factors(stager):
    """The sweep's K1 bulk-factor option, which the shipped source does not
    hold: every anchor of `with_bulk_factors` is in the line body once (with
    either stager), its one set of mbarrier primitives lands before the
    kernel, and the owners read the staged buffer in place of device
    memory."""
    text = (ROOT / chip_smoke.SOURCE["line"]).read_text()
    assert "mbar_init" not in text and "bulk_copy(" not in text
    if stager == "bulk":
        text = line_staging_sweep._STAGER.sub(
            lambda _: line_staging_sweep.BULK_STAGER, text, count=1)
    patched = line_staging_sweep.with_bulk_factors(text)
    assert patched.count("void mbar_init(") == 1
    assert patched.count("void fetch_factors(") == 1
    assert patched.index("void bulk_copy(") < \
        patched.index("void fetch_factors(") < \
        patched.index("__global__ void")
    assert "fp = geom + ev * 7 * NP + t;" not in patched
    assert "fp = sm.f[fbuf][le] + t;" in patched
    assert "(SRC == kPrecomputed && misaligned(geom, 16))" in patched
    with pytest.raises(ValueError, match="anchor"):
        line_staging_sweep.with_bulk_factors(patched)


class _Occupancy:
    """A library whose occupancy query answers `blocks` and records its
    arguments."""

    def __init__(self, blocks):
        self.blocks, self.calls = blocks, []

    def axhelm_line_blocks_per_sm(self, *args):
        self.calls.append(args)
        return self.blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ops.LINE_VARIANTS)
def test_line_grid_takes_what_the_card_holds(monkeypatch, variant, dtype):
    """At N1 = 4 and 8 the persistent grid keeps LINE_BLOCKS_PER_SM blocks
    an SM without asking the card; at every other N1 it asks the occupancy
    calculator (the geometry source's enum value, bf16 or not, N1), caches
    the answer, and refuses one below 1."""
    import contextlib
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    lib = _Occupancy(3)
    monkeypatch.setattr(build, "library", lambda: lib)
    ops._line_blocks.cache_clear()
    dev = torch.device("cpu")
    for n1 in (4, 8):
        assert ops._line_blocks(variant, dtype, n1, dev) == \
            ops.LINE_BLOCKS_PER_SM
    assert lib.calls == []
    for n1 in (2, 11, 16):
        assert ops._line_blocks(variant, dtype, n1, dev) == 3
        assert ops._line_blocks(variant, dtype, n1, dev) == 3
    assert lib.calls == [(chip_smoke.VARIANTS.index(variant),
                          int(dtype == torch.bfloat16), n1)
                         for n1 in (2, 11, 16)]
    assert ops.line_launch(11, 4096, 132, 3) == (1, 396)
    lib.blocks = 0
    ops._line_blocks.cache_clear()
    with pytest.raises(RuntimeError, match="occupancy"):
        ops._line_blocks(variant, dtype, 13, dev)
    ops._line_blocks.cache_clear()
    assert build.QUERIES == {"axhelm_line_blocks_per_sm": [ctypes.c_int] * 3}
