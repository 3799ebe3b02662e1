"""The staged body of the axhelm kernels (`csrc/axhelm_staged.cu`), which
runs every variant at N1 above the plane body's N1_PLANE_MAX, on the
CPU: what of it is not CUDA.

* Its walk, written here in the kernel's order: six launches over fp32
  scratch S0, S1, S2 (and M for the Helmholtz mass) -- the r and s
  contractions of x, the t contraction with the factors fused into its
  epilogue (per node of its tile: the weighted components in place and
  the mass into M), then S0 = D_r^T S0 in place, S0 += D_s^T S1,
  y = S0 + D_t^T S2 (+ M x) -- each contraction as the kernel's
  persistent blocks walk it: a block takes items of whole lines of one
  batch row in the grid's order, stages the next item's panel (the whole
  contracted axis of its lines) into the other slot of its ring before it
  stores the current item's outputs, sums each pass of output rows over
  the k-steps of D-hat zero-padded at the ragged edges, and stores only
  the outputs that exist.  Blocks run one after another on the arrays
  themselves, so a block that wrote lines another block still had to read
  would show.  Against the reference package's jnp oracle in float64,
  <= 1e-12 relative (the 3xTF32 split left out of the walk): all five
  geometry sources at N1 = 49 and 50, E = 2, c = 1 and 3, the wide and
  the narrow item, and at N1 = 7 with a tile of (4, 8, 3) (ragged in rows,
  lines and depth).
* The 3xTF32 split in numpy (rna rounding to 10 mantissa bits): one
  contraction at N1 = 49, 64 and 96 against float64, and D-hat's split as
  `ops.staged_fragments` lays it out for the mma's A fragment.
* `ops.staged_launch`'s arithmetic, the switch of lines an item at
  `N1_STAGED_WIDE_MAX`, `N1_STAGED_MAX`, and which C symbol `ops` reaches
  at N1 = 48, 49 and 64 with which arguments and counts, through the
  stand-in library of tests/test_torch_axhelm_column.py.
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
# the kernel's tile at the orders the walk runs: output rows a pass, lines
# an item, k-step depth
WIDE = ops.STAGED_TILE
NARROW = (WIDE[0], ops.STAGED_NARROW_LINES, WIDE[2])


def line_offsets(direction: str, n1: int):
    """Where each line of a batch row starts, and the stride along it: D_t
    lines q = (j, i), D_s lines q = (k, i), D_r lines q = (k, j)."""
    q = np.arange(n1 * n1)
    if direction == "t":
        return q, n1 * n1
    if direction == "s":
        return (q // n1) * n1 * n1 + q % n1, n1
    return q * n1, 1


def contraction(operand, a_mat, direction, tile, store, grid=3):
    """One contraction launch: out(b, p, q) = sum_m A(p, m) in(b, m, q).
    Items are (batch row, tile of `lines` lines) in order, block k of the
    persistent grid walking items k, k + grid, ... (blocks one after
    another).  A block stages its first item's panel of `operand` (B,
    N1^3): every line's whole contracted axis, zero past N1 up to the
    depth's multiple; at each item it stages the next item's panel into
    its other slot, then per pass of `rows` output rows sums the k-steps
    of A (zero-padded past N1) in order and hands the outputs that exist
    to `store(b, nodes, values, p, q)`."""
    rows, lines, depth = tile
    n1 = a_mat.shape[0]
    off, stride = line_offsets(direction, n1)
    kp = -(-n1 // depth) * depth
    a_pad = np.zeros((-(-n1 // rows) * rows, kp))
    a_pad[:n1, :n1] = a_mat
    tiles = -(-n1 * n1 // lines)
    items = operand.shape[0] * tiles

    def stage(item):
        b, q0 = divmod(item, tiles)
        q = np.arange(q0 * lines, q0 * lines + lines)
        real = q < n1 * n1
        panel = np.zeros((kp, lines))
        panel[:n1, real] = operand[b, off[q[real]][None, :]
                                   + np.arange(n1)[:, None] * stride]
        return b, q, real, panel

    for block in range(min(grid, items)):
        ring = {block: stage(block)}
        for item in range(block, items, grid):
            if item + grid < items:     # the other slot, before any store
                ring[item + grid] = stage(item + grid)
            b, q, real, panel = ring.pop(item)
            for p0 in range(0, n1, rows):
                acc = np.zeros((rows, lines))
                for m0 in range(0, kp, depth):
                    acc += a_pad[p0:p0 + rows, m0:m0 + depth] \
                        @ panel[m0:m0 + depth]
                p = np.arange(p0, p0 + rows)
                keep = p < n1
                nodes = off[q[real]][None, :] + p[keep][:, None] * stride
                store(b, nodes, acc[np.ix_(keep, real)],
                      np.broadcast_to(p[keep][:, None], nodes.shape),
                      np.broadcast_to(q[real][None, :], nodes.shape))


def into(comp):
    """A contraction's store that writes its outputs into `comp`."""
    def store(b, nodes, v, p, q):
        comp[b, nodes] = v
    return store


def staged_walk(x, dhat, xi, w3, variant, geom, lam0, lam1, helm,
                tile=WIDE):
    """The staged body in float64: x (E, C, N1^3) -> y, its six launches
    in order over the scratch S0, S1, S2 (E C, N1^3), batch row e C + c,
    and the mass M (E, N1^3)."""
    e_count, ncols, n_p = x.shape
    n1 = len(xi)
    xb = x.reshape(e_count * ncols, n_p)
    s = {d: np.full_like(xb, np.nan) for d in "rst"}     # S0, S1, S2
    mass = np.full((e_count, n_p), np.nan)
    # 1-2: the r and s gradients
    for d in "rs":
        contraction(xb, dhat, d, tile, into(s[d]))

    # 3: the t gradient, and per node of each tile its factors (each
    # column's item recomputes them), the weighted components in place and
    # the mass (column 0's item)
    def factors(b, nodes, v, p, q):
        e, c = divmod(b, ncols)
        nodes = nodes.reshape(-1)
        g, m = node_factors(variant, geom, lam0, lam1, helm, xi, w3, e,
                            nodes, q.reshape(-1) % n1, q.reshape(-1) // n1,
                            p.reshape(-1))
        xr, xs, xt = s["r"][b, nodes], s["s"][b, nodes], v.reshape(-1)
        s["r"][b, nodes] = g[:, 0] * xr + g[:, 1] * xs + g[:, 2] * xt
        s["s"][b, nodes] = g[:, 1] * xr + g[:, 3] * xs + g[:, 4] * xt
        s["t"][b, nodes] = g[:, 2] * xr + g[:, 4] * xs + g[:, 5] * xt
        if c == 0:
            mass[e, nodes] = m
    contraction(xb, dhat, "t", tile, factors)
    # 4: S0 = D_r^T S0, in place
    contraction(s["r"], dhat.T, "r", tile, into(s["r"]))

    # 5: S0 += D_s^T S1
    def accumulate(b, at, v, p, q):
        s["r"][b, at] = s["r"][b, at] + v
    contraction(s["s"], dhat.T, "s", tile, accumulate)
    # 6: y = S0 + D_t^T S2 (+ M x)
    y = np.full_like(xb, np.nan)

    def last(b, at, v, p, q):
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


@pytest.mark.parametrize("n1,ncols,tile", [(49, 1, WIDE), (49, 3, WIDE),
                                           (50, 1, WIDE), (50, 3, WIDE),
                                           (7, 2, (4, 8, 3)), (49, 2, NARROW)])
@pytest.mark.parametrize("variant,helm", WALK_CASES)
def test_staged_walk_matches_reference(x64, variant, helm, n1, ncols, tile):
    """Two elements, random per-node lam0/lam1 (merged: the reference's
    Lam2/Lam3 of them; partial: its gScale).  At N1 = 49 and 50 the
    kernel's wide item (32 lines: 2401 = 75 x 32 + 1) and its narrow one
    (16 lines: 150 x 16 + 1), one pass of 64 rows, ragged in rows and in
    depth (49 of 56); at N1 = 7 a small tile, two passes (4 + 3), seven
    line tiles (49 = 6 x 8 + 1) and three k-steps (3 + 3 + 1)."""
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
    """Launch 4 writes its own operand, which is only right because a block
    owns whole lines and holds an item's whole panel while it makes every
    pass of its outputs: the ring's next slot holds other lines.  The walk
    in place agrees with the walk out of place.  Two ways to break the
    rule are wrong by far more than the tolerance: D_r^T's lines split
    between two blocks along the contracted axis (the second reading what
    the first wrote), and a panel stepped along the contracted axis and
    staged again for each pass of output rows (the second pass reading
    rows the first pass wrote), which needs an output field of its own."""
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

    stepped = operand.copy()
    for b in range(2):
        for p0 in range(0, n1, 4):       # each pass stages its panel again
            p = np.arange(p0, min(p0 + 4, n1))
            lines = stepped[b, off[:, None] + np.arange(n1)]
            stepped[b, off[:, None] + p] = lines @ a_mat[p].T
    assert _rel(stepped, want) > 1e-3


def tf32_model(v):
    """float32 values rounded to 10 mantissa bits, to nearest, ties away
    from zero, by frexp: the rounding of `cvt.rna.tf32.f32`."""
    v = np.asarray(v, dtype=np.float32).astype(np.float64)
    mant, expo = np.frexp(v)                      # |mant| in [0.5, 1)
    scaled = np.abs(mant) * 2.0 ** 11             # 11 significant bits
    return (np.sign(mant) * np.floor(scaled + 0.5) / 2.0 ** 11
            * 2.0 ** expo).astype(np.float32)


def split3(v):
    """The 3xTF32 split of float32 values: hi, lo = tf32(v - hi)."""
    hi = tf32_model(v)
    return hi, tf32_model(np.float32(v) - hi)


def test_tf32_rna_rounds_as_the_model():
    """ops.tf32_rna (bit arithmetic, as the card's instruction) against the
    frexp model, ties away from zero included."""
    rng = np.random.default_rng(5)
    v = (rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 8, 4096)
         ).astype(np.float32)
    ties = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                     0.0, -2.5], dtype=np.float32)
    for a in (v, ties):
        assert np.array_equal(ops.tf32_rna(a), tf32_model(a))
    assert ops.tf32_rna(ties)[0] == np.float32(1 + 2 ** -10)   # away
    assert not (ops.tf32_rna(v).view(np.uint32) & 0x1FFF).any()


@pytest.mark.parametrize("n1", [49, 64, 96])
def test_3xtf32_keeps_fp32_accuracy_and_tf32_does_not(n1):
    """One contraction, GLL D-hat times a random float32 panel of 512
    lines, against float64: the three products of the split (lo.hi, hi.lo,
    hi.hi, summed in float32 as the tensor cores do, k-step by k-step) stay
    within 2e-6 relative (fp32 accuracy); one TF32 product is off by more
    than 1e-4, which six chained contractions would carry past the
    kernels' fp32 bound -- why the body takes three."""
    d = np.asarray(tbasis(n1 - 1).dhat, dtype=np.float32)
    panel = np.random.default_rng(n1).standard_normal(
        (n1, 512)).astype(np.float32)
    exact = d.astype(np.float64) @ panel.astype(np.float64)
    dh, dl = split3(d)
    ph, pl = split3(panel)
    three = np.zeros_like(exact, dtype=np.float32)
    one = np.zeros_like(three)
    for m0 in range(0, n1, 8):
        k = slice(m0, m0 + 8)
        three += (dl[:, k] @ ph[k]).astype(np.float32)
        three += (dh[:, k] @ pl[k]).astype(np.float32)
        three += (dh[:, k] @ ph[k]).astype(np.float32)
        one += (dh[:, k] @ ph[k]).astype(np.float32)

    def rel(a):
        return np.linalg.norm(a - exact) / np.linalg.norm(exact)
    assert rel(three) <= 2e-6
    assert rel(one) >= 1e-4


@pytest.mark.parametrize("n1", [7, 49, 64])
def test_staged_fragments_lay_out_the_split_for_the_mma(n1):
    """ops.staged_fragments: D-hat, then its transpose, zero-padded to 16
    rows and 8 columns, each (m16, k8) tile's hi then lo as 32 lanes x 4,
    lane 4g + t holding (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); hi
    and lo the model's split, hi + lo within 2^-21 of D-hat."""
    d = np.random.default_rng(n1).standard_normal((n1, n1)).astype(
        np.float32)
    frag = ops.staged_fragments(d)
    mp, kp = -(-n1 // 16) * 16, -(-n1 // 8) * 8
    assert frag.dtype == np.float32
    assert frag.size * 4 == ops.staged_launch(n1, 1, 1).fragment_bytes \
        == 4 * 2 * (mp // 16) * (kp // 8) * 256
    tiles = frag.reshape(2, mp // 16, kp // 8, 2, 8, 4, 4)  # lane = (g, t)
    for which, a_mat in enumerate((d, d.T)):
        whole = np.zeros((2, mp, kp), np.float32)
        for r, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
            for mt in range(mp // 16):
                for ks in range(kp // 8):
                    whole[:, 16 * mt + dr:16 * mt + dr + 8,
                          8 * ks + dc:8 * ks + dc + 4] = \
                        tiles[which, mt, ks, :, :, :, r]
        hi, lo = split3(a_mat)
        assert np.array_equal(whole[0, :n1, :n1], hi)
        assert np.array_equal(whole[1, :n1, :n1], lo)
        assert not whole[:, n1:].any() and not whole[:, :, n1:].any()
        assert np.abs(hi.astype(np.float64) + lo - a_mat).max() \
            <= 2.0 ** -21 * np.abs(a_mat).max()


@pytest.mark.parametrize("n1", [2, 25, 49, 50, 64, 65, 96, 128,
                                ops.N1_STAGED_WIDE_MAX,
                                ops.N1_STAGED_WIDE_MAX + 1, 878])
def test_staged_launch_covers_every_output_once(n1):
    """Every launch: one item per batch row and tile of lines (32, 16 above
    N1_STAGED_WIDE_MAX), the tiles covering the N1^2 lines once (the last
    ragged); ceil(N1 / 64) passes of 64 output rows over ceil(N1 / 8)
    k-steps; a block's two panel slots, epilogue tile and geometry words
    in shared memory; the scratch three fp32 components, and for Helmholtz
    the mass of each node; six launches."""
    e, ncols = 3, 4
    launch = ops.staged_launch(n1, e, ncols)
    rows, wide, depth = launch.tile
    assert launch.tile == ops.STAGED_TILE == (64, 32, 8)
    assert launch.threads == ops.STAGED_THREADS == 128 == 32 * rows // 16
    lines = wide if n1 <= ops.N1_STAGED_WIDE_MAX else ops.STAGED_NARROW_LINES
    assert launch.lines == lines == ops.staged_lines(n1)
    assert launch.threads % lines == 0 and lines % 8 == 0
    tiles = -(-n1 * n1 // lines)
    assert launch.items == e * ncols * tiles
    covered = [q for t in range(tiles)
               for q in range(t * lines, min((t + 1) * lines, n1 * n1))]
    assert covered == list(range(n1 * n1))
    assert launch.passes == -(-n1 // rows)
    assert (launch.passes - 1) * rows < n1 <= launch.passes * rows
    assert launch.k_steps * depth >= n1 > (launch.k_steps - 1) * depth
    kp = launch.k_steps * depth
    slot = max(kp * (lines + 8), lines * (kp + 4))
    tile = max(rows * (lines + 8), lines * (rows + 4))
    assert launch.smem_bytes == ops.staged_smem_bytes(n1) == \
        4 * (ops.STAGED_STAGES * slot + tile + 32)
    assert launch.smem_bytes <= ops.SMEM_PER_BLOCK
    assert launch.scratch_bytes == 3 * 4 * e * ncols * n1 ** 3
    assert ops.staged_launch(n1, e, ncols, helmholtz=True).scratch_bytes \
        == launch.scratch_bytes + 4 * e * n1 ** 3
    assert launch.kernels == ops.STAGED_KERNELS == 6
    if n1 > 128:
        return
    for d in "rst":                   # every node of a batch row, once
        off, stride = line_offsets(d, n1)
        nodes = (off[:, None] + np.arange(n1)[None, :] * stride).reshape(-1)
        assert np.array_equal(np.sort(nodes), np.arange(n1 ** 3))


def test_n1_staged_max_is_the_largest_panel_a_block_holds():
    """The staged body keeps the range of the body it replaced, N1 up to
    878, in ops and in the source (kStagedMax), where a block holds two
    whole panels of 16 lines (175,232 bytes) and its epilogue's operands
    (193,664 with all three; shared memory would allow up to N1 = 1080).  Items are 32 lines wide while two blocks fit an SM
    (N1_STAGED_WIDE_MAX = 328: 115,328 bytes and the 1 KB the runtime keeps
    a block), 16 above it; the order-63 main path needs 30,848 bytes a
    block, 51,328 in the t gradient."""
    assert ops.N1_STAGED_MAX == 878
    assert ops.staged_smem_bytes(878) == 175232
    most = ops.STAGED_MAX_EXTRAS
    assert ops.staged_smem_bytes(878, extras=most) == 193664 \
        <= ops.SMEM_PER_BLOCK
    assert ops.staged_smem_bytes(1080, 16, most) <= ops.SMEM_PER_BLOCK \
        < ops.staged_smem_bytes(1081, 16, most)
    assert ops.staged_smem_bytes(64, extras=2) == 51328
    assert ops.staged_smem_bytes(328, extras=most) <= ops.SMEM_PER_BLOCK
    assert ops.N1_STAGED_WIDE_MAX == 328
    two = [2 * (ops.staged_smem_bytes(n, 32) + ops.SMEM_RESERVED)
           for n in (328, 329)]
    assert two[0] <= ops.SMEM_PER_SM < two[1]
    assert ops.staged_smem_bytes(328) == 115328
    assert 2 * (ops.staged_smem_bytes(329) + ops.SMEM_RESERVED) \
        <= ops.SMEM_PER_SM
    assert ops.staged_smem_bytes(64) == 30848
    assert ops.N1_PLANE_MAX < ops.N1_STAGED_MAX
    source = (chip_smoke.ROOT / chip_smoke.SOURCE["staged"]).read_text()
    assert f"kWideMax = {ops.N1_STAGED_WIDE_MAX};" in source
    assert f"kStagedMax = {ops.N1_STAGED_MAX};" in source
    assert "n1 > kStagedMax" in source
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
    ncols E N1^3 floats, the staged body (3 ncols + helmholtz) E N1^3),
    the staged body D-hat's split in the dhat slot; either way one launch
    of the entry point is counted, and its body records how many CUDA
    kernels an application launches (three for the plane body, six for
    the staged body)."""
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
    if body == "staged":
        frag = ops._staged_fragments(b.n, dtype, torch.device("meta"))
        assert args[5] == frag.data_ptr()
        assert frag.numel() * 4 == ops.staged_launch(n1, e,
                                                     ncols).fragment_bytes
    assert ops.launch_counts[entry] == before[entry] + 1
    assert sum(ops.launch_counts.values()) == sum(before.values()) + 1
    assert ops.KERNELS_PER_APPLICATION[body] == (6 if body == "staged"
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
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__4a0d319b_16_axhelm_staged_cu_06f277b427axhelm_staged_grad_t_kernelILN13axhelm_detail10GeomSourceE3EfEEvNS_10StagedArgsIT0_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__4a0d319b_16_axhelm_staged_cu_06f277b427axhelm_staged_grad_t_kernelILN13axhelm_detail10GeomSourceE3EfEEvNS_10StagedArgsIT0_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 128 bytes smem
"""


def test_ptxas_report_names_the_staged_body():
    """The staged body's kernels as phase 2 parses them: two contractions
    every variant shares (variant None) and a variant's t gradient with
    its factors (names as nvcc 12.9 mangles them for sm_90a)."""
    shared, last, grad_t = build.ptxas_instantiations(_STAGED_REPORT)
    spills = {"spill_stores": 0, "spill_loads": 0}
    assert shared == {"variant": None, "body": "staged", "pass": "first_r",
                      "n1": None, "dtype": "bf16", **spills,
                      "registers": 48, "smem_bytes": 0}
    assert last == {"variant": None, "body": "staged",
                    "pass": "last_t", "n1": None, "dtype": "f32", **spills,
                    "registers": 64, "smem_bytes": 0}
    assert grad_t == {"variant": "merged", "body": "staged",
                      "pass": "grad_t", "n1": None, "dtype": "f32",
                      **spills, "registers": 40, "smem_bytes": 128}
    assert {"grad_r", "grad_s", "first_r", "accumulate_s",
            "last_t"} == set(build.STAGED_SHARED_PASSES)
    assert build.STAGED_VARIANT_PASSES == ("grad_t",)
    assert len(build.STAGED_SHARED_PASSES) \
        + len(build.STAGED_VARIANT_PASSES) == ops.STAGED_KERNELS


def test_chip_smoke_checks_the_staged_body_where_it_runs():
    """The orders chip_smoke.py checks the staged body at run it, its main
    path's among them, and two of them sit on each side of its switch of
    lines an item; its source holds the kernels, and no pointwise one."""
    n1s = [o + 1 for o in chip_smoke.STAGED_ORDERS
           + chip_smoke.STAGED_SWITCH_ORDERS]
    assert all(ops.N1_PLANE_MAX < n1 <= ops.N1_STAGED_MAX for n1 in n1s)
    assert chip_smoke.STAGED_ORDER + 1 in n1s
    assert [ops.staged_lines(o + 1)
            for o in chip_smoke.STAGED_SWITCH_ORDERS] == [
        ops.STAGED_TILE[1], ops.STAGED_NARROW_LINES]
    assert chip_smoke.STAGED_SMALL_ORDER + 1 > ops.N1_PLANE_MAX
    assert all(o + 1 <= ops.N1_PLANE_MAX
               for o in chip_smoke.STAGED_TWIN_ORDERS)
    source = (chip_smoke.ROOT / chip_smoke.SOURCE["staged"]).read_text()
    assert "axhelm_staged_contract_kernel" in source
    assert "axhelm_staged_grad_t_kernel" in source
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in source
    assert "cp.async" in source
    assert "axhelm_staged_factors_kernel" not in source


@pytest.mark.parametrize("word", [4, 2])
def test_staged_tensor_bound_counts_the_products_at_the_3xtf32_rate(word):
    """chip_smoke.staged_tensor_bound: axhelm_bound's bytes and operations,
    the 12 N1^4 products on the tensor cores and the rest at fp32; at fp32
    storage every product at a third of the TF32 rate, at bf16 half of
    them (the gradients) at the TF32 rate and half at a half of it (the
    transposed contractions); below axhelm_bound at the main path's N1 =
    64, E = 8."""
    _, _, nbytes, flops = chip_smoke.axhelm_bound("trilinear", 8, 64,
                                                  word=word)
    ms, by = chip_smoke.staged_tensor_bound("trilinear", 8, 64, word=word)
    products = 12 * 64 ** 4 * 8
    rate = chip_smoke.PEAK_TF32_FLOP_PER_S
    t_products = (products / (rate / 3) if word == 4 else
                  products / 2 / rate + products / 2 / (rate / 2))
    want = max(nbytes / chip_smoke.PEAK_BYTES_PER_S,
               t_products + (flops - products)
               / chip_smoke.PEAK_FP32_FLOP_PER_S) * 1e3
    assert ms == pytest.approx(want, rel=1e-12)
    assert by == "operations"
    assert ms < chip_smoke.axhelm_bound("trilinear", 8, 64, word=word)[0]
    assert chip_smoke.staged_tf32_products(word) == (
        (3, 3) if word == 4 else (1, 2))


@pytest.mark.parametrize("n1", [49, 64, 96])
def test_bf16_entry_points_skip_only_products_of_zero(n1):
    """At bf16 storage D-hat is rounded to bf16 (ops._constants) and x is
    bf16: both are exact in TF32, so the lo halves of the split are zero
    and the products the bf16 entry points skip (lo.hi everywhere, the
    source's kExactA; hi.lo in the gradients, kExactB) add nothing.  At
    fp32 storage D-hat's lo half is not zero, and the source issues the
    product there."""
    frag = ops._staged_fragments(n1 - 1, torch.bfloat16,
                                 torch.device("cpu")).numpy()
    m_tiles, k_steps = -(-n1 // 16), -(-n1 // 8)
    halves = frag.reshape(2, m_tiles, k_steps, 2, 128)   # hi, lo a tile
    assert not halves[:, :, :, 1].any()
    assert halves[:, :, :, 0].any()
    f32 = ops._staged_fragments(n1 - 1, torch.float32,
                                torch.device("cpu")).numpy()
    assert f32.reshape(2, m_tiles, k_steps, 2, 128)[:, :, :, 1].any()
    x = torch.from_numpy(np.random.default_rng(n1).standard_normal(
        4096).astype(np.float32)).to(torch.bfloat16).float().numpy()
    hi, lo = split3(x)
    assert np.array_equal(hi, x) and not lo.any()
    source = (chip_smoke.ROOT / chip_smoke.SOURCE["staged"]).read_text()
    assert "constexpr bool kExactA = sizeof(T) == 2;" in source
    assert "if constexpr (!kExactA) mma_tf32(acc[i][j], al[i], h0, h1);" \
        in source
    assert "if constexpr (!kExactB) mma_tf32(acc[i][j], ah[i], l0, l1);" \
        in source


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
