"""The column body of the K2 (trilinear) and K5 (partial) axhelm kernels,
`csrc/axhelm_column.cu`, on the CPU: what of it is not CUDA.

* Its hoisted Alg. 3, written here in the kernel's order (edge differences
  once per element, the terms that do not vary along k once per node
  column, the affine update, K, adj(K), det and the K2 scale per node),
  against the reference package's `jacobian_trilinear_at`, `adjugate6`,
  `factors_from_jacobian` and `setup_partial_gscale`: float64, <= 1e-12
  relative (the same formulas in another order), on a trilinear and an
  affine mesh.
* The wrapper's launch arithmetic (elements per block, grid), the packing
  of D-hat and xi into the kernel's by-value parameter (float32, and the
  bf16-rounded values for bf16 storage), and the arguments `ops` passes to
  each C entry point, against the signatures `build` declares.
* `build.ptxas_instantiations`, which reads the build's -Xptxas -v
  report into the body, registers and spills of every instantiation.

The kernels themselves run on the card only: tests/test_torch_cuda.py.
"""

import contextlib
import re
import sys
import types
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
from repro_torch.core.spectral import basis as tbasis
from repro_torch.kernels.axhelm import build, ops

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _torch_x64 import x64  # noqa: F401

RTOL64 = 1e-12


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _verts(n, mesh):
    box = jmesh.box_mesh(2, 2, 3, n)
    deformed = jmesh.deform_affine(box, seed=2) if mesh == "affine" else \
        jmesh.deform_trilinear(box, seed=3)
    return np.asarray(deformed.verts, np.float64)          # (E, 8, 3)


def edge_vertices(q):
    """The kernel's edge_vertices: edge q of 12 (q // 4 the r, s or t
    direction), the vertices at its ends (vertex = br + 2 bs + 4 bt)."""
    d, p = q >> 2, q & 3
    lo = ((p >> d) << (d + 1)) | (p & ((1 << d) - 1))
    return lo, lo | (1 << d)


def column_geometry(verts, xi, w3):
    """Alg. 3 in the kernel's order, for every element, node column and
    node: returns J~ (E, k, j, i, 3, 3), adj(K~) (E, k, j, i, 6), det(J~)
    and K2's G and gwj (scale 1/8 folded in as the kernel folds it)."""
    n1 = len(xi)
    # once per element: the 12 edge differences, E[3q + a]
    edges = np.stack([verts[:, hi] - verts[:, lo]
                      for lo, hi in map(edge_vertices, range(12))], axis=1)
    shape = (len(verts), n1, n1, n1)
    jt = np.empty(shape + (3, 3))
    adj = np.empty(shape + (6,))
    det = np.empty(shape)
    for j in range(n1):
        for i in range(n1):
            # once per node column: e0/e1, f0/f1, c2, k22
            lo_i, hi_i = 1 - xi[i], 1 + xi[i]
            lo_j, hi_j = 1 - xi[j], 1 + xi[j]
            ra = lo_j * edges[:, 0] + hi_j * edges[:, 1]
            rb = lo_j * edges[:, 2] + hi_j * edges[:, 3]
            e0, e1 = ra + rb, rb - ra
            sa = lo_i * edges[:, 4] + hi_i * edges[:, 5]
            sb = lo_i * edges[:, 6] + hi_i * edges[:, 7]
            f0, f1 = sa + sb, sb - sa
            c2 = lo_j * (lo_i * edges[:, 8] + hi_i * edges[:, 9]) + \
                hi_j * (lo_i * edges[:, 10] + hi_i * edges[:, 11])
            k22 = np.sum(c2 * c2, axis=-1)
            for k in range(n1):
                # per node: the affine update, K, adj(K), det
                c0, c1 = e0 + xi[k] * e1, f0 + xi[k] * f1
                k00, k01 = np.sum(c0 * c0, -1), np.sum(c0 * c1, -1)
                k02, k11 = np.sum(c0 * c2, -1), np.sum(c1 * c1, -1)
                k12 = np.sum(c1 * c2, -1)
                adj[:, k, j, i] = np.stack([
                    k11 * k22 - k12 * k12, k02 * k12 - k01 * k22,
                    k01 * k12 - k02 * k11, k00 * k22 - k02 * k02,
                    k01 * k02 - k00 * k12, k00 * k11 - k01 * k01], -1)
                det[:, k, j, i] = np.sum(c0 * np.cross(c1, c2), -1)
                jt[:, k, j, i] = np.stack([c0, c1, c2], axis=-1)
    g = adj * (0.125 * w3 / det)[..., None]
    gwj = w3 * det / 512
    return jt, adj, det, g, gwj


@pytest.fixture
def geometry(x64, request):
    n, mesh = request.param
    b = jbasis(n)
    verts = _verts(n, mesh)
    ours = column_geometry(verts, b.points, b.w3)
    jt = jgeom.jacobian_trilinear_at(jnp.asarray(verts),
                                     jnp.asarray(b.points))
    return b, verts, ours, jt


GEOMETRY_CASES = [(n, mesh) for n in (3, 7)
                  for mesh in ("trilinear", "affine")]


@pytest.mark.parametrize("geometry", GEOMETRY_CASES, indirect=True,
                         ids=[f"N{n}-{m}" for n, m in GEOMETRY_CASES])
def test_hoisted_jacobian_matches_reference(geometry):
    _, _, (jt, _, _, _, _), jt_ref = geometry
    assert _rel(jt, jt_ref) <= RTOL64


@pytest.mark.parametrize("geometry", GEOMETRY_CASES, indirect=True,
                         ids=[f"N{n}-{m}" for n, m in GEOMETRY_CASES])
def test_hoisted_adjugate_matches_reference(geometry):
    """K5's G before its gScale, and K4's."""
    _, _, (_, adj, _, _, _), jt_ref = geometry
    assert _rel(adj, jgeom.adjugate6(jt_ref)) <= RTOL64


@pytest.mark.parametrize("geometry", GEOMETRY_CASES, indirect=True,
                         ids=[f"N{n}-{m}" for n, m in GEOMETRY_CASES])
def test_hoisted_trilinear_factors_match_reference(geometry):
    """K2: G = (1/8) w3 adj(K~) / det(J~) and gwj = w3 det(J~) / 512."""
    b, _, (_, _, _, g, gwj), jt_ref = geometry
    ref = jgeom.factors_from_jacobian(jt_ref, jnp.asarray(b.w3),
                                      scale=jgeom.JT_SCALE)
    assert _rel(g, ref.g) <= RTOL64
    assert _rel(gwj, ref.gwj) <= RTOL64


@pytest.mark.parametrize("geometry", GEOMETRY_CASES, indirect=True,
                         ids=[f"N{n}-{m}" for n, m in GEOMETRY_CASES])
def test_hoisted_det_gives_the_partial_gscale(geometry):
    """K5 reads gScale = w3 / (8 det(J~)): the hoisted det reproduces the
    reference's setup of it."""
    b, verts, (_, _, det, _, _), _ = geometry
    gscale = jax_axhelm.setup_partial_gscale(jnp.asarray(verts), b)
    assert _rel(0.125 * b.w3 / det, gscale) <= RTOL64


def column_body(x, dhat, xi, w3, variant, verts, lam0, lam1, helmholtz):
    """The kernel's two passes in float64, in its order and layout: x (E, C,
    N1^3) -> y.  The elements of a block (`ops.column_elems`) lie side by
    side in s_x, s_r, s_s and s_t, N1^3 + pad words apart (the absent ones
    of the ragged last block compute on the last element and store
    nothing); per column, thread (i, j) walks k: x_r along row j of the
    slab (the D-hat row of i), x_s along column i (the row of j), x_t from
    its own N1 values (the D-hat row of k), the factors of Alg. 3 in the
    kernel's order (`column_geometry`), then the transpose pass, adding K2's
    Helmholtz mass on the way.  Vectorised over the threads of an element.
    lam0 is gScale for partial."""
    e_count, ncols = x.shape[:2]
    n1 = len(xi)
    nc, np_ = n1 * n1, n1 ** 3
    epb, es = ops.column_elems(n1), np_ + ops.COLUMN_PADS[n1]
    _, adj, det, _, _ = column_geometry(verts, xi, w3.reshape((n1,) * 3))
    col = np.arange(nc)
    i, j = col % n1, col // n1
    y = np.full_like(x, np.nan)
    for b0 in range(0, e_count, epb):
        elems = [min(b0 + le, e_count - 1) for le in range(epb)]
        for c in range(ncols):
            s_x, s_r, s_s, s_t = (np.zeros(epb * es) for _ in range(4))
            for le, e in enumerate(elems):                # x into s_x
                s_x[le * es:le * es + np_] = x[e, c]
            for le, e in enumerate(elems):                # forward pass
                base, xk = le * es, x[e, c].reshape(n1, nc)
                for k in range(n1):
                    slab = s_x[base + k * nc:base + (k + 1) * nc]
                    xr = np.sum(dhat[i] * slab[j[:, None] * n1
                                               + np.arange(n1)], axis=1)
                    xs = np.sum(dhat[j] * slab[np.arange(n1) * n1
                                               + i[:, None]], axis=1)
                    xt = dhat[k] @ xk
                    node = k * nc + col
                    g = adj[e, k].reshape(nc, 6)
                    if variant == "trilinear":
                        scale = 0.125 * w3[node] / det[e, k].reshape(nc)
                        if lam0 is not None:
                            scale = scale * lam0[e, node]
                    else:                                 # partial: gScale
                        scale = lam0[e, node]
                    xr, xs, xt = xr * scale, xs * scale, xt * scale
                    s_r[base + node] = g[:, 0] * xr + g[:, 1] * xs + \
                        g[:, 2] * xt
                    s_s[base + node] = g[:, 1] * xr + g[:, 3] * xs + \
                        g[:, 4] * xt
                    s_t[base + node] = g[:, 2] * xr + g[:, 4] * xs + \
                        g[:, 5] * xt
            for le, e in enumerate(elems):                # transpose pass
                if b0 + le >= e_count:
                    continue
                base = le * es
                gt = s_t[base:base + np_].reshape(n1, nc)
                for k in range(n1):
                    node = k * nc + col
                    yv = np.zeros(nc)
                    if variant == "trilinear" and helmholtz:
                        mass = w3[node] * det[e, k].reshape(nc) / 512
                        if lam1 is not None:
                            mass = mass * lam1[e, node]
                        yv = mass * s_x[base + node]
                    slab_r = s_r[base + k * nc:base + (k + 1) * nc]
                    slab_s = s_s[base + k * nc:base + (k + 1) * nc]
                    yv = yv + np.sum(dhat[:, i].T * slab_r[
                        j[:, None] * n1 + np.arange(n1)], axis=1)
                    yv = yv + np.sum(dhat[:, j].T * slab_s[
                        np.arange(n1) * n1 + i[:, None]], axis=1)
                    yv = yv + dhat[:, k] @ gt
                    y[e, c, node] = yv
    return y


COLUMN_WALK_CASES = [("trilinear", False), ("trilinear", True),
                     ("partial", False)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 9, 12, 15])
@pytest.mark.parametrize("variant,helm", COLUMN_WALK_CASES)
def test_column_passes_match_reference(x64, variant, helm, n):
    """K2 Poisson and Helmholtz with per-node lam0 (and lam1) fields, K5
    on the reference's gScale, at N1 = 2, 3, 4, 5, 6, 8, 10, 13 and 16,
    two columns an element, against the reference package's jnp oracle:
    float64, <= 1e-12 relative; blocks of several elements with a ragged
    last one where the N1 has them."""
    rng = np.random.default_rng(100 + 10 * n + helm)
    b = jbasis(n)
    n1 = b.n1
    box = jmesh.box_mesh(3, 2, 2, n) if n1 <= 6 else \
        jmesh.box_mesh(2, 1, 1, n)
    verts = np.asarray(jmesh.deform_trilinear(box, seed=3).verts,
                       np.float64)
    e = len(verts)
    x = rng.standard_normal((e, 2, n1 ** 3))
    lam0 = 1 + 0.3 * rng.random((e, n1 ** 3))
    lam1 = 0.5 + 0.2 * rng.random((e, n1 ** 3)) if helm else None
    if variant == "partial":
        lam0 = np.asarray(jax_axhelm.setup_partial_gscale(
            jnp.asarray(verts), b)).reshape(e, -1)
    ours = column_body(x, np.asarray(b.dhat), np.asarray(b.points),
                       np.asarray(b.w3).reshape(-1), variant, verts, lam0,
                       lam1, helm)
    shape = (e, 2) + (n1,) * 3
    kw = {"lam0": jnp.asarray(lam0.reshape((e,) + (n1,) * 3))}
    if lam1 is not None:
        kw["lam1"] = jnp.asarray(lam1.reshape((e,) + (n1,) * 3))
    ref = jops.reference(jnp.asarray(x.reshape(shape)), b, variant,
                         jnp.asarray(verts), helmholtz=helm, **kw)
    assert _rel(ours.reshape(shape), ref) <= RTOL64


def test_edges_are_the_pairs_of_algorithm_3():
    """edge_vertices walks the r, s, t edges in the order the kernel's
    column terms weight them (jacobian_trilinear_at's vertex pairs)."""
    assert [edge_vertices(q) for q in range(12)] == [
        (0, 1), (2, 3), (4, 5), (6, 7),      # r: (s, t) = --, +-, -+, ++
        (0, 2), (1, 3), (4, 6), (5, 7),      # s: r, t
        (0, 4), (1, 5), (2, 6), (3, 7)]      # t: r, s


@pytest.mark.parametrize("n1", ops.KERNEL_N1)
@pytest.mark.parametrize("n_elem", [1, 2, 3, 8, 37, 4096, 4099])
def test_column_launch_covers_every_element(n1, n_elem):
    """Every N1 from 2 to 16: the elements a block fill whole warps but for
    a few lanes of the last (all of them at N1 = 4 and 8, COLUMN_THREADS),
    the blocks an SM give at most 16 warps and about 128 registers a
    thread, a block's shared memory fits (and so do the SM's blocks), and
    the grid covers every element once, the last block ragged."""
    per_block, grid = ops.column_launch(n1, n_elem)
    threads = per_block * n1 * n1
    warps = -(-threads // 32)
    assert per_block == ops.column_elems(n1) >= 1
    assert threads == ops.column_threads(n1) <= 256
    if n1 in (4, 8):
        assert threads == ops.COLUMN_THREADS and ops.COLUMN_THREADS % 32 == 0
    assert threads >= 0.875 * 32 * warps
    blocks = ops.column_min_blocks(n1)
    assert blocks * warps <= 16 and 65536 // (blocks * warps * 32) >= 128
    smem = ops.column_smem_bytes(n1)
    assert smem <= ops.SMEM_PER_BLOCK and blocks * smem <= 233472
    assert (grid - 1) * per_block < n_elem <= grid * per_block
    covered = [b * per_block + le for b in range(grid)
               for le in range(per_block) if b * per_block + le < n_elem]
    assert covered == list(range(n_elem))


def _source_table(text, name):
    """The values of `constexpr int <name>[17] = {...};` in a CUDA source."""
    body = re.search(rf"constexpr int {name}\[17\] = \{{([^}}]*)\}};",
                     text).group(1)
    return [int(v) for v in body.split(",")]


def test_column_constants_follow_the_source():
    """The wrapper's launch shapes mirror the column body's: threads and
    blocks an SM at N1 = 4 and 8, the elements a block and the element pads
    at every other N1, the smallest N1 whose D-hat rows leave registers."""
    text = (chip_smoke.ROOT / chip_smoke.SOURCE["column"]).read_text()

    def const(name):
        return int(re.search(rf"{name} = (\d+);", text).group(1))
    assert const("kColumnThreads") == ops.COLUMN_THREADS
    assert const("kColumnMinBlocks") == ops.COLUMN_MIN_BLOCKS
    assert const("kColumnDRegsMax") == 8
    elems = _source_table(text, "elems")
    assert {n1: elems[n1] for n1 in ops.COLUMN_ELEMS} == ops.COLUMN_ELEMS
    assert elems[4] == elems[8] == 0            # kColumnThreads / N1^2 there
    pads = _source_table(text, "pads")
    assert {n1: pads[n1] for n1 in ops.KERNEL_N1} == ops.COLUMN_PADS
    assert set(ops.COLUMN_ELEMS) | {4, 8} == set(ops.KERNEL_N1)


def _wavefront_ways(addresses, width):
    """The ways of the worst phase of one warp instruction: `addresses` the
    lanes' byte addresses, `width` bytes a lane.  A 16-byte access runs in
    phases of 8 lanes, an 8-byte one of 16, narrower ones in one; a phase
    takes as many wavefronts as the most distinct 4-byte words in one of
    the 32 banks (test_torch_axhelm_line.py's `_wavefronts`, per phase)."""
    lanes = {16: 8, 8: 16}.get(width, 32)
    worst = 0
    for p in range(0, len(addresses), lanes):
        banks = {}
        for a in addresses[p:p + lanes]:
            for w in range(a // 4, (a + max(width, 4) - 1) // 4 + 1):
                banks.setdefault(w % 32, set()).add(w)
        worst = max(worst, max(len(words) for words in banks.values()))
    return worst


def column_bank_ways(n1):
    """The ways of the column body's shared accesses over every warp of a
    block, element e of the block at e (N1^3 + pad) words: "store" the
    stores and the owner's loads at fixed k, "row" the r rows (float4,
    float2 or one word, as row_fma reads them), "col" the s columns at
    fixed m."""
    nc = n1 * n1
    es = nc * n1 + ops.COLUMN_PADS[n1]
    width = next(v for v in (16, 8, 4) if (4 * n1) % v == 0)
    threads = ops.column_threads(n1)
    ways = {"store": 0, "row": 0, "col": 0}
    for w0 in range(0, threads, 32):
        lanes = [(th // nc, th % nc % n1, th % nc // n1, th % nc)
                 for th in range(w0, min(w0 + 32, threads))]
        for k in range(n1):
            ways["store"] = max(ways["store"], _wavefront_ways(
                [4 * (le * es + k * nc + c) for le, i, j, c in lanes], 4))
            for q in range(4 * n1 // width):
                ways["row"] = max(ways["row"], _wavefront_ways(
                    [4 * (le * es + k * nc + j * n1) + width * q
                     for le, i, j, c in lanes], width))
            for m in range(n1):
                ways["col"] = max(ways["col"], _wavefront_ways(
                    [4 * (le * es + k * nc + m * n1 + i)
                     for le, i, j, c in lanes], 4))
    return ways


def _comment_table(text, first, rows):
    """{row name: {N1: value}} of a table in a source comment: the line
    starting with `first` names the N1, the next lines hold `rows`."""
    lines = text.splitlines()
    at = next(k for k, line in enumerate(lines)
              if line.lstrip("/ ").startswith(first))
    n1s = [int(v) for v in lines[at].split(":")[1].split()]
    out = {}
    for line in lines[at + 1:at + 1 + len(rows)]:
        name, values = line.lstrip("/ ").split(":")
        out[name.strip()] = dict(zip(n1s, map(int, values.split())))
    assert list(out) == list(rows)
    return out


@pytest.mark.parametrize("n1", ops.KERNEL_N1)
def test_column_bank_conflicts_are_what_the_source_states(n1):
    """The model's ways of each access are the source note's table, and
    its pads the wrapper's; every access but the stores at N1 = 4, 6, 10
    and the s columns at N1 = 4 (2 ways) is conflict free."""
    text = (chip_smoke.ROOT / chip_smoke.SOURCE["column"]).read_text()
    table = _comment_table(text, "N1:", ("pad", "store", "row", "col"))
    assert table["pad"][n1] == ops.COLUMN_PADS[n1]
    ways = column_bank_ways(n1)
    assert ways == {k: table[k][n1] for k in ("store", "row", "col")}
    assert max(ways.values()) == (2 if n1 in (4, 6, 10) else 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [3, 7])
def test_column_consts_pack_dhat_then_xi(n, dtype):
    """The by-value parameter: D-hat row-major, then xi, float32 on the
    host, in the values the plain version computes with."""
    b = tbasis(n)
    n1 = b.n1
    consts = ops._column_consts(n, dtype)
    assert consts.device.type == "cpu" and consts.dtype == torch.float32
    assert consts.is_contiguous() and consts.shape == (n1 * n1 + n1,)
    rounded = [torch.as_tensor(a, dtype=dtype).float()
               for a in (b.dhat, b.points)]
    assert torch.equal(consts[:n1 * n1].reshape(n1, n1), rounded[0])
    assert torch.equal(consts[n1 * n1:], rounded[1])
    dhat, xi, _ = ops._constants(n, dtype, torch.device("cpu"))
    assert torch.equal(consts, torch.cat([dhat.reshape(-1), xi]).float())
    # cached: the host pointer handed to the kernel stays valid
    assert ops._column_consts(n, dtype).data_ptr() == consts.data_ptr()


def test_bf16_column_consts_are_bf16_values():
    consts = ops._column_consts(7, torch.bfloat16)
    assert torch.equal(consts, consts.bfloat16().float())
    assert not torch.equal(consts, ops._column_consts(7, torch.float32))


class _FakeLibrary:
    """Records the arguments of every entry point called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    """The kernel path of `ops` on meta tensors, with a library that
    records its calls in place of the built one."""
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(ops, "_check_kernel_operands", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(ops, "_sm_count", lambda d: 132)
    monkeypatch.setattr(ops, "_line_blocks",
                        lambda variant, dtype, n1, d:
                        ops.line_min_blocks(n1, variant))
    return lib


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_wrapper_passes_each_entry_point_its_signature(fake_card, variant,
                                                       dtype):
    b = tbasis(7)
    e, helm = 5, variant == "merged"
    geom = _meta({"precomputed": (e, 8, 8, 8, 7),
                  "parallelepiped": (e, 7)}.get(variant, (e, 8, 3)), dtype)
    lams = {"merged": ("lam0", "lam1"), "partial": ("lam0",)}.get(variant, ())
    kw = {name: _meta((e, 8, 8, 8), dtype) for name in lams}
    before = dict(ops.launch_counts)
    ops.axhelm(_meta((e, 2, 3, 8, 8, 8), dtype), b, variant, geom,
               helmholtz=helm, **kw)
    (name, args), = fake_card.calls
    suffix = ops.KERNEL_DTYPES[dtype]
    assert name == build.symbol(variant, suffix) == ops.entry_point(variant,
                                                                   dtype)
    assert len(args) == len(build.SIGNATURES[variant])
    assert args[-1] == 7                                   # the stream
    assert ops.launch_counts[name] == before[name] + 1
    if variant in ops.COLUMN_VARIANTS:
        per_block, grid = ops.column_launch(8, e)
        assert args[-3:-1] == (per_block, grid)
        # n1, n_elem, ncols; trilinear passes helmholtz before the grid
        sizes = args[-7:-4] if variant == "trilinear" else args[-6:-3]
        assert sizes == (8, e, 6)
        consts = ops._column_consts(7, dtype).data_ptr()
        assert consts in args


@pytest.mark.parametrize("variant", ops.ROWWISE_VARIANTS)
def test_rowwise_launches_the_timing_twin_and_counts_nothing(fake_card,
                                                             variant):
    b = tbasis(7)
    kw = {"partial": {"lam0": _meta((3, 8, 8, 8))},
          "merged": {"lam0": _meta((3, 8, 8, 8)),
                     "lam1": _meta((3, 8, 8, 8))}}.get(variant, {})
    geom = _meta((3, 7) if variant == "parallelepiped" else (3, 8, 3))
    before = dict(ops.launch_counts)
    ops.rowwise(_meta((3, 8, 8, 8)), b, variant, geom, **kw)
    (name, args), = fake_card.calls
    assert name == build.symbol(f"{variant}_rowwise", "f32")
    assert len(args) == len(build.SIGNATURES[f"{variant}_rowwise"])
    assert ops.launch_counts == before


@pytest.mark.parametrize("variant", ["bogus"])
def test_rowwise_refuses_the_other_variants(variant):
    with pytest.raises(ValueError, match="rowwise runs"):
        ops.rowwise(_meta((3, 8, 8, 8)), tbasis(7), variant, _meta((3, 7)))


def test_rowwise_refuses_cpu_tensors():
    """The timing twin has no plain version: a CPU tensor is refused like
    any tensor off the card."""
    x = torch.zeros((3, 8, 8, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        ops.rowwise(x, tbasis(7), "trilinear", torch.zeros((3, 8, 3)))


_REPORT = """\
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__e86fd865_9_axhelm_cu_b6a320c213axhelm_kernelILi8ELN13axhelm_detail10GeomSourceE1EfEEvPKT1_PS3_S5_S5_S5_PKfS8_S8_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__e86fd865_9_axhelm_cu_b6a320c213axhelm_kernelILi8ELN13axhelm_detail10GeomSourceE1EfEEvPKT1_PS3_S5_S5_S5_PKfS8_S8_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 50 registers, used 1 barriers, 8544 bytes smem, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__b7183762_16_axhelm_column_cu_0fa777f820axhelm_column_kernelILi8ELN13axhelm_detail10GeomSourceE4E13__nv_bfloat16EEvPKT1_PS4_S6_S6_S6_PKfNS_12ColumnConstsIXT_EEEiii' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__b7183762_16_axhelm_column_cu_0fa777f820axhelm_column_kernelILi8ELN13axhelm_detail10GeomSourceE4E13__nv_bfloat16EEvPKT1_PS4_S6_S6_S6_PKfNS_12ColumnConstsIXT_EEEiii
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size, 17184 bytes smem, 672 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6helperv' for 'sm_90a'
ptxas info    : Used 4 registers
"""


def test_ptxas_report_names_body_and_spills():
    node, column, other = build.ptxas_instantiations(_REPORT)
    assert node == {"variant": "trilinear", "body": "node", "n1": 8,
                    "dtype": "f32", "spill_stores": 0, "spill_loads": 0,
                    "registers": 50, "smem_bytes": 8544}
    assert column == {"variant": "partial", "body": "column", "n1": 8,
                      "dtype": "bf16", "spill_stores": 4, "spill_loads": 8,
                      "registers": 128, "smem_bytes": 17184}
    assert other == {"kernel": "_Z6helperv", "registers": 4,
                     "smem_bytes": 0}


def test_chip_smoke_bodies_follow_the_wrapper():
    """chip_smoke.py names the source of each kernel by the body its entry
    point runs: the column body for exactly `ops.COLUMN_VARIANTS`, the line
    body for exactly `ops.LINE_VARIANTS`, the node body for the rest."""
    assert {v for v, body in chip_smoke.BODY.items() if body == "column"} \
        == set(ops.COLUMN_VARIANTS)
    assert {v for v, body in chip_smoke.BODY.items() if body == "line"} \
        == set(ops.LINE_VARIANTS)
    assert {v for v, body in chip_smoke.BODY.items() if body == "node"} \
        == set(ops.KERNEL_VARIANTS) - set(ops.ROWWISE_VARIANTS)
    assert set(chip_smoke.BODY) == set(ops.KERNEL_VARIANTS)
    for path in chip_smoke.SOURCE.values():
        assert (chip_smoke.ROOT / path).is_file()
    assert {p.name for p in build.SOURCES} == \
        {chip_smoke.SOURCE[b].rsplit("/", 1)[1]
         for b in ("node", "column", "line", "slab", "plane", "staged")}
