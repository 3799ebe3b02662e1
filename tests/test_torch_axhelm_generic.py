"""The generic body of the axhelm kernels (`csrc/axhelm.cu`,
`axhelm_any_kernel`), which runs every variant at every N1 the tuned bodies
lack, on the CPU: what of it is not CUDA.

* Its node walk, written here in the kernel's order (one block an element
  of `ops.generic_launch` threads, thread t taking the nodes t, t +
  threads, ...; per column x into shared memory, then per node the factors
  and the weighted gradient, then per node y), against the reference
  package's jnp oracle: float64, <= 1e-12 relative (the same formulas in
  another order), all five geometry sources at N1 = 2, 3, 6, 11 and 16.
* The order limits: `ops.N1_MAX` is the largest N1 whose shared memory fits
  in a block (the generic body's cap), and above `ops.N1_STAGED_MAX` the
  wrapper refuses an order, and setup on a CUDA device refuses it too
  (`core.axhelm._resolve_backend`).
* Which C symbol `ops` reaches for each variant and N1 (the tuned bodies at
  N1 = 4 and 8, the generic body elsewhere; the timing-only twins), with
  which arguments, and which launches it counts, through a stand-in
  library; and `chip_smoke.py`'s knowledge of the body.

The kernel itself runs on the card only: tests/test_torch_cuda.py.
"""

import functools
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import axhelm as jax_axhelm
from repro.core import mesh_gen as jmesh
from repro.core.spectral import basis as jbasis
from repro.kernels.axhelm import ops as jops
from repro.kernels.axhelm import ref as jref
from repro_torch.core import axhelm as taxhelm
from repro_torch.core import geometry as tgeom
from repro_torch.core.spectral import basis as tbasis
from repro_torch.kernels.axhelm import build, ops

from test_torch_axhelm_column import _meta, fake_card  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _torch_x64 import x64  # noqa: F401

RTOL64 = 1e-12


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def trilinear_adjugate(v, xi_i, xi_j, xi_k):
    """The kernel's per-node Alg. 3 up to the adjugate (`trilinear_adjugate`
    in csrc/axhelm.cu): J~ from the vertices v (8, 3) at the nodes'
    (xi_i, xi_j, xi_k), then adj(J~^T J~) (P, 6) and det(J~) (P,)."""
    lo_i, hi_i = (1 - xi_i)[:, None], (1 + xi_i)[:, None]
    lo_j, hi_j = (1 - xi_j)[:, None], (1 + xi_j)[:, None]
    t = xi_k[:, None]
    ra = lo_j * (v[1] - v[0]) + hi_j * (v[3] - v[2])
    rb = lo_j * (v[5] - v[4]) + hi_j * (v[7] - v[6])
    c0 = (ra + rb) + t * (rb - ra)
    sa = lo_i * (v[2] - v[0]) + hi_i * (v[3] - v[1])
    sb = lo_i * (v[6] - v[4]) + hi_i * (v[7] - v[5])
    c1 = (sa + sb) + t * (sb - sa)
    c2 = (lo_i * lo_j * (v[4] - v[0]) + hi_i * lo_j * (v[5] - v[1])
          + hi_i * hi_j * (v[7] - v[3]) + lo_i * hi_j * (v[6] - v[2]))
    k00, k01, k02 = (c0 * c0).sum(1), (c0 * c1).sum(1), (c0 * c2).sum(1)
    k11, k12, k22 = (c1 * c1).sum(1), (c1 * c2).sum(1), (c2 * c2).sum(1)
    adj = np.stack([k11 * k22 - k12 * k12, k02 * k12 - k01 * k22,
                    k01 * k12 - k02 * k11, k00 * k22 - k02 * k02,
                    k01 * k02 - k00 * k12, k00 * k11 - k01 * k01], axis=1)
    det = (c0 * np.cross(c1, c2)).sum(1)
    return adj, det


def node_factors(variant, geom, lam0, lam1, helm, xi, w3, e, nodes, i, j, k):
    """The kernel's `node_factors`: (G with the lam0 slot folded in (P, 6),
    mass (P,)) at `nodes` of element e."""
    w = w3[nodes]
    if variant == "precomputed":                    # planar (E, 7, N1^3)
        g, gwj = geom[e, :6, nodes], geom[e, 6, nodes]
    elif variant == "parallelepiped":               # gelem (E, 7)
        g, gwj = geom[e, :6][None] * w[:, None], geom[e, 6] * w
    else:
        adj, det = trilinear_adjugate(geom[e], xi[i], xi[j], xi[k])
        if variant == "trilinear":
            g, gwj = adj * (0.125 * w / det)[:, None], w * det / 512
        else:                                       # merged, partial
            g, gwj = adj, np.zeros(len(nodes))
    if lam0 is not None:
        g = g * lam0[e, nodes][:, None]
    mass = np.zeros(len(nodes))
    if helm:
        mass = lam1[e, nodes] if variant == "merged" else \
            gwj * (1 if lam1 is None else lam1[e, nodes])
    return g, mass


def generic_walk(x, dhat, xi, w3, variant, geom, lam0, lam1, helm):
    """The generic body in float64: x (E, C, N1^3) -> y, each element a
    block whose threads walk its nodes in passes of `threads`; a pass here
    does, node by node, what the block's threads do at once."""
    e_count, ncols, n_p = x.shape
    n1 = len(xi)
    nc = n1 * n1
    threads, grid, _ = ops.generic_launch(n1, e_count)
    assert grid == e_count and threads % 32 == 0
    passes = [np.arange(s, min(s + threads, n_p))
              for s in range(0, n_p, threads)]
    m = np.arange(n1)
    y = np.empty_like(x)
    for e in range(e_count):
        for c in range(ncols):
            s_x = x[e, c].copy()
            s_r, s_s, s_t = (np.empty(n_p) for _ in range(3))
            for nodes in passes:                    # grad, factors
                i, j, k = nodes % n1, (nodes // n1) % n1, nodes // nc
                g, _ = node_factors(variant, geom, lam0, lam1, helm, xi, w3,
                                    e, nodes, i, j, k)
                xr = (dhat[i] * s_x[((k * n1 + j) * n1)[:, None] + m]).sum(1)
                xs = (dhat[j] * s_x[((k[:, None] * n1 + m) * n1)
                                    + i[:, None]]).sum(1)
                xt = (dhat[k] * s_x[((m * n1 + j[:, None]) * n1)
                                    + i[:, None]]).sum(1)
                s_r[nodes] = g[:, 0] * xr + g[:, 1] * xs + g[:, 2] * xt
                s_s[nodes] = g[:, 1] * xr + g[:, 3] * xs + g[:, 4] * xt
                s_t[nodes] = g[:, 2] * xr + g[:, 4] * xs + g[:, 5] * xt
            for nodes in passes:                    # y
                i, j, k = nodes % n1, (nodes // n1) % n1, nodes // nc
                _, mass = node_factors(variant, geom, lam0, lam1, helm, xi,
                                       w3, e, nodes, i, j, k)
                yv = mass * s_x[nodes]
                yv = yv + (dhat[:, i].T * s_r[((k * n1 + j) * n1)[:, None]
                                              + m]).sum(1)
                yv = yv + (dhat[:, j].T * s_s[((k[:, None] * n1 + m) * n1)
                                              + i[:, None]]).sum(1)
                yv = yv + (dhat[:, k].T * s_t[((m * n1 + j[:, None]) * n1)
                                              + i[:, None]]).sum(1)
                y[e, c, nodes] = yv
    return y


@functools.lru_cache(maxsize=None)
def _mesh_verts(n, affine):
    box = jmesh.box_mesh(2, 1, 1, n)
    mesh = jmesh.deform_affine(box, seed=2) if affine else \
        jmesh.deform_trilinear(box, seed=3)
    return np.asarray(mesh.verts, np.float64)


# every geometry source, with the equation(s) it takes; Helmholtz covers
# the Poisson path and adds the mass term
WALK_CASES = [("precomputed", True), ("trilinear", True),
              ("parallelepiped", True), ("merged", True), ("partial", False)]


@pytest.mark.parametrize("n1", [2, 3, 6, 11, 16])
@pytest.mark.parametrize("variant,helm", WALK_CASES)
def test_generic_walk_matches_reference(x64, variant, helm, n1):
    """Two elements, two columns, random per-node lam0/lam1 (merged: the
    reference's Lam2/Lam3 of them; partial: its gScale).  K1's factors are
    the port's float64 discrete ones (held to the reference's at 1e-12 in
    tests/test_torch_setup.py), laid out in planes for the walk and packed
    for the reference."""
    n = n1 - 1
    rng = np.random.default_rng(100 * n1 + len(variant))
    b = jbasis(n)
    verts = _mesh_verts(n, variant == "parallelepiped")
    e = len(verts)
    node = (e, n1, n1, n1)
    x = rng.standard_normal((e, 2, n1 ** 3))
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
    flat = {k: None if v is None else v.reshape(e, -1)
            for k, v in (("lam0", lam0), ("lam1", lam1))}
    ours = generic_walk(x, np.asarray(b.dhat), np.asarray(b.points),
                        np.asarray(b.w3).reshape(-1), variant, geom,
                        flat["lam0"], flat["lam1"], helm)
    shape = (e, 2) + (n1,) * 3
    kw = {k: jnp.asarray(v) for k, v in (("lam0", lam0), ("lam1", lam1))
          if v is not None}
    ref = jops.reference(jnp.asarray(x.reshape(shape)), b, variant,
                         jnp.asarray(ref_geom), helmholtz=helm, **kw)
    assert _rel(ours.reshape(shape), ref) <= RTOL64


@pytest.mark.parametrize("n1", [2, 3, 6, 8, 9, 16, 24])
def test_generic_walk_covers_every_node_once(n1):
    """Whole warps, at most GENERIC_THREADS a block, and the passes of the
    walk visit each node of the element exactly once."""
    threads, grid, smem = ops.generic_launch(n1, 5)
    assert grid == 5 and threads % 32 == 0
    assert threads == min(ops.GENERIC_THREADS, -(-n1 ** 3 // 32) * 32)
    seen = sorted(node for t in range(threads)
                  for node in range(t, n1 ** 3, threads))
    assert seen == list(range(n1 ** 3))
    assert smem == ops.generic_smem_bytes(n1) <= ops.SMEM_PER_BLOCK


def test_n1_max_is_the_largest_element_a_block_holds():
    """D-hat, 32 geometry words, x and the three weighted components in
    fp32: 16 N1^3 + 4 N1^2 + 128 bytes, 223,616 at N1 = 24, 252,628 at 25,
    against the 232,448 bytes a block may have on the H100.  N1_MAX stays
    the generic body's cap (the generic twin's; the entry points run the
    slab body up to it, the slab body's N1_SLAB_MAX); above
    it the entry points run the plane body up to N1_PLANE_MAX = 48
    (tests/test_torch_axhelm_plane.py)."""
    assert ops.generic_smem_bytes(24) == 223616
    assert ops.generic_smem_bytes(25) == 252628
    assert max(n for n in range(2, 64)
               if ops.generic_smem_bytes(n) <= ops.SMEM_PER_BLOCK) \
        == ops.N1_MAX == 24
    assert ops.body_of("trilinear", ops.N1_MAX) == "slab"
    assert ops.N1_SLAB_MAX == ops.N1_MAX
    assert ops.body_of("trilinear", ops.N1_MAX + 1) == "plane"
    assert ops.N1_PLANE_MAX == 48


def _geom_meta(variant, e, n1, dtype=torch.float32):
    shape = {"precomputed": (e, 7, n1, n1, n1),
             "parallelepiped": (e, 7)}.get(variant, (e, 8, 3))
    return _meta(shape, dtype)


def _lams_meta(variant, e, n1, dtype=torch.float32):
    names = {"merged": ("lam0", "lam1"), "partial": ("lam0",)}.get(variant,
                                                                   ())
    return {name: _meta((e, n1, n1, n1), dtype) for name in names}


@pytest.mark.parametrize("n1", [2, 4, 6, 8, 16, 17, ops.N1_MAX])
@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_axhelm_routes_each_order_to_its_body(fake_card, variant, n1):
    """N1 from 2 to N1_TUNED_MAX = 16 reaches the entry point's tuned body,
    N1 above it up to N1_MAX the slab body (`*_slab`, the generic body's
    arguments and a scratch pointer); either way the launch counts under
    the entry point."""
    b = tbasis(n1 - 1)
    e, helm = 3, variant == "merged"
    before = dict(ops.launch_counts)
    ops.axhelm(_meta((e, 2, 1) + (n1,) * 3), b, variant,
               _geom_meta(variant, e, n1), helmholtz=helm,
               **_lams_meta(variant, e, n1))
    (name, args), = fake_card.calls
    entry = ops.entry_point(variant, torch.float32)
    tuned = n1 <= ops.N1_TUNED_MAX
    assert tuned == (n1 in ops.KERNEL_N1)
    key = variant if tuned else f"{variant}_slab"
    assert name == (entry if tuned else f"{entry}_slab")
    assert name == build.symbol(key, "f32")
    assert len(args) == len(build.SIGNATURES[key])
    assert ops.body_of(variant, n1) == (
        ("column" if variant in ops.COLUMN_VARIANTS else "line") if tuned
        else "slab")
    if not tuned:
        assert args[9:13] == (n1, e, 2, int(helm)) and args[-1] == 7
    assert ops.launch_counts[entry] == before[entry] + 1


@pytest.mark.parametrize("n1", [1, 15, 16, 17, 24, 25])
@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_body_of_routes_at_the_tuned_and_generic_edges(fake_card, monkeypatch,
                                                       variant, n1):
    """`body_of` and the launch it makes at the edges of the tuned range
    (N1 = 2 to 16), the slab body's (17 to 24) and the plane body's
    first N1: N1 = 1 (order 0, which has no GLL basis) is
    refused before any launch."""
    b = tbasis(n1 - 1) if n1 > 1 else types.SimpleNamespace(n=0, n1=1)
    e, helm = 3, variant == "merged"
    want = {1: None, 15: "tuned", 16: "tuned", 17: "slab", 24: "slab",
            25: "plane"}[n1]
    tuned = "column" if variant in ops.COLUMN_VARIANTS else "line"
    if want is not None:
        assert ops.body_of(variant, n1) == (tuned if want == "tuned"
                                            else want)
    call = functools.partial(
        ops.axhelm, _meta((e, 2, 1) + (n1,) * 3), b, variant,
        _geom_meta(variant, e, n1), helmholtz=helm,
        **_lams_meta(variant, e, n1))
    if want is None:
        monkeypatch.setattr(ops, "_check_kernel_operands", _REAL_CHECK)
        with pytest.raises(ValueError, match="N1 from 2"):
            call()
        assert fake_card.calls == []
        return
    call()
    (name, _), = fake_card.calls
    entry = ops.entry_point(variant, torch.float32)
    assert name == (entry if want == "tuned" else f"{entry}_{want}")


_REAL_CHECK = ops._check_kernel_operands


@pytest.mark.parametrize("n1", [4, 8])
@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_twins_reach_their_bodies_and_count_nothing(fake_card, variant, n1):
    """`generic` takes the generic body at the tuned bodies' N1 too, and
    `rowwise` the node body; neither counts a launch."""
    b = tbasis(n1 - 1)
    e = 3
    before = dict(ops.launch_counts)
    kw = dict(helmholtz=variant == "merged", **_lams_meta(variant, e, n1))
    ops.generic(_meta((e,) + (n1,) * 3), b, variant,
                _geom_meta(variant, e, n1), **kw)
    ops.rowwise(_meta((e,) + (n1,) * 3), b, variant,
                _geom_meta(variant, e, n1), **kw)
    assert [name for name, _ in fake_card.calls] == [
        build.symbol(f"{variant}_any", "f32"),
        build.symbol(f"{variant}_rowwise", "f32")]
    assert ops.launch_counts == before


@pytest.mark.parametrize("n1,twin,match", [
    (ops.N1_STAGED_MAX + 1, None, "N1_STAGED_MAX"), (30, "any", "N1_MAX"),
    (6, "rowwise", "instantiated"), (1, None, "from 2")])
def test_wrapper_refuses_an_order_it_has_no_body_for(n1, twin, match):
    """Above N1_STAGED_MAX (the staged body's panel outgrows a block's
    shared memory) and below 2 no body runs; the generic body's twin only
    up to N1_MAX; the node body only at the tuned N1.  The wrapper raises
    before it looks at the tensors; above N1_PLANE_MAX it takes the
    order (the staged body) and stops at the device."""
    b = type("B", (), {"n1": n1, "n": n1 - 1})
    x = _meta((3, 1, 1) + (n1,) * 3 if n1 < 100 else (3, 1, 1, 1, 1, 1))
    with pytest.raises(ValueError, match=match):
        ops._check_kernel_operands(x, b, "trilinear", _meta((3, 8, 3)),
                                   None, None, twin)
    big = ops.N1_PLANE_MAX + 1
    with pytest.raises(ValueError, match="CUDA device"):
        ops._check_kernel_operands(_meta((3, 1, 1) + (big,) * 3),
                                   tbasis(big - 1), "trilinear",
                                   _meta((3, 8, 3)), None, None)


def test_setup_refuses_orders_above_n1_max_on_a_card():
    """`_resolve_backend` raises for "auto" and "cuda" on a CUDA device
    above N1_STAGED_MAX (the way it refuses float64), before anything
    touches the device, and takes the kernels up to it (above N1_MAX
    through the plane body, above N1_PLANE_MAX through the staged
    body); "cuda" on the CPU runs the plain version at any order."""
    f32, cuda, cpu = torch.float32, torch.device("cuda"), torch.device("cpu")
    big = ops.N1_STAGED_MAX + 1
    for backend in (None, "auto", "cuda"):
        with pytest.raises(ValueError, match="N1_STAGED_MAX"):
            taxhelm._resolve_backend(backend, f32, cuda, big)
        for n1 in (ops.N1_MAX, ops.N1_MAX + 1, ops.N1_PLANE_MAX,
                   ops.N1_PLANE_MAX + 1, 64, ops.N1_STAGED_MAX):
            assert taxhelm._resolve_backend(backend, f32, cuda,
                                            n1) == "cuda"
    assert taxhelm._resolve_backend("cuda", f32, cpu, big) == "cuda"
    assert taxhelm._resolve_backend("reference", f32, cuda, big) == \
        "reference"
    verts = np.asarray(jmesh.box_mesh(1, 1, 1, 1).verts)
    with pytest.raises(ValueError, match="N1_STAGED_MAX"):
        taxhelm.make_axhelm_elem_ops("trilinear",
                                     type("B", (), {"n1": big, "n": big - 1}),
                                     verts, device="cuda")


_ANY_REPORT = """\
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__e86fd865_9_axhelm_cu_6ab977b017axhelm_any_kernelILN13axhelm_detail10GeomSourceE3E13__nv_bfloat16EEvPKT0_PS4_S6_S6_S6_PKfS9_S9_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__e86fd865_9_axhelm_cu_6ab977b017axhelm_any_kernelILN13axhelm_detail10GeomSourceE3E13__nv_bfloat16EEvPKT0_PS4_S6_S6_S6_PKfS9_S9_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 57 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_report_names_the_generic_body():
    (inst,) = build.ptxas_instantiations(_ANY_REPORT)
    assert inst == {"variant": "merged", "body": "any", "n1": None,
                    "dtype": "bf16", "spill_stores": 0, "spill_loads": 0,
                    "registers": 57, "smem_bytes": 0}


_PLANE_REPORT = """\
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__c65e9103_15_axhelm_plane_cu_486765ee19axhelm_plane_kernelILN13axhelm_detail10GeomSourceE1EfEEvNS_9PlaneArgsIT0_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__c65e9103_15_axhelm_plane_cu_486765ee19axhelm_plane_kernelILN13axhelm_detail10GeomSourceE1EfEEvNS_9PlaneArgsIT0_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 128 bytes smem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__c65e9103_15_axhelm_plane_cu_486765ee24axhelm_plane_line_kernelILb1E13__nv_bfloat16EEvNS_9PlaneArgsIT0_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__c65e9103_15_axhelm_plane_cu_486765ee24axhelm_plane_line_kernelILb1E13__nv_bfloat16EEvNS_9PlaneArgsIT0_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
"""


def test_ptxas_report_names_the_plane_body():
    """The plane body's kernels as phase 2 parses them (names as nvcc 12.9
    mangles them for sm_90a): a variant's plane pass, and a line
    contraction every variant shares (variant None)."""
    plane, line = build.ptxas_instantiations(_PLANE_REPORT)
    assert plane == {"variant": "trilinear", "body": "plane",
                     "pass": "plane", "n1": None, "dtype": "f32",
                     "spill_stores": 0, "spill_loads": 0,
                     "registers": 128, "smem_bytes": 128}
    assert line == {"variant": None, "body": "plane", "pass": "line_last",
                    "n1": None, "dtype": "bf16", "spill_stores": 0,
                    "spill_loads": 0, "registers": 40, "smem_bytes": 0}
    assert build.PLANE_SHARED_PASSES == ("line_first", "line_last")
    assert build.PLANE_VARIANT_PASSES == ("plane",)


def test_chip_smoke_checks_the_generic_body_where_it_runs():
    """The orders chip_smoke.py checks and times the generic body at are
    ones it runs (N1 up to N1_MAX, never a tuned body's), its main path's
    among them; its source is the node body's file."""
    n1s = [o + 1 for o in chip_smoke.GENERIC_ORDERS]
    assert all(2 <= n1 <= ops.N1_MAX and n1 not in ops.KERNEL_N1
               for n1 in n1s)
    assert chip_smoke.GENERIC_MAIN_ORDER in chip_smoke.GENERIC_ORDERS
    assert chip_smoke.SOURCE["any"] == chip_smoke.SOURCE["node"]
    assert "axhelm_any_kernel" in (chip_smoke.ROOT
                                   / chip_smoke.SOURCE["any"]).read_text()
    # held against its plain version there through its twin, c = 1 and 4
    script = (chip_smoke.ROOT / "chip_smoke.py").read_text()
    assert "generic_n1 = [order + 1 for order in GENERIC_ORDERS]" in script
    assert "generic_name, twin=\"any\")" in script
    assert chip_smoke.GENERIC_CHECK_ELEMS == 3
