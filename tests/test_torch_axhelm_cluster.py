"""The cluster body of the axhelm kernels (`csrc/axhelm_cluster.cu`,
`axhelm_cluster_kernel`), which runs every variant at N1 above the generic
body's N1_MAX, on the CPU: what of it is not CUDA.

* Its walk, written here in the kernel's order (a cluster of P blocks an
  element, block b holding the t-planes [b K, min((b + 1) K, N1)); per
  column each block stages its planes of x, then per node of its planes
  the factors and the weighted gradient, x_t summed over every plane in
  the peers' order, then per node y, the t term over every plane the same
  way), vectorised over a block's nodes; a peer's distributed-shared-memory
  read is an index into that peer's slab.  Against the reference package's
  jnp oracle in float64, <= 1e-12 relative (the same formulas in another
  order): all five geometry sources at N1 = 25 with P = 2 (the launch's
  own), N1 = 27 with P = 4 (a short last slab) and N1 = 9 with P = 8 (empty
  last slabs), E = 2, c = 1 and 3.
* `ops.cluster_launch`'s arithmetic and the cap: N1_CLUSTER_MAX is the
  largest N1 whose slab fits in a block of an 8-block cluster.
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

The kernel itself runs on the card only: tests/test_torch_cluster_cuda.py.
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
                                       _mesh_verts, _rel, node_factors)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _torch_x64 import x64  # noqa: F401,E402

RTOL64 = 1e-12
RTOL32 = 1e-4


def slabs(n1: int, p: int, k: int):
    """The t-planes [lo, hi) of each block of a cluster of p blocks holding
    k planes each (a last slab may be short, or empty: hi <= lo)."""
    return [(b * k, min((b + 1) * k, n1)) for b in range(p)]


def cluster_walk(x, dhat, xi, w3, variant, geom, lam0, lam1, helm, p, k):
    """The cluster body in float64: x (E, C, N1^3) -> y.  Each block's
    slabs of x, s_r, s_s and s_t are (planes, N1, N1) arrays indexed
    [plane, j, i]; a block reads a peer's planes by indexing the peer's
    array, as the kernel maps the peer's shared memory."""
    e_count, ncols, _ = x.shape
    n1 = len(xi)
    nc = n1 * n1
    parts = slabs(n1, p, k)
    m = np.arange(n1)
    y = np.empty_like(x)
    for e in range(e_count):
        for c in range(ncols):
            # 1. every block stages its planes of x
            s_x = [x[e, c, lo * nc:max(lo, hi) * nc].reshape(-1, n1, n1)
                   for lo, hi in parts]
            s_r, s_s, s_t = ([np.empty_like(s) for s in s_x]
                             for _ in range(3))
            walk = []
            for b, (lo, hi) in enumerate(parts):
                q = np.arange(max(0, hi - lo) * nc)
                i, j, kl = q % n1, (q // n1) % n1, q // nc
                walk.append((q, i, j, kl, lo + kl, lo * nc + q))
            # 2. per node of each block: factors, gradient, components
            for b, (q, i, j, kl, kk, node) in enumerate(walk):
                g, _ = node_factors(variant, geom, lam0, lam1, helm, xi, w3,
                                    e, node, i, j, kk)
                xr = (dhat[i] * s_x[b][kl[:, None], j[:, None], m]).sum(1)
                xs = (dhat[j] * s_x[b][kl[:, None], m, i[:, None]]).sum(1)
                xt = np.zeros(len(q))
                for b2, (lo2, hi2) in enumerate(parts):   # peers, in order
                    mm = np.arange(lo2, hi2)
                    xt = xt + (dhat[kk][:, lo2:max(lo2, hi2)]
                               * s_x[b2][mm - lo2, j[:, None],
                                         i[:, None]]).sum(1)
                s_r[b].reshape(-1)[q] = g[:, 0] * xr + g[:, 1] * xs \
                    + g[:, 2] * xt
                s_s[b].reshape(-1)[q] = g[:, 1] * xr + g[:, 3] * xs \
                    + g[:, 4] * xt
                s_t[b].reshape(-1)[q] = g[:, 2] * xr + g[:, 4] * xs \
                    + g[:, 5] * xt
            # 3. per node of each block: y
            for b, (q, i, j, kl, kk, node) in enumerate(walk):
                _, mass = node_factors(variant, geom, lam0, lam1, helm, xi,
                                       w3, e, node, i, j, kk)
                yv = mass * s_x[b].reshape(-1)[q]
                yv = yv + (dhat[:, i].T
                           * s_r[b][kl[:, None], j[:, None], m]).sum(1)
                yv = yv + (dhat[:, j].T
                           * s_s[b][kl[:, None], m, i[:, None]]).sum(1)
                for b2, (lo2, hi2) in enumerate(parts):
                    mm = np.arange(lo2, hi2)
                    yv = yv + (dhat[lo2:max(lo2, hi2), :][:, kk].T
                               * s_t[b2][mm - lo2, j[:, None],
                                         i[:, None]]).sum(1)
                y[e, c, node] = yv
    return y


@pytest.mark.parametrize("ncols", [1, 3])
@pytest.mark.parametrize("n1,p", [(25, 2), (27, 4), (9, 8)])
@pytest.mark.parametrize("variant,helm", WALK_CASES)
def test_cluster_walk_matches_reference(x64, variant, helm, n1, p, ncols):
    """Two elements, random per-node lam0/lam1 (merged: the reference's
    Lam2/Lam3 of them; partial: its gScale).  K1's factors are the port's
    float64 discrete ones, in planes for the walk and packed for the
    reference."""
    n = n1 - 1
    k = -(-n1 // p)
    if n1 > ops.N1_MAX:
        assert p * k >= n1 and p <= ops.CLUSTER_MAX
    rng = np.random.default_rng(1000 * n1 + 10 * ncols + len(variant))
    b = jbasis(n)
    verts = _mesh_verts(n, variant == "parallelepiped")
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
    flat = {name: None if v is None else v.reshape(e, -1)
            for name, v in (("lam0", lam0), ("lam1", lam1))}
    ours = cluster_walk(x, np.asarray(b.dhat), np.asarray(b.points),
                        np.asarray(b.w3).reshape(-1), variant, geom,
                        flat["lam0"], flat["lam1"], helm, p, k)
    shape = (e, ncols, 1) + (n1,) * 3
    kw = {name: jnp.asarray(v) for name, v in (("lam0", lam0),
                                               ("lam1", lam1))
          if v is not None}
    ref = jops.reference(jnp.asarray(x.reshape(shape)), b, variant,
                         jnp.asarray(ref_geom), helmholtz=helm, **kw)
    assert _rel(ours.reshape(shape), ref) <= RTOL64


@pytest.mark.parametrize("n1", range(ops.N1_MAX + 1, ops.N1_CLUSTER_MAX + 1))
def test_cluster_launch_takes_the_smallest_cluster_that_holds_a_slab(n1):
    """P the smallest power of two whose slab of K = ceil(N1 / P) planes
    fits in a block's shared memory; P blocks an element; the slabs cover
    every plane once; whole warps, at most CLUSTER_THREADS."""
    p, k, threads, grid, smem = ops.cluster_launch(n1, 64)
    assert p in (2, 4, 8) and k == -(-n1 // p) and grid == 64 * p
    assert smem == ops.cluster_smem_bytes(n1, k) <= ops.SMEM_PER_BLOCK
    assert ops.cluster_smem_bytes(n1, -(-n1 // (p // 2))) > \
        ops.SMEM_PER_BLOCK
    planes = [q for lo, hi in slabs(n1, p, k) for q in range(lo, hi)]
    assert planes == list(range(n1))
    assert threads % 32 == 0
    assert threads == min(ops.CLUSTER_THREADS, -(-k * n1 * n1 // 32) * 32)


def test_n1_cluster_max_is_the_largest_element_a_cluster_holds():
    """D-hat (rows padded to N1 + 1), 32 geometry words, x and the three
    weighted components of K planes in fp32: 16 K N1^2 + 4 N1 (N1 + 1) +
    128 bytes.  P = 2 at N1 = 25, 4 at 32, 8 at 48 (230,720 bytes); at
    N1 = 49 the 8-block slab takes 278,840 bytes, more than the 232,448 a
    block may have."""
    assert [ops.cluster_launch(n1, 1)[0] for n1 in (25, 30, 31, 32, 37, 38,
                                                    48)] == \
        [2, 2, 4, 4, 4, 8, 8]
    assert ops.cluster_smem_bytes(48, 6) == 230720
    assert ops.cluster_smem_bytes(49, 7) == 278840
    assert max(n for n in range(2, 80) if ops.cluster_smem_bytes(
        n, -(-n // ops.CLUSTER_MAX)) <= ops.SMEM_PER_BLOCK) \
        == ops.N1_CLUSTER_MAX == 48
    with pytest.raises(ValueError, match="N1_CLUSTER_MAX"):
        ops.cluster_launch(ops.N1_CLUSTER_MAX + 1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1", [ops.N1_MAX, ops.N1_MAX + 1, 32,
                                ops.N1_CLUSTER_MAX])
@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_axhelm_routes_large_orders_to_the_cluster_body(fake_card, variant,
                                                        n1, dtype):
    """N1 above N1_TUNED_MAX up to N1_MAX reaches the generic body
    (`*_any`), N1 above it the
    cluster body (`*_cluster`, the generic body's arguments plus the
    cluster size and the planes a block holds); either way the launch
    counts under the entry point."""
    b = tbasis(n1 - 1)
    e, helm = 3, variant == "merged"
    before = dict(ops.launch_counts)
    ops.axhelm(_meta((e, 2, 1) + (n1,) * 3, dtype), b, variant,
               _geom_meta(variant, e, n1, dtype), helmholtz=helm,
               **_lams_meta(variant, e, n1, dtype))
    (name, args), = fake_card.calls
    entry = ops.entry_point(variant, dtype)
    assert n1 > ops.N1_TUNED_MAX
    body = "cluster" if n1 > ops.N1_MAX else "any"
    assert ops.body_of(variant, n1) == body
    assert name == f"{entry}_{body}" == build.symbol(
        f"{variant}_{body}", ops.KERNEL_DTYPES[dtype])
    assert len(args) == len(build.SIGNATURES[f"{variant}_{body}"])
    assert args[8:12] == (n1, e, 2, int(helm)) and args[-1] == 7
    if body == "cluster":
        p, k, *_ = ops.cluster_launch(n1, e)
        assert args[12:14] == (p, k)
    assert ops.launch_counts[entry] == before[entry] + 1
    assert sum(ops.launch_counts.values()) == sum(before.values()) + 1


def test_the_generic_twin_stops_at_n1_max():
    """`generic` (the generic body at any N1, timing only) refuses what its
    body cannot hold, though `axhelm` runs that order on the cluster
    body."""
    n1 = ops.N1_MAX + 1
    x = _meta((3, 1, 1) + (n1,) * 3)
    with pytest.raises(ValueError, match="N1_MAX = 24"):
        ops._check_kernel_operands(x, tbasis(n1 - 1), "trilinear",
                                   _meta((3, 8, 3)), None, None, "any")
    # the entry point's own check passes the order and stops at the device
    with pytest.raises(ValueError, match="CUDA device"):
        ops._check_kernel_operands(x, tbasis(n1 - 1), "trilinear",
                                   _meta((3, 8, 3)), None, None)


def test_chip_smoke_checks_the_cluster_body_where_it_runs():
    """The orders chip_smoke.py checks, solves and times the cluster body
    at are ones it runs, the cap among them; its source holds the
    kernel."""
    n1s = [o + 1 for o in chip_smoke.CLUSTER_ORDERS]
    assert all(ops.N1_MAX < n1 <= ops.N1_CLUSTER_MAX for n1 in n1s)
    assert ops.N1_CLUSTER_MAX in n1s
    assert chip_smoke.HIGH_ORDER + 1 in n1s
    assert "axhelm_cluster_kernel" in (chip_smoke.ROOT
                                       / chip_smoke.SOURCE["cluster"]
                                       ).read_text()


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
