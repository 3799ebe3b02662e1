"""Port parity, the axhelm operator: the port's kernels (their plain versions
on the CPU, through `repro_torch.kernels.axhelm.ops.axhelm`) against the
reference package's Pallas kernel — run in interpret mode on the CPU, as
tests/test_kernels_axhelm.py runs it — and against its pure-jnp oracle.

Tolerances: <= 1e-4 relative (max-norm), float32 — the budget of
kernels/axhelm/DESIGN.md §7; the two packages contract in different
orders.  The fp64 setup products (Lam2/Lam3, gScale, gelem): <= 1e-12, the
same formulas in another order.
"""

import functools

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
from repro_torch import convert
from repro_torch.core import axhelm as taxhelm
from repro_torch.core.spectral import basis as tbasis
from repro_torch.kernels.axhelm import ops as tops
from repro_torch.kernels.axhelm import ref as tref
from _torch_x64 import x64  # noqa: F401

RTOL32 = 1e-4
RTOL64 = 1e-12
COEFFS = ("poisson", "poisson_lam0", "helmholtz")
# name -> index into the (E, nrhs=2, d=3, N1^3) test field
LAYOUTS = {
    "scalar": (slice(None), 0, 0),               # (E, N1^3)
    "vector": (slice(None), 0),                  # (E, d=3, N1^3)
    "batched": (slice(None),),                   # (E, nrhs=2, d=3, N1^3)
    "batched_scalar": (slice(None), slice(None), slice(0, 1)),  # d=1
}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _verts(n, affine=False):
    """E = 8 float32 vertices: a trilinear-deformed box, or an affinely
    deformed one (every element a parallelepiped)."""
    box = jmesh.box_mesh(2, 2, 2, n)
    mesh = jmesh.deform_affine(box, seed=2) if affine else \
        jmesh.deform_trilinear(box, seed=1)
    return mesh.verts.astype(np.float32)


def _f32(a):
    # float32 whatever the x64 mode other tests left on: the basis
    # constants are float64 numpy arrays and would promote the results
    return np.array(a, dtype=np.float32)


def _geom(variant, n):
    verts = _verts(n, affine=variant == "parallelepiped")
    if variant in ("trilinear", "merged", "partial"):
        return verts
    if variant == "parallelepiped":
        return _f32(jref.gelem_from_verts(jnp.asarray(verts)))
    b = jbasis(n)
    jv = jnp.asarray(verts)
    f = jgeom.factors_discrete(jgeom.node_coords(jv, b), b)
    return _f32(jnp.concatenate([f.g, f.gwj[..., None]], axis=-1))


def _port_geom(variant, geom):
    """The port's operand of the reference package's `geom`, carried
    across by `convert`: precomputed's packed (E, N1,N1,N1, 7) becomes the
    planar (E, 7, N1,N1,N1); the others are the same array."""
    return convert.elem_ops_from_numpy(variant, {"geom": geom},
                                       "cpu")["geom"]


def _inputs(variant, n, coeff):
    """x (E, 2, 3, N1^3), geom and the lambda kwargs, all numpy float32.
    merged takes Lam2/Lam3 of the random lambdas and partial gScale, both
    from the reference package's setup, in the lambda slots."""
    rng = np.random.default_rng(100 * n + COEFFS.index(coeff))
    geom = _geom(variant, n)
    e, n1 = geom.shape[0], n + 1
    x = rng.standard_normal((e, 2, 3, n1, n1, n1)).astype(np.float32)
    kw = {}
    if coeff != "poisson":
        kw["lam0"] = (1 + 0.3 * rng.random((e, n1, n1, n1))).astype(np.float32)
    if coeff == "helmholtz":
        kw["lam1"] = (0.5 + 0.2 * rng.random((e, n1, n1, n1))).astype(
            np.float32)
        kw["helmholtz"] = True
    if variant == "merged":
        lam2, lam3 = jax_axhelm.setup_merged_lambdas(
            jnp.asarray(geom), jbasis(n), jnp.asarray(kw["lam0"]),
            jnp.asarray(kw["lam1"]))
        kw.update(lam0=_f32(lam2), lam1=_f32(lam3))
    elif variant == "partial":
        kw = {"lam0": _f32(jax_axhelm.setup_partial_gscale(
            jnp.asarray(geom), jbasis(n)))}
    return x, geom, kw


def _jax_kw(kw):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


def _torch_kw(kw):
    return {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


@functools.lru_cache(maxsize=None)
def _jax_outputs(variant, n, coeff):
    """The Pallas kernel (interpret mode) and the jnp oracle on the full
    (E, 2, 3, N1^3) batch; every layout is a slice of these columns."""
    x, geom, kw = _inputs(variant, n, coeff)
    b = jbasis(n)
    y_pallas = jops.axhelm(jnp.asarray(x), b, variant, jnp.asarray(geom),
                           **_jax_kw(kw))
    y_oracle = jops.reference(jnp.asarray(x), b, variant, jnp.asarray(geom),
                              **_jax_kw(kw))
    return np.asarray(y_pallas), np.asarray(y_oracle)


def _check_plain_version_against_pallas(n, variant, coeff, layout):
    x, geom, kw = _inputs(variant, n, coeff)
    idx = LAYOUTS[layout]
    y_pallas, y_oracle = (y[idx] for y in _jax_outputs(variant, n, coeff))
    y = tops.axhelm(torch.as_tensor(np.ascontiguousarray(x[idx])),
                    tbasis(n), variant, _port_geom(variant, geom),
                    **_torch_kw(kw))
    assert tuple(y.shape) == x[idx].shape
    assert _rel(y, y_pallas) <= RTOL32
    assert _rel(y, y_oracle) <= RTOL32
    y_plain = tops.reference(torch.as_tensor(np.ascontiguousarray(x[idx])),
                             tbasis(n), variant, _port_geom(variant, geom),
                             **_torch_kw(kw))
    assert torch.equal(y, y_plain)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("coeff", COEFFS)
@pytest.mark.parametrize("variant", ["precomputed", "trilinear"])
@pytest.mark.parametrize("n", [3, 7])
def test_kernel_plain_version_matches_pallas(n, variant, coeff, layout):
    _check_plain_version_against_pallas(n, variant, coeff, layout)


# K3 on an affine mesh with every coefficient, K4 Helmholtz only, K5 Poisson
# only; every layout at n=3, one n=7 case each (interpret mode is slow)
_NEW_KERNEL_CASES = (
    [(3, "parallelepiped", c, lay) for c in COEFFS for lay in LAYOUTS]
    + [(3, "merged", "helmholtz", lay) for lay in LAYOUTS]
    + [(3, "partial", "poisson", lay) for lay in LAYOUTS]
    + [(7, "parallelepiped", "helmholtz", "batched"),
       (7, "merged", "helmholtz", "batched"),
       (7, "partial", "poisson", "batched")])


@pytest.mark.parametrize("n,variant,coeff,layout", _NEW_KERNEL_CASES)
def test_new_kernel_plain_versions_match_pallas(n, variant, coeff, layout):
    _check_plain_version_against_pallas(n, variant, coeff, layout)


@pytest.mark.parametrize("n", [2, 3, 7])
def test_setup_products_match_reference(x64, n):
    """Lam2/Lam3 (merged), gScale (partial) and gelem (parallelepiped) in
    float64, from the same vertices and lambda fields."""
    rng = np.random.default_rng(7 + n)
    tri = jmesh.deform_trilinear(jmesh.box_mesh(2, 1, 2, n), seed=3).verts
    aff = jmesh.deform_affine(jmesh.box_mesh(2, 1, 2, n), seed=2).verts
    node = (len(tri),) + (n + 1,) * 3
    lam0, lam1 = 1 + 0.3 * rng.random(node), 0.5 + 0.2 * rng.random(node)
    jb, tb = jbasis(n), tbasis(n)
    j2, j3 = jax_axhelm.setup_merged_lambdas(
        jnp.asarray(tri), jb, jnp.asarray(lam0), jnp.asarray(lam1))
    t2, t3 = taxhelm.setup_merged_lambdas(
        torch.as_tensor(tri), tb, torch.as_tensor(lam0), torch.as_tensor(lam1))
    assert _rel(t2, j2) <= RTOL64 and _rel(t3, j3) <= RTOL64
    assert _rel(taxhelm.setup_partial_gscale(torch.as_tensor(tri), tb),
                jax_axhelm.setup_partial_gscale(jnp.asarray(tri), jb)) \
        <= RTOL64
    for v in (aff, tri):
        assert _rel(tref.gelem_from_verts(torch.as_tensor(v)),
                    jref.gelem_from_verts(jnp.asarray(v))) <= RTOL64


@pytest.mark.parametrize("variant", tops.KERNEL_VARIANTS)
def test_public_layouts_agree(variant):
    """(E, N1^3) and (E, 1, 1, N1^3), and (E, d, N1^3) and
    (E, 1, d, N1^3), are the same field: the same y, bit for bit."""
    x, geom, kw = _inputs(variant, 3, "helmholtz")
    b, g, kw = tbasis(3), _port_geom(variant, geom), _torch_kw(kw)
    xt = torch.as_tensor(x)
    y_s = tops.axhelm(xt[:, 0, 0].contiguous(), b, variant, g, **kw)
    y_sb = tops.axhelm(xt[:, :1, :1].contiguous(), b, variant, g, **kw)
    assert torch.equal(y_s, y_sb[:, 0, 0])
    y_v = tops.axhelm(xt[:, 0].contiguous(), b, variant, g, **kw)
    y_vb = tops.axhelm(xt[:, :1].contiguous(), b, variant, g, **kw)
    assert torch.equal(y_v, y_vb[:, 0])


@pytest.mark.parametrize("jax_backend,port_backend",
                         [("reference", "reference"), ("pallas", "cuda")])
@pytest.mark.parametrize("coeff", COEFFS)
@pytest.mark.parametrize("variant", ["precomputed", "trilinear",
                                     "parallelepiped"])
def test_elem_ops_carried_across(variant, coeff, jax_backend, port_backend):
    """The reference package's setup products, carried into the port with
    `convert.elem_ops_from_numpy`, drive the port's element operator to the
    reference package's y; the port's own setup gives the same y."""
    n = 3
    x, _, kw = _inputs(variant, n, coeff)
    verts = _verts(n, affine=variant == "parallelepiped")
    helm = kw.pop("helmholtz", False)
    jb, tb = jbasis(n), tbasis(n)
    j_ops, j_apply, _ = jax_axhelm.make_axhelm_elem_ops(
        variant, jb, jnp.asarray(verts), helmholtz=helm, backend=jax_backend,
        dtype=jnp.float32, **_jax_kw(kw))
    y_jax = np.asarray(j_apply(jnp.asarray(x), j_ops))
    t_ops, t_apply, used = taxhelm.make_axhelm_elem_ops(
        variant, tb, torch.as_tensor(verts), helmholtz=helm,
        backend=port_backend, dtype=torch.float32, **_torch_kw(kw))
    assert used == port_backend
    carried = convert.elem_ops_from_numpy(
        variant, {k: np.asarray(v) for k, v in j_ops.items()}, "cpu")
    assert set(t_ops) == set(carried) == {"geom"} | set(kw)
    assert tuple(t_ops["geom"].shape) == tuple(carried["geom"].shape)
    xt = torch.as_tensor(x)
    assert _rel(t_apply(xt, carried), y_jax) <= RTOL32
    assert _rel(t_apply(xt, t_ops), y_jax) <= RTOL32


@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
def test_convert_lays_precomputed_factors_out_in_planes(jax_backend):
    """The reference package's precomputed operands -- its reference
    backend's g (E, N1,N1,N1, 6) and gwj, its Pallas backend's packed
    (E, N1,N1,N1, 7) geom -- become the port's planar (E, 7, N1,N1,N1):
    plane p is g[..., p], plane 6 gwj, exactly; on them the port's operator
    gives the reference operator's y (<= 1e-4, float32)."""
    n = 3
    x, _, kw = _inputs("precomputed", n, "helmholtz")
    helm = kw.pop("helmholtz")
    verts = _verts(n)
    j_ops, j_apply, _ = jax_axhelm.make_axhelm_elem_ops(
        "precomputed", jbasis(n), jnp.asarray(verts), helmholtz=helm,
        backend=jax_backend, dtype=jnp.float32, **_jax_kw(kw))
    carried = convert.elem_ops_from_numpy(
        "precomputed", {k: np.asarray(v) for k, v in j_ops.items()}, "cpu")
    geom = carried["geom"]
    assert tuple(geom.shape) == (len(verts), 7) + (n + 1,) * 3
    assert geom.is_contiguous()
    packed = np.concatenate([np.asarray(j_ops["g"]),
                             np.asarray(j_ops["gwj"])[..., None]], axis=-1) \
        if "g" in j_ops else np.asarray(j_ops["geom"])
    for plane in range(7):
        np.testing.assert_array_equal(geom[:, plane].numpy(),
                                      packed[..., plane])
    y = tops.axhelm(torch.as_tensor(x), tbasis(n), "precomputed", geom,
                    helmholtz=helm, **_torch_kw(kw))
    assert _rel(y, j_apply(jnp.asarray(x), j_ops)) <= RTOL32


@pytest.mark.parametrize("jax_backend,port_backend",
                         [("reference", "reference"), ("pallas", "cuda")])
@pytest.mark.parametrize("variant,coeff", [("merged", "helmholtz"),
                                           ("merged", "scalar_lambdas"),
                                           ("partial", "poisson")])
def test_merged_partial_elem_ops_carried_across(variant, coeff, jax_backend,
                                                port_backend):
    """merged's Lam2/Lam3 and partial's gScale, made by the reference
    package's setup (its reference backend names them lam2/lam3/gscale),
    land in the port's lambda slots and give the reference package's y;
    a lambda slot left out of the elem_ops handed to `apply` falls back to
    the port's own Lam2/Lam3 or gScale, never to the user's lambdas."""
    n = 3
    x, _, kw = _inputs("trilinear", n, "helmholtz" if variant == "merged"
                       else "poisson")
    if coeff == "scalar_lambdas":
        kw = {"lam0": 1.0, "lam1": 0.1, "helmholtz": True}
    helm = kw.pop("helmholtz", False)
    verts = _verts(n)
    jb, tb = jbasis(n), tbasis(n)
    j_ops, j_apply, _ = jax_axhelm.make_axhelm_elem_ops(
        variant, jb, jnp.asarray(verts), helmholtz=helm, backend=jax_backend,
        dtype=jnp.float32, **_jax_kw(kw))
    y_jax = np.asarray(j_apply(jnp.asarray(x), j_ops))
    t_ops, t_apply, used = taxhelm.make_axhelm_elem_ops(
        variant, tb, torch.as_tensor(verts), helmholtz=helm,
        backend=port_backend, dtype=torch.float32, **_torch_kw(kw))
    assert used == port_backend
    carried = convert.elem_ops_from_numpy(
        variant, {k: np.asarray(v) for k, v in j_ops.items()}, "cpu")
    slots = {"geom", "lam0", "lam1"} if variant == "merged" else \
        {"geom", "lam0"}
    assert set(t_ops) == set(carried) == slots
    assert tuple(t_ops["geom"].shape) == tuple(carried["geom"].shape) \
        == verts.shape
    xt = torch.as_tensor(x)
    assert _rel(t_apply(xt, carried), y_jax) <= RTOL32
    assert _rel(t_apply(xt, t_ops), y_jax) <= RTOL32
    assert _rel(t_apply(xt, {"geom": t_ops["geom"]}), y_jax) <= RTOL32


@pytest.mark.parametrize("layout", ["scalar", "vector", "batched"])
@pytest.mark.parametrize("coeff", COEFFS)
@pytest.mark.parametrize("variant", ["precomputed", "trilinear",
                                     "parallelepiped"])
def test_core_operator_matches_reference(variant, coeff, layout):
    """`core.axhelm.axhelm_precomputed`/`axhelm_trilinear`/
    `axhelm_parallelepiped` (Alg. 2/3/4 on GeomFactors and vertices, run by
    the shared plain version) against the reference package's functions of
    the same name."""
    n = 3
    x, geom, kw = _inputs(variant, n, coeff)
    helm = kw.pop("helmholtz", False)
    xl = np.ascontiguousarray(x[LAYOUTS[layout]])
    jb, tb = jbasis(n), tbasis(n)
    jdhat = jnp.asarray(jb.dhat, jnp.float32)
    tdhat = torch.as_tensor(tb.dhat, dtype=torch.float32)
    if variant == "precomputed":
        y_jax = jax_axhelm.axhelm_precomputed(
            jnp.asarray(xl), jgeom.GeomFactors(jnp.asarray(geom[..., :6]),
                                               jnp.asarray(geom[..., 6])),
            jdhat, helmholtz=helm, **_jax_kw(kw))
        tg = torch.as_tensor(geom)
        y = taxhelm.axhelm_precomputed(
            torch.as_tensor(xl), taxhelm.GeomFactors(tg[..., :6], tg[..., 6]),
            tdhat, helmholtz=helm, **_torch_kw(kw))
    elif variant == "parallelepiped":
        verts = _verts(n, affine=True)
        y_jax = jax_axhelm.axhelm_parallelepiped(
            jnp.asarray(xl), jnp.asarray(verts), jb, jdhat, helmholtz=helm,
            **_jax_kw(kw))
        y = taxhelm.axhelm_parallelepiped(
            torch.as_tensor(xl), torch.as_tensor(verts), tb, tdhat,
            helmholtz=helm, **_torch_kw(kw))
    else:
        y_jax = jax_axhelm.axhelm_trilinear(
            jnp.asarray(xl), jnp.asarray(geom), jb, jdhat, helmholtz=helm,
            **_jax_kw(kw))
        y = taxhelm.axhelm_trilinear(
            torch.as_tensor(xl), torch.as_tensor(geom), tb, tdhat,
            helmholtz=helm, **_torch_kw(kw))
    assert tuple(y.shape) == xl.shape
    assert _rel(y, y_jax) <= RTOL32


@pytest.mark.parametrize("layout", ["scalar", "vector", "batched"])
@pytest.mark.parametrize("variant", ["merged", "partial"])
def test_core_merged_partial_match_reference(variant, layout):
    """`core.axhelm.axhelm_merged`/`axhelm_partial` (§4.1.1/§4.1.2 on
    vertices and the Lam2/Lam3 or gScale fields) against the reference
    package's functions of the same name."""
    n = 3
    x, verts, kw = _inputs(variant, n, "helmholtz")
    xl = np.ascontiguousarray(x[LAYOUTS[layout]])
    jb, tb = jbasis(n), tbasis(n)
    jdhat = jnp.asarray(jb.dhat, jnp.float32)
    tdhat = torch.as_tensor(tb.dhat, dtype=torch.float32)
    fields = [kw["lam0"]] + ([kw["lam1"]] if variant == "merged" else [])
    y_jax = getattr(jax_axhelm, f"axhelm_{variant}")(
        jnp.asarray(xl), jnp.asarray(verts), jb, jdhat,
        *map(jnp.asarray, fields))
    y = getattr(taxhelm, f"axhelm_{variant}")(
        torch.as_tensor(xl), torch.as_tensor(verts), tb, tdhat,
        *map(torch.as_tensor, fields))
    assert tuple(y.shape) == xl.shape
    assert _rel(y, y_jax) <= RTOL32


@pytest.mark.parametrize("variant,same_as,coeff", [
    ("merged", "trilinear", "helmholtz"),
    ("partial", "trilinear", "poisson"),
    ("parallelepiped", "precomputed", "poisson"),
    ("parallelepiped", "precomputed", "poisson_lam0"),
    ("parallelepiped", "precomputed", "helmholtz"),
])
def test_variants_reach_the_same_operator(variant, same_as, coeff):
    """merged is trilinear/Helmholtz and partial trilinear/Poisson, with the
    scale moved into the lambda slots; on an affine mesh parallelepiped is
    the precomputed operator.  The port's setup for each, one field."""
    n = 3
    x, _, kw = _inputs("trilinear", n, coeff)
    helm = kw.pop("helmholtz", False)
    verts = torch.as_tensor(_verts(n, affine=variant == "parallelepiped"))
    xt = torch.as_tensor(x)
    ys = []
    for v in (variant, same_as):
        ops_, apply, _ = taxhelm.make_axhelm_elem_ops(
            v, tbasis(n), verts, helmholtz=helm, backend="cuda",
            dtype=torch.float32, **_torch_kw(kw))
        ys.append(apply(xt, ops_))
    assert _rel(ys[0], ys[1]) <= RTOL32


@pytest.mark.parametrize("variant,lams,match", [
    ("merged", ("lam0",), "merged requires lam0=Lam2 and lam1=Lam3"),
    ("merged", ("lam1",), "merged requires lam0=Lam2 and lam1=Lam3"),
    ("partial", (), "partial requires lam0=gScale and lam1=None"),
    ("partial", ("lam0", "lam1"), "partial requires lam0=gScale and lam1"),
])
def test_merged_partial_operand_errors_match_reference(variant, lams, match):
    """The kernel wrapper pins merged to Helmholtz with Lam2/Lam3 and
    partial to Poisson with gScale, and both packages raise the same
    ValueError for a missing or extra lambda slot."""
    x, verts, _ = _inputs("trilinear", 3, "poisson")
    field = np.ones(verts.shape[:1] + (4, 4, 4), np.float32)
    kw = {name: field for name in lams}
    with pytest.raises(ValueError, match=match):
        jops.axhelm(jnp.asarray(x), jbasis(3), variant, jnp.asarray(verts),
                    **_jax_kw(kw))
    with pytest.raises(ValueError, match=match):
        tops.axhelm(torch.as_tensor(x), tbasis(3), variant,
                    torch.as_tensor(verts), **_torch_kw(kw))


@pytest.mark.parametrize("variant,helm,lam0_shape,verts_shape,match", [
    ("bogus", False, None, (8, 8, 3), "unknown axhelm variant"),
    ("merged", False, None, (8, 8, 3), "Helmholtz only"),
    ("partial", True, None, (8, 8, 3), "Poisson only"),
    ("trilinear", False, None, (8, 3), "verts must be"),
    ("precomputed", False, (8, 4, 4, 3), (8, 8, 3), "lam0 must be"),
])
def test_setup_validation_matches_reference(variant, helm, lam0_shape,
                                            verts_shape, match):
    """Both entry points raise the reference package's ValueErrors."""
    verts = np.zeros(verts_shape, np.float32)
    lam0 = None if lam0_shape is None else np.ones(lam0_shape, np.float32)
    with pytest.raises(ValueError, match=match):
        jax_axhelm.make_axhelm_elem_ops(
            variant, jbasis(3), jnp.asarray(verts), helmholtz=helm,
            lam0=None if lam0 is None else jnp.asarray(lam0))
    with pytest.raises(ValueError, match=match):
        taxhelm.make_axhelm_elem_ops(
            variant, tbasis(3), torch.as_tensor(verts), helmholtz=helm,
            lam0=None if lam0 is None else torch.as_tensor(lam0))
    with pytest.raises(ValueError, match=match):
        taxhelm.make_axhelm(variant, tbasis(3), verts, helmholtz=helm,
                            lam0=lam0)


def test_backend_resolution():
    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    bf16, cuda = torch.bfloat16, torch.device("cuda")
    n1 = 8                                          # order 7
    assert taxhelm._resolve_backend(None, f32, cpu, n1) == "reference"
    assert taxhelm._resolve_backend("auto", f32, cpu, n1) == "reference"
    assert taxhelm._resolve_backend("auto", f32, cuda, n1) == "cuda"
    assert taxhelm._resolve_backend("auto", bf16, cuda, n1) == "cuda"
    assert taxhelm._resolve_backend("auto", f64, cpu, n1) == "reference"
    # on the card, "auto" never leaves the kernels quietly
    with pytest.raises(ValueError, match="backend='reference'"):
        taxhelm._resolve_backend("auto", f64, cuda, n1)
    assert taxhelm._resolve_backend("reference", f64, cuda, n1) == "reference"
    assert taxhelm._resolve_backend("cuda", f32, cpu, n1) == "cuda"
    assert taxhelm._resolve_backend("cuda", bf16, cpu, n1) == "cuda"
    with pytest.raises(ValueError, match="float32 or bfloat16 only"):
        taxhelm._resolve_backend("cuda", f64, cpu, n1)
    with pytest.raises(ValueError, match="unknown axhelm backend"):
        taxhelm._resolve_backend("pallas", f32, cpu, n1)
