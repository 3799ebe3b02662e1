"""Port parity, the axhelm operator: the port's kernels (their plain versions
on the CPU, through `repro_torch.kernels.axhelm.ops.axhelm`) against the
reference package's Pallas kernel — run in interpret mode on the CPU, as
tests/test_kernels_axhelm.py runs it — and against its pure-jnp oracle.

Tolerance: <= 1e-4 relative (max-norm), float32 — the budget of
kernels/axhelm/DESIGN.md §7; the two packages contract in different orders.
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
from repro_torch import convert
from repro_torch.core import axhelm as taxhelm
from repro_torch.core.spectral import basis as tbasis
from repro_torch.kernels.axhelm import ops as tops

RTOL32 = 1e-4
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


def _verts(n):
    mesh = jmesh.deform_trilinear(jmesh.box_mesh(2, 2, 2, n), seed=1)
    return mesh.verts.astype(np.float32)                       # E = 8


def _geom(variant, n):
    verts = _verts(n)
    if variant == "trilinear":
        return verts
    b = jbasis(n)
    jv = jnp.asarray(verts)
    f = jgeom.factors_discrete(jgeom.node_coords(jv, b), b)
    # float32 whatever the x64 mode other tests left on: the node grid is
    # a float64 numpy constant and would promote the factors
    return np.array(jnp.concatenate([f.g, f.gwj[..., None]], axis=-1),
                    dtype=np.float32)


def _inputs(variant, n, coeff):
    """x (E, 2, 3, N1^3), geom and the lambda kwargs, all numpy float32."""
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


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("coeff", COEFFS)
@pytest.mark.parametrize("variant", ["precomputed", "trilinear"])
@pytest.mark.parametrize("n", [3, 7])
def test_kernel_plain_version_matches_pallas(n, variant, coeff, layout):
    x, geom, kw = _inputs(variant, n, coeff)
    idx = LAYOUTS[layout]
    y_pallas, y_oracle = (y[idx] for y in _jax_outputs(variant, n, coeff))
    y = tops.axhelm(torch.as_tensor(np.ascontiguousarray(x[idx])),
                    tbasis(n), variant, torch.as_tensor(geom),
                    **_torch_kw(kw))
    assert tuple(y.shape) == x[idx].shape
    assert _rel(y, y_pallas) <= RTOL32
    assert _rel(y, y_oracle) <= RTOL32
    y_plain = tops.reference(torch.as_tensor(np.ascontiguousarray(x[idx])),
                             tbasis(n), variant, torch.as_tensor(geom),
                             **_torch_kw(kw))
    assert torch.equal(y, y_plain)


@pytest.mark.parametrize("variant", ["precomputed", "trilinear"])
def test_public_layouts_agree(variant):
    """(E, N1^3) and (E, 1, 1, N1^3), and (E, d, N1^3) and
    (E, 1, d, N1^3), are the same field: the same y, bit for bit."""
    x, geom, kw = _inputs(variant, 3, "helmholtz")
    b, g, kw = tbasis(3), torch.as_tensor(geom), _torch_kw(kw)
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
@pytest.mark.parametrize("variant", ["precomputed", "trilinear"])
def test_elem_ops_carried_across(variant, coeff, jax_backend, port_backend):
    """The reference package's setup products, carried into the port with
    `convert.elem_ops_from_numpy`, drive the port's element operator to the
    reference package's y; the port's own setup gives the same y."""
    n = 3
    x, _, kw = _inputs(variant, n, coeff)
    verts = _verts(n)
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


@pytest.mark.parametrize("layout", ["scalar", "vector", "batched"])
@pytest.mark.parametrize("coeff", COEFFS)
@pytest.mark.parametrize("variant", ["precomputed", "trilinear"])
def test_core_operator_matches_reference(variant, coeff, layout):
    """`core.axhelm.axhelm_precomputed`/`axhelm_trilinear` (Alg. 2/3 on
    GeomFactors and vertices, run by the shared plain version) against the
    reference package's functions of the same name."""
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
    else:
        y_jax = jax_axhelm.axhelm_trilinear(
            jnp.asarray(xl), jnp.asarray(geom), jb, jdhat, helmholtz=helm,
            **_jax_kw(kw))
        y = taxhelm.axhelm_trilinear(
            torch.as_tensor(xl), torch.as_tensor(geom), tb, tdhat,
            helmholtz=helm, **_torch_kw(kw))
    assert tuple(y.shape) == xl.shape
    assert _rel(y, y_jax) <= RTOL32


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


@pytest.mark.parametrize("variant,helm", [("parallelepiped", False),
                                          ("merged", True),
                                          ("partial", False)])
def test_unported_variants_raise(variant, helm):
    verts = torch.as_tensor(_verts(3))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        taxhelm.make_axhelm_elem_ops(variant, tbasis(3), verts,
                                     helmholtz=helm)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.axhelm(torch.zeros(8, 4, 4, 4), tbasis(3), variant, verts)


def test_backend_resolution():
    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    assert taxhelm._resolve_backend(None, f32, cpu) == "reference"
    assert taxhelm._resolve_backend("auto", f32, cpu) == "reference"
    assert taxhelm._resolve_backend("auto", f32, torch.device("cuda")) \
        == "cuda"
    assert taxhelm._resolve_backend("auto", f64, cpu) == "reference"
    # on the card, "auto" never leaves the kernels quietly
    with pytest.raises(ValueError, match="backend='reference'"):
        taxhelm._resolve_backend("auto", f64, torch.device("cuda"))
    assert taxhelm._resolve_backend("reference", f64,
                                    torch.device("cuda")) == "reference"
    assert taxhelm._resolve_backend("cuda", f32, cpu) == "cuda"
    with pytest.raises(ValueError, match="float32 only"):
        taxhelm._resolve_backend("cuda", f64, cpu)
    with pytest.raises(ValueError, match="unknown axhelm backend"):
        taxhelm._resolve_backend("pallas", f32, cpu)
