"""Port parity, setup math: spectral basis, mesh generation, sum
factorization and element geometry of `repro_torch` against the JAX
reference on the same numpy inputs.

Tolerance: <= 1e-12 relative (max-norm) in float64 — the two packages run
the same formulas, so only the order of floating-point operations differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeom
from repro.core import mesh_gen as jmesh
from repro.core import spectral as jspec
from repro.core import sumfact as jsum
from repro_torch import convert
from repro_torch.core import geometry as tgeom
from repro_torch.core import mesh_gen as tmesh
from repro_torch.core import spectral as tspec
from repro_torch.core import sumfact as tsum
from _torch_x64 import x64  # noqa: F401

RTOL64 = 1e-12


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.max(np.abs(b))
    return float(np.max(np.abs(a - b)) / (scale if scale > 0 else 1.0))


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64))


def _random_verts(seed, n_elems=3, amp=0.15):
    base = jmesh.box_mesh(1, 1, 1, 2).verts[0]
    rng = np.random.default_rng(seed)
    return base[None] + amp * rng.standard_normal((n_elems, 8, 3))


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_spectral_matches_reference(n):
    jb, tb = jspec.basis(n), tspec.basis(n)
    for name in ("points", "weights", "dhat", "w3"):
        assert _rel(getattr(tb, name), getattr(jb, name)) <= RTOL64, name
    x = np.linspace(-1.0, 1.0, 11)
    assert _rel(tspec.legendre(n, x), jspec.legendre(n, x)) <= RTOL64
    assert _rel(tspec.legendre_deriv(n, x),
                jspec.legendre_deriv(n, x)) <= RTOL64


@pytest.mark.parametrize("shape,order", [((2, 2, 2), 3), ((3, 2, 1), 4),
                                         ((2, 1, 3), 7)])
def test_mesh_matches_reference(shape, order):
    jm, tm = jmesh.box_mesh(*shape, order), tmesh.box_mesh(*shape, order)
    np.testing.assert_array_equal(tm.global_ids, jm.global_ids)
    np.testing.assert_array_equal(tm.boundary, jm.boundary)
    assert (tm.n_global, tm.shape, tm.order) == (jm.n_global, jm.shape,
                                                 jm.order)
    assert _rel(tm.verts, jm.verts) <= RTOL64
    jw = jmesh.deform_trilinear(jm, seed=3)
    tw = tmesh.deform_trilinear(tm, seed=3)
    assert _rel(tw.verts, jw.verts) <= RTOL64
    ja = jmesh.deform_affine(jm, seed=2)
    ta = tmesh.deform_affine(tm, seed=2)
    assert _rel(ta.verts, ja.verts) <= RTOL64
    carried = convert.mesh_from_numpy(jw)
    np.testing.assert_array_equal(carried.global_ids, jw.global_ids)
    np.testing.assert_array_equal(carried.verts, jw.verts)
    assert carried.n_global == jw.n_global


@pytest.mark.parametrize("n", [2, 3, 7])
def test_sumfact_matches_reference(x64, n):
    rng = np.random.default_rng(n)
    dhat = jspec.basis(n).dhat
    x = rng.standard_normal((2, 3, n + 1, n + 1, n + 1))
    jd, td = jnp.asarray(dhat), _t(dhat)
    jx, tx = jnp.asarray(x), _t(x)
    for fname in ("apply_dr", "apply_ds", "apply_dt"):
        assert _rel(getattr(tsum, fname)(tx, td),
                    getattr(jsum, fname)(jx, jd)) <= RTOL64, fname
    g = [rng.standard_normal(x.shape) for _ in range(3)]
    assert _rel(tsum.grad_ref_transpose(*map(_t, g), td),
                jsum.grad_ref_transpose(*map(jnp.asarray, g), jd)) <= RTOL64


def test_sumfact_bf16_accumulates_in_fp32():
    """Sub-fp32 inputs contract in fp32 and round once, in both packages:
    the bf16 results agree to one bf16 rounding (2^-8 relative)."""
    rng = np.random.default_rng(0)
    dhat = jspec.basis(7).dhat.astype(np.float32)
    x = rng.standard_normal((4, 8, 8, 8)).astype(np.float32)
    jy = jsum.apply_ds(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(dhat, jnp.bfloat16))
    ty = tsum.apply_ds(torch.as_tensor(x).bfloat16(),
                       torch.as_tensor(dhat).bfloat16())
    assert ty.dtype == torch.bfloat16
    assert _rel(ty.float(), np.asarray(jy, np.float32)) <= 2.0 ** -8


@pytest.mark.parametrize("n", [2, 3, 7])
def test_geometry_matches_reference(x64, n):
    jb, tb = jspec.basis(n), tspec.basis(n)
    v = _random_verts(n)
    jv, tv = jnp.asarray(v), _t(v)
    xi = jb.points
    jt_terms = jgeom.trilinear_terms(jv, jnp.asarray(xi))
    tt_terms = tgeom.trilinear_terms(tv, _t(xi))
    for name in jt_terms._fields:
        assert _rel(getattr(tt_terms, name),
                    getattr(jt_terms, name)) <= RTOL64, name
    assert _rel(tgeom.jacobian_trilinear_at(tv, _t(xi)),
                jgeom.jacobian_trilinear_at(jv, jnp.asarray(xi))) <= RTOL64
    for unscaled in (False, True):
        assert _rel(tgeom.jacobian_trilinear(tv, tb, unscaled),
                    jgeom.jacobian_trilinear(jv, jb, unscaled)) <= RTOL64
    jc, tc = jgeom.node_coords(jv, jb), tgeom.node_coords(tv, tb)
    assert _rel(tc, jc) <= RTOL64
    jj, tj = jgeom.jacobian_discrete(jc, jb), tgeom.jacobian_discrete(tc, tb)
    assert _rel(tj, jj) <= RTOL64
    assert _rel(tgeom.adjugate6(tj), jgeom.adjugate6(jj)) <= RTOL64
    for jf, tf in ((jgeom.factors_trilinear(jv, jb),
                    tgeom.factors_trilinear(tv, tb)),
                   (jgeom.factors_discrete(jc, jb),
                    tgeom.factors_discrete(tc, tb)),
                   (jgeom.factors_from_jacobian(jj, jnp.asarray(jb.w3)),
                    tgeom.factors_from_jacobian(tj, _t(jb.w3)))):
        assert _rel(tf.g, jf.g) <= RTOL64
        assert _rel(tf.gwj, jf.gwj) <= RTOL64
    assert _rel(tgeom.reference_cube(), jgeom.reference_cube(jnp.float64)) \
        <= RTOL64
    assert tgeom.JT_SCALE == jgeom.JT_SCALE


@pytest.mark.parametrize("n", [2, 3, 7])
def test_parallelepiped_geometry_matches_reference(x64, n):
    """Alg. 4's constant Jacobian, its weighted factors and the
    parallelepiped test, on an affine mesh and on perturbed vertices."""
    jb, tb = jspec.basis(n), tspec.basis(n)
    affine = jmesh.deform_affine(jmesh.box_mesh(2, 1, 2, n), seed=2).verts
    for v in (affine, _random_verts(n)):
        jv, tv = jnp.asarray(v), _t(v)
        assert _rel(tgeom.jacobian_parallelepiped(tv),
                    jgeom.jacobian_parallelepiped(jv)) <= RTOL64
        jf, tf = jgeom.factors_parallelepiped(jv, jb), \
            tgeom.factors_parallelepiped(tv, tb)
        assert _rel(tf.g, jf.g) <= RTOL64
        assert _rel(tf.gwj, jf.gwj) <= RTOL64
        np.testing.assert_array_equal(tgeom.is_parallelepiped(tv).numpy(),
                                      np.asarray(jgeom.is_parallelepiped(jv)))
    assert bool(tgeom.is_parallelepiped(_t(affine)).all())
    assert not bool(tgeom.is_parallelepiped(_t(_random_verts(n))).any())
