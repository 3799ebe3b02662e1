"""Element geometry: trilinear maps, Jacobians, and geometric factors.

The heart of the paper (Sections 3.2-3.3), on torch tensors:

  * the trilinear element map Phi (Definition 2) and its analytic Jacobian
    (Eq. 14),
  * the low-cost recalculation of geometric factors for trilinear elements
    (Algorithm 3): the shared terms E0/E1/F0/F1 and the (i, j)-invariant
    third Jacobian column are computed once per element and broadcast,
  * the general discrete path (Eq. 12) via sum factorization — what the
    `precomputed` variant stores, and the oracle for the analytic path.

Conventions
-----------
Vertices: ``verts`` has shape (..., 8, 3); vertex ``i`` carries the bit
pattern ``i = br + 2*bs + 4*bt`` where a set bit selects the ``(1 + coord)``
shape-function factor (paper Definition 2 ordering).

Fields: shape (..., N1, N1, N1) with axes (k, j, i); Jacobians are stored
unscaled as ``Jt = 8 * J`` ("J-tilde", the paper's deferred 1/8 scaling) with
``Jt[..., a, b] = 8 * d x_a / d ref_b``.

Basis constants come from numpy (`SpectralBasis`) and are moved to the
dtype and device of the tensor they meet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sumfact
from repro_torch.core.spectral import SpectralBasis

__all__ = [
    "JT_SCALE",
    "GeomFactors",
    "TrilinearTerms",
    "reference_cube",
    "trilinear_map",
    "reference_nodes",
    "node_coords",
    "trilinear_terms",
    "jacobian_trilinear",
    "jacobian_trilinear_at",
    "jacobian_discrete",
    "adjugate6",
    "factors_from_jacobian",
    "factors_trilinear",
    "factors_discrete",
]

# True J = JT_SCALE * Jt for the trilinear analytic path.
JT_SCALE = 0.125


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A numpy basis constant as a tensor in `like`'s dtype and device."""
    return torch.as_tensor(np.ascontiguousarray(a), dtype=like.dtype,
                           device=like.device)


def reference_cube(dtype=torch.float64, device=None) -> torch.Tensor:
    """The [-1, 1]^3 reference element's 8 vertices, (8, 3), in the
    Definition 2 bit order (vertex i = br + 2*bs + 4*bt)."""
    v = np.array([[(i & 1) * 2 - 1, ((i >> 1) & 1) * 2 - 1,
                   ((i >> 2) & 1) * 2 - 1] for i in range(8)], np.float64)
    return torch.as_tensor(v, dtype=dtype, device=device)


class GeomFactors(NamedTuple):
    """The 7 geometric factors of Eq. (11).

    g:   (..., N1, N1, N1, 6) — the symmetric matrix w*|J|*J^-1 J^-T packed
         as [g00, g01, g02, g11, g12, g22].
    gwj: (..., N1, N1, N1)    — the scalar w*|J| (mass-term factor).
    """

    g: torch.Tensor
    gwj: torch.Tensor


class TrilinearTerms(NamedTuple):
    """Shared/invariant terms of Algorithm 3 (per element).

    e0, e1: (..., N1, 3) — J column 0 = e0[j] + xi_k * e1[j]   (unscaled)
    f0, f1: (..., N1, 3) — J column 1 = f0[i] + xi_k * f1[i]   (unscaled)
    jcol2:  (..., N1, N1, 3) — J column 2, depends on (i, j) only (axes j, i).
    """

    e0: torch.Tensor
    e1: torch.Tensor
    f0: torch.Tensor
    f1: torch.Tensor
    jcol2: torch.Tensor


def trilinear_map(verts: torch.Tensor, r, s, t) -> torch.Tensor:
    """Phi(r, s, t) = sum_i sigma_i(r, s, t) v_i  (Definition 2).

    verts: (..., 8, 3); r, s, t broadcastable tensors -> (..., 3).
    """
    r = torch.as_tensor(r, dtype=verts.dtype, device=verts.device)[..., None]
    s = torch.as_tensor(s, dtype=verts.dtype, device=verts.device)[..., None]
    t = torch.as_tensor(t, dtype=verts.dtype, device=verts.device)[..., None]
    out = 0.0
    for idx in range(8):
        br, bs, bt = idx & 1, (idx >> 1) & 1, (idx >> 2) & 1
        sig = (1 + r if br else 1 - r) * (1 + s if bs else 1 - s) * \
              (1 + t if bt else 1 - t)
        out = out + 0.125 * sig * verts[..., idx, :]
    return out


def reference_nodes(basis: SpectralBasis):
    """(r, s, t) numpy grids of shape (N1, N1, N1) in the (k, j, i) order."""
    xi = basis.points
    r = np.broadcast_to(xi[None, None, :], (basis.n1,) * 3)
    s = np.broadcast_to(xi[None, :, None], (basis.n1,) * 3)
    t = np.broadcast_to(xi[:, None, None], (basis.n1,) * 3)
    return r, s, t


def node_coords(verts: torch.Tensor, basis: SpectralBasis) -> torch.Tensor:
    """Physical GLL node coordinates: (..., N1, N1, N1, 3)."""
    r, s, t = reference_nodes(basis)
    v = verts[..., None, None, None, :, :]  # (..., 1, 1, 1, 8, 3)
    return trilinear_map(v, _const(r, verts), _const(s, verts),
                         _const(t, verts))


def trilinear_terms(verts: torch.Tensor, xi: torch.Tensor) -> TrilinearTerms:
    """Precompute E0/E1/F0/F1 and the invariant third column (Alg. 3, L4-13).

    All terms are *unscaled* (factor 8 deferred, paper's gScale trick).
    verts: (..., 8, 3); xi: (N1,) GLL points in verts' dtype and device.
    """
    v = verts
    lo = (1.0 - xi)[..., :, None]  # (N1, 1)
    hi = (1.0 + xi)[..., :, None]

    # d Phi / d r: vertex pairs differing in the r bit, weighted by s factors.
    dr_s0 = v[..., None, 1, :] - v[..., None, 0, :]   # (..., 1, 3)
    dr_s1 = v[..., None, 3, :] - v[..., None, 2, :]
    dr_s0t1 = v[..., None, 5, :] - v[..., None, 4, :]
    dr_s1t1 = v[..., None, 7, :] - v[..., None, 6, :]
    a = lo * dr_s0 + hi * dr_s1          # t = -1 layer, at s = xi_j
    b = lo * dr_s0t1 + hi * dr_s1t1      # t = +1 layer
    e0, e1 = a + b, b - a                # (..., N1, 3), indexed by j

    # d Phi / d s: vertex pairs differing in the s bit, weighted by r factors.
    ds_r0 = v[..., None, 2, :] - v[..., None, 0, :]
    ds_r1 = v[..., None, 3, :] - v[..., None, 1, :]
    ds_r0t1 = v[..., None, 6, :] - v[..., None, 4, :]
    ds_r1t1 = v[..., None, 7, :] - v[..., None, 5, :]
    c = lo * ds_r0 + hi * ds_r1
    d = lo * ds_r0t1 + hi * ds_r1t1
    f0, f1 = c + d, d - c                # (..., N1, 3), indexed by i

    # d Phi / d t: depends on (r, s) = (xi_i, xi_j) only (Alg. 3 L11-13).
    r0 = (1.0 - xi)[None, :, None]       # (1, N1_i, 1)
    r1 = (1.0 + xi)[None, :, None]
    s0 = (1.0 - xi)[:, None, None]       # (N1_j, 1, 1)
    s1 = (1.0 + xi)[:, None, None]
    dt00 = v[..., None, None, 4, :] - v[..., None, None, 0, :]
    dt10 = v[..., None, None, 5, :] - v[..., None, None, 1, :]
    dt01 = v[..., None, None, 6, :] - v[..., None, None, 2, :]
    dt11 = v[..., None, None, 7, :] - v[..., None, None, 3, :]
    jcol2 = r0 * s0 * dt00 + r1 * s0 * dt10 + r1 * s1 * dt11 + r0 * s1 * dt01
    return TrilinearTerms(e0, e1, f0, f1, jcol2)


def jacobian_trilinear_at(verts: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Unscaled analytic Jacobian J~ at every GLL node (Alg. 3 assembly).

    At node (k, j, i):
        Jt[:, 0] = e0[j] + xi_k e1[j]
        Jt[:, 1] = f0[i] + xi_k f1[i]
        Jt[:, 2] = jcol2[j, i]
    verts: (..., 8, 3); xi: (N1,) in verts' dtype and device.
    Returns (..., N1, N1, N1, 3, 3).
    """
    terms = trilinear_terms(verts, xi)
    t = xi[:, None, None, None]                       # (N1_k, 1, 1, 1)
    e0 = terms.e0[..., None, :, None, :]              # (..., 1, N1_j, 1, 3)
    e1 = terms.e1[..., None, :, None, :]
    f0 = terms.f0[..., None, None, :, :]              # (..., 1, 1, N1_i, 3)
    f1 = terms.f1[..., None, None, :, :]
    col0 = e0 + t * e1                                # (..., N1_k, N1_j, 1, 3)
    col1 = f0 + t * f1                                # (..., N1_k, 1, N1_i, 3)
    col2 = terms.jcol2[..., None, :, :, :]            # (..., 1, N1_j, N1_i, 3)
    n1 = xi.shape[0]
    full = verts.shape[:-2] + (n1,) * 3 + (3,)
    return torch.stack([col0.expand(full), col1.expand(full),
                        col2.expand(full)], dim=-1)


def jacobian_trilinear(verts: torch.Tensor, basis: SpectralBasis,
                       unscaled: bool = False) -> torch.Tensor:
    """Analytic Jacobian at every GLL node: (..., N1, N1, N1, 3, 3)."""
    jt = jacobian_trilinear_at(verts, _const(basis.points, verts))
    return jt if unscaled else JT_SCALE * jt


def adjugate6(j: torch.Tensor) -> torch.Tensor:
    """adj(K) of K = j^T j, packed (..., 6): [a00,a01,a02,a11,a12,a22].

    Division- and determinant-free (paper Eq. 17's numerator), written with
    explicit component sums — the same arithmetic the CUDA kernel inlines.
    """
    c0, c1, c2 = j[..., :, 0], j[..., :, 1], j[..., :, 2]

    def dot3(a, b):
        return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
                + a[..., 2] * b[..., 2])

    k00, k01, k02 = dot3(c0, c0), dot3(c0, c1), dot3(c0, c2)
    k11, k12, k22 = dot3(c1, c1), dot3(c1, c2), dot3(c2, c2)
    return torch.stack([
        k11 * k22 - k12 * k12,
        k02 * k12 - k01 * k22,
        k01 * k12 - k02 * k11,
        k00 * k22 - k02 * k02,
        k01 * k02 - k00 * k12,
        k00 * k11 - k01 * k01,
    ], dim=-1)


def jacobian_discrete(coords: torch.Tensor, basis: SpectralBasis) -> torch.Tensor:
    """General (discrete) Jacobian via sum factorization (Eq. 12).

    coords: (..., N1, N1, N1, 3) physical node coordinates.
    Returns true J of shape (..., N1, N1, N1, 3, 3): J[a, b] = D_b coords_a.
    """
    dhat = _const(basis.dhat, coords)
    c = torch.movedim(coords, -1, 0)  # (3, ..., N1, N1, N1)
    jr = sumfact.apply_dr(c, dhat)
    js = sumfact.apply_ds(c, dhat)
    jt = sumfact.apply_dt(c, dhat)
    j = torch.stack([jr, js, jt], dim=-1)      # (3, ..., N1, N1, N1, 3)
    return torch.movedim(j, 0, -2)             # (..., N1, N1, N1, 3, 3)


def factors_from_jacobian(j: torch.Tensor, w3: torch.Tensor,
                          scale: float = 1.0) -> GeomFactors:
    """Geometric factors from (possibly unscaled) Jacobians (Eq. 11/17).

    j:  (..., 3, 3) with true J = scale * j.
    w3: broadcastable GLL weight product w_i w_j w_k.

    Uses K = j^T j and  w |J| J^-1 J^-T = w * scale * adj(K) / det(j)
    (adjugate trick, Eq. 17, with the deferred-scale algebra of Alg. 3).
    """
    det = (j[..., 0, 0] * (j[..., 1, 1] * j[..., 2, 2] - j[..., 2, 1] * j[..., 1, 2])
           - j[..., 1, 0] * (j[..., 0, 1] * j[..., 2, 2] - j[..., 2, 1] * j[..., 0, 2])
           + j[..., 2, 0] * (j[..., 0, 1] * j[..., 1, 2] - j[..., 1, 1] * j[..., 0, 2]))
    gscale = scale * w3 / det
    g = adjugate6(j) * gscale[..., None]
    gwj = w3 * (scale ** 3) * det
    return GeomFactors(g, gwj)


def factors_trilinear(verts: torch.Tensor, basis: SpectralBasis) -> GeomFactors:
    """Algorithm 3: recalculated factors for trilinear elements."""
    jt = jacobian_trilinear(verts, basis, unscaled=True)
    return factors_from_jacobian(jt, _const(basis.w3, verts), scale=JT_SCALE)


def factors_discrete(coords: torch.Tensor, basis: SpectralBasis) -> GeomFactors:
    """General path: factors from the discrete Jacobian (the paper's baseline
    precomputation — what Nekbone stores and the original kernel re-reads)."""
    j = jacobian_discrete(coords, basis)
    return factors_from_jacobian(j, _const(basis.w3, coords))
