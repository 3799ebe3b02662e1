"""Plain PyTorch versions of the axhelm CUDA kernels.

Shapes follow the kernel convention: x is (E, d, N1, N1, N1) or the
RHS-batched (E, nrhs, d, N1, N1, N1), factors per the variant — one factor
set per element broadcasts over every batch axis.  These reuse the port's
`core` math; the CUDA kernels must agree with them to the fp32 budget
(<= 1e-4 relative) for every shape the wrapper accepts.  They are the
port's one plain axhelm: the CPU path of `ops.axhelm`, the "reference"
backend of `core.axhelm` and `chip_smoke.py`'s comparisons on the card all
run them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import geometry, sumfact


def _batched(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Insert singleton axes after E so a per-element/per-node factor
    broadcasts against x's (E, *batch, N1, N1, N1) layout."""
    return a.reshape(a.shape[:1] + (1,) * (x.ndim - 4) + a.shape[1:])


def _core(x, g, dhat, lam0=None, mass=None):
    """y = D^T (lam0 * G) D x (+ mass * x); factors broadcast over the
    batch axes (d, and nrhs when present)."""
    g = _batched(g, x)          # (E, 1[, 1], N1, N1, N1, 6)
    xr, xs, xt = sumfact.grad_ref(x, dhat)
    gxr = g[..., 0] * xr + g[..., 1] * xs + g[..., 2] * xt
    gxs = g[..., 1] * xr + g[..., 3] * xs + g[..., 4] * xt
    gxt = g[..., 2] * xr + g[..., 4] * xs + g[..., 5] * xt
    if lam0 is not None:
        l0 = _batched(lam0, x)
        gxr, gxs, gxt = l0 * gxr, l0 * gxs, l0 * gxt
    y = sumfact.grad_ref_transpose(gxr, gxs, gxt, dhat)
    if mass is not None:
        y = y + _batched(mass, x) * x
    return y


def axhelm_precomputed(x: torch.Tensor, g: torch.Tensor,
                       gwj: Optional[torch.Tensor], dhat: torch.Tensor,
                       lam0: Optional[torch.Tensor] = None,
                       lam1: Optional[torch.Tensor] = None,
                       helmholtz: bool = False) -> torch.Tensor:
    """Paper Alg. 2 (kernel K1). g: (E, N1,N1,N1, 6); gwj/lam*: (E, N1,N1,N1)."""
    mass = None
    if helmholtz:
        mass = gwj if lam1 is None else lam1 * gwj
    return _core(x, g, dhat, lam0=lam0, mass=mass)


def planar_factors(g: torch.Tensor, gwj: torch.Tensor) -> torch.Tensor:
    """K1's operand: the (E, 7, N1,N1,N1) planes g00, g01, g02, g11, g12,
    g22, gwj of g (E, N1,N1,N1, 6) and gwj (E, N1,N1,N1), contiguous.  An
    element's six G planes are one span of 6 N1^3 values, gwj after them."""
    return torch.cat([g.movedim(-1, 1), gwj[:, None]], dim=1).contiguous()


def factors_of_planes(geom: torch.Tensor):
    """(g (E, N1,N1,N1, 6), gwj (E, N1,N1,N1)) of K1's planar operand, as
    views."""
    return geom[:, :6].movedim(1, -1), geom[:, 6]


def axhelm_trilinear(x: torch.Tensor, verts: torch.Tensor, xi: torch.Tensor,
                     w3: torch.Tensor, dhat: torch.Tensor,
                     lam0: Optional[torch.Tensor] = None,
                     lam1: Optional[torch.Tensor] = None,
                     helmholtz: bool = False) -> torch.Tensor:
    """Paper Alg. 3 (kernel K2), factors recalculated from verts (E, 8, 3)."""
    jt = geometry.jacobian_trilinear_at(verts, xi)
    factors = geometry.factors_from_jacobian(jt, w3, scale=geometry.JT_SCALE)
    return axhelm_precomputed(x, factors.g, factors.gwj, dhat, lam0, lam1,
                              helmholtz)


def axhelm_merged(x: torch.Tensor, verts: torch.Tensor, xi: torch.Tensor,
                  dhat: torch.Tensor, lam2: torch.Tensor,
                  lam3: torch.Tensor) -> torch.Tensor:
    """Paper §4.1.1 (kernel K4, Helmholtz): G = adj(K~)*Lam2, mass = Lam3.

    lam2 = gScale*lambda0 and lam3 = GwJ*lambda1 are precomputed once
    outside the solve (core.axhelm.setup_merged_lambdas).
    """
    adj = geometry.adjugate6(geometry.jacobian_trilinear_at(verts, xi))
    return _core(x, adj * lam2[..., None], dhat, mass=lam3)


def axhelm_partial(x: torch.Tensor, verts: torch.Tensor, xi: torch.Tensor,
                   dhat: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """Paper §4.1.2 (kernel K5, Poisson): recompute adj(K~), re-read
    gScale = w3/(8 det) (core.axhelm.setup_partial_gscale)."""
    adj = geometry.adjugate6(geometry.jacobian_trilinear_at(verts, xi))
    return _core(x, adj * gscale[..., None], dhat)


def axhelm_parallelepiped(x: torch.Tensor, gelem: torch.Tensor,
                          w3: torch.Tensor, dhat: torch.Tensor,
                          lam0: Optional[torch.Tensor] = None,
                          lam1: Optional[torch.Tensor] = None,
                          helmholtz: bool = False) -> torch.Tensor:
    """Paper Alg. 4 (kernel K3). gelem: (E, 7) = [adjK/det x6, det]
    (unweighted); the node's factors are gelem times its weight w3."""
    g = gelem[:, None, None, None, :6] * w3[None, ..., None]
    gwj = gelem[:, None, None, None, 6] * w3[None]
    return axhelm_precomputed(x, g, gwj, dhat, lam0, lam1, helmholtz)


def gelem_from_verts(verts: torch.Tensor) -> torch.Tensor:
    """The 7 per-element scalars of Algorithm 4 from vertices: (E, 7)."""
    j = geometry.jacobian_parallelepiped(verts)
    f = geometry.factors_from_jacobian(
        j, torch.ones((), dtype=verts.dtype, device=verts.device))
    return torch.cat([f.g, f.gwj[..., None]], dim=-1)
