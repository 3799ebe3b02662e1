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
