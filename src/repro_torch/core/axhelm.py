"""The axhelm operator: element-local Y^(e) = A^(e) X^(e).

A^(e) = D^T [lam0 * G] D  (+ Helmholtz: + diag(lam1 * Gwj)), applied matrix-
free by sum factorization.  The variants differ ONLY in where the geometric
factors come from — the paper's central idea.  Ported so far:

  precomputed     paper Alg. 2 — read 6(+1) factor arrays from memory
                  (the original Nekbone/NekRS kernel, the baseline).
  trilinear       paper Alg. 3 — 24 scalars (8 vertices) per element,
                  low-cost analytic recalculation at every node.

`parallelepiped`, `merged` and `partial` raise NotImplementedError until
their kernels are ported (ROADMAP.md, Queue 2).

Shapes: x is (E, N1, N1, N1) for a scalar field (d = 1),
(E, d, N1, N1, N1) for a vector field, or (E, nrhs, d, N1, N1, N1) for an
RHS batch; factors broadcast over the batch axes.

Backends: "reference" (plain torch, any dtype and device), "cuda" (the
hand-written kernels through `kernels.axhelm.ops`, which runs their plain
versions on CPU tensors), and "auto" — "cuda" for float32 on a CUDA
device, "reference" on the CPU; any other dtype on a CUDA device raises
rather than leaving the kernels quietly.  Both backends take the same
operands and share one plain version, `kernels/axhelm/ref.py`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import geometry
from repro_torch.core.geometry import GeomFactors
from repro_torch.core.spectral import SpectralBasis
from repro_torch.kernels.axhelm import ops as kops
from repro_torch.kernels.axhelm import ref as kref

__all__ = [
    "VARIANTS",
    "BACKENDS",
    "AxhelmOp",
    "axhelm_precomputed",
    "axhelm_trilinear",
    "element_diagonal",
    "make_axhelm",
    "make_axhelm_elem_ops",
]

VARIANTS = ("precomputed", "trilinear", "parallelepiped", "merged", "partial")
BACKENDS = ("reference", "cuda", "auto")


def axhelm_precomputed(x: torch.Tensor, factors: GeomFactors,
                       dhat: torch.Tensor,
                       lam0: Optional[torch.Tensor] = None,
                       lam1: Optional[torch.Tensor] = None,
                       helmholtz: bool = False) -> torch.Tensor:
    """Paper Algorithm 2: factors read from (pre-assembled) arrays.  The
    contraction is the kernels' plain version (`kref._core`)."""
    return kref.axhelm_precomputed(x, factors.g, factors.gwj, dhat, lam0,
                                   lam1, helmholtz)


def axhelm_trilinear(x: torch.Tensor, verts: torch.Tensor,
                     basis: SpectralBasis, dhat: torch.Tensor,
                     lam0: Optional[torch.Tensor] = None,
                     lam1: Optional[torch.Tensor] = None,
                     helmholtz: bool = False) -> torch.Tensor:
    """Paper Algorithm 3: on-the-fly analytic recalculation (trilinear)."""
    factors = geometry.factors_trilinear(verts, basis)
    return axhelm_precomputed(x, factors, dhat, lam0, lam1, helmholtz)


def element_diagonal(factors: GeomFactors, dhat: torch.Tensor,
                     lam0: Optional[torch.Tensor] = None,
                     lam1: Optional[torch.Tensor] = None,
                     helmholtz: bool = False) -> torch.Tensor:
    """Closed-form diag(A^(e)) via sum factorization (for Jacobi/PCG).

    diag(kji) = sum_m Dhat(m,i)^2 g'00(k,j,m) + sum_m Dhat(m,j)^2 g'11(k,m,i)
              + sum_m Dhat(m,k)^2 g'22(m,j,i)
              + 2 Dhat(i,i) Dhat(j,j) g'01 + 2 Dhat(i,i) Dhat(k,k) g'02
              + 2 Dhat(j,j) Dhat(k,k) g'12   (all at (k,j,i))
              (+ lam1 * gwj for Helmholtz),
    with g' = lam0 * g — lam0 lives INSIDE the contraction (it is evaluated
    at the summation node, not at the diagonal node).
    """
    g = factors.g
    if lam0 is not None:
        g = g * lam0[..., None]
    d2 = dhat * dhat
    dd = torch.diagonal(dhat)
    diag = torch.einsum("mi,...m->...i", d2, g[..., 0])
    diag = diag + torch.einsum("mj,...mi->...ji", d2, g[..., 3])
    diag = diag + torch.einsum("mk,...mji->...kji", d2, g[..., 5])
    di = dd[None, None, :]
    dj = dd[None, :, None]
    dk = dd[:, None, None]
    diag = diag + 2.0 * (di * dj * g[..., 1] + di * dk * g[..., 2]
                         + dj * dk * g[..., 4])
    if helmholtz:
        diag = diag + (factors.gwj if lam1 is None else lam1 * factors.gwj)
    return diag


class AxhelmOp(NamedTuple):
    """A ready-to-apply element operator plus its setup products."""

    apply: Callable[[torch.Tensor], torch.Tensor]
    factors: Optional[GeomFactors]
    variant: str
    helmholtz: bool
    backend: str = "reference"


def _resolve_backend(backend: Optional[str], dtype: torch.dtype,
                     device: torch.device) -> str:
    """Map a backend choice to a concrete implementation.

    None means "auto".  "auto" picks the CUDA kernels on a CUDA device and
    the plain reference on the CPU.  The kernels take float32 only, so
    another dtype raises for "cuda", and for "auto" on a CUDA device: the
    plain version runs on the card only when the caller asks for it.  On
    a CPU device "cuda" runs the kernels' plain versions.
    """
    if backend is None:
        backend = "auto"
    if backend not in BACKENDS:
        raise ValueError(f"unknown axhelm backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "auto":
        backend = "cuda" if torch.device(device).type == "cuda" \
            else "reference"
        if backend == "cuda" and dtype != torch.float32:
            raise ValueError(
                f"axhelm backend 'auto' on a CUDA device runs the float32 "
                f"kernels; got dtype {dtype} (pass backend='reference' to "
                f"run the plain version on the card)")
    elif backend == "cuda" and dtype != torch.float32:
        raise ValueError(f"axhelm backend 'cuda' computes in float32 only; "
                         f"got dtype {dtype} (use backend='reference')")
    return backend


def _validate_setup(variant: str, basis: SpectralBasis, verts, lam0, lam1,
                    helmholtz: bool) -> None:
    """Shared argument validation for BOTH axhelm entry points, with the
    reference package's errors; variants without a kernel yet raise
    NotImplementedError."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown axhelm variant {variant!r}; expected one "
                         f"of {VARIANTS}")
    if variant == "merged" and not helmholtz:
        raise ValueError("merged scalar factors apply to Helmholtz only")
    if variant == "partial" and helmholtz:
        raise ValueError("partial recalculation applies to Poisson only")
    shape = tuple(verts.shape)
    if len(shape) != 3 or shape[-2:] != (8, 3):
        raise ValueError(
            f"axhelm setup: verts must be (E, 8, 3) trilinear element "
            f"vertices, got shape {shape}")
    node_shape = shape[:-2] + (basis.n1,) * 3
    for name, lam in (("lam0", lam0), ("lam1", lam1)):
        if lam is None or getattr(lam, "ndim", 0) == 0:
            continue
        if tuple(lam.shape) != node_shape:
            raise ValueError(
                f"axhelm setup: {name} must be a scalar or a per-node "
                f"(E, N1, N1, N1) field of shape {node_shape}, got "
                f"{tuple(lam.shape)}")
    kops.check_variant(variant)


def _setup_factors(variant: str, basis: SpectralBasis, verts,
                   elem_ops) -> GeomFactors:
    """The `GeomFactors` carried on `AxhelmOp` (for the Jacobi diagonal):
    the precomputed variant's packed [g6, gwj] operand already holds them."""
    if variant == "precomputed":
        geom = elem_ops["geom"]
        return GeomFactors(geom[..., :6], geom[..., 6])
    return geometry.factors_trilinear(verts, basis)


def make_axhelm(variant: str, basis: SpectralBasis, verts,
                coords: Optional[torch.Tensor] = None,
                lam0=None, lam1=None,
                helmholtz: bool = False,
                dtype: torch.dtype = torch.float64,
                backend: Optional[str] = None,
                device=None) -> AxhelmOp:
    """Build an axhelm closure for a mesh (one-time setup outside the solve).

    A thin closure over :func:`make_axhelm_elem_ops`, so both entry points
    share one validation and operand-assembly path.  `verts` may be numpy
    or a tensor; it is moved to `device` (default: verts' own device) in
    `dtype`.  `coords` (physical node coordinates) feeds the `precomputed`
    factors; for trilinear meshes it is derived from verts.
    """
    verts = torch.as_tensor(verts, dtype=dtype, device=device)
    elem_ops, elem_apply, backend_used = make_axhelm_elem_ops(
        variant, basis, verts, lam0=lam0, lam1=lam1, helmholtz=helmholtz,
        dtype=dtype, backend=backend, coords=coords, device=device)
    factors = _setup_factors(variant, basis, verts, elem_ops)

    def apply(x):
        return elem_apply(x, elem_ops)

    return AxhelmOp(apply, factors, variant, helmholtz, backend_used)


def make_axhelm_elem_ops(variant: str, basis: SpectralBasis, verts,
                         lam0=None, lam1=None,
                         helmholtz: bool = False,
                         dtype: torch.dtype = torch.float32,
                         backend: Optional[str] = None,
                         coords: Optional[torch.Tensor] = None,
                         device=None):
    """Operand-style axhelm: `(elem_ops, apply, backend)` with
    apply(x, elem_ops).

    The per-element setup products (factors, vertices, per-node lambda
    fields) are returned as a dict of tensors with a leading element axis
    instead of being closed over, so they can be handed in from elsewhere
    (see `repro_torch.convert.elem_ops_from_numpy`).  The basis stays
    closed over.  `apply` accepts scalar, vector and RHS-batched fields on
    both backends.

    elem_ops keys, the same for both backends: "geom" (the
    (E, N1,N1,N1, 7) packed [g6, gwj] factors for precomputed, the (E, 8, 3)
    vertices for trilinear) plus "lam0"/"lam1" as contiguous per-node
    fields, scalars broadcast.  A lambda missing from the elem_ops handed
    to `apply` falls back to the one given here.
    """
    _validate_setup(variant, basis, verts, lam0, lam1, helmholtz)
    verts = torch.as_tensor(verts, dtype=dtype, device=device)
    device = verts.device
    backend = _resolve_backend(backend, dtype, device)
    node_shape = tuple(verts.shape[:-2]) + (basis.n1,) * 3

    if variant == "precomputed":
        if coords is None:
            coords = geometry.node_coords(verts, basis)
        coords = torch.as_tensor(coords, dtype=dtype, device=device)
        factors = geometry.factors_discrete(coords, basis)
        geom = torch.cat([factors.g, factors.gwj[..., None]], dim=-1)
    else:  # trilinear
        geom = verts
    # the kernels take per-node lambda fields only: scalars broadcast
    lams = {name: torch.as_tensor(lam, dtype=dtype, device=device)
            .expand(node_shape).contiguous()
            for name, lam in (("lam0", lam0), ("lam1", lam1))
            if lam is not None}
    elem_ops = {"geom": geom.contiguous(), **lams}
    element_op = kops.axhelm if backend == "cuda" else kops.reference

    def apply(x, elem_ops):
        return element_op(x.contiguous(), basis, variant, elem_ops["geom"],
                          lam0=elem_ops.get("lam0", lams.get("lam0")),
                          lam1=elem_ops.get("lam1", lams.get("lam1")),
                          helmholtz=helmholtz)
    return elem_ops, apply, backend
