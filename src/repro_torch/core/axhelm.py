"""The axhelm operator: element-local Y^(e) = A^(e) X^(e).

A^(e) = D^T [lam0 * G] D  (+ Helmholtz: + diag(lam1 * Gwj)), applied matrix-
free by sum factorization.  The variants differ ONLY in where the geometric
factors come from — the paper's central idea:

  precomputed     paper Alg. 2 — read 6(+1) factor arrays from memory
                  (the original Nekbone/NekRS kernel, the baseline).
  parallelepiped  paper Alg. 4 — 7 scalars per *element*, zero-cost recalc.
  trilinear       paper Alg. 3 — 24 scalars (8 vertices) per element,
                  low-cost analytic recalculation at every node.
  merged          paper §4.1.1 (Helmholtz) — trilinear recalc with gScale/gwj
                  folded into the lambda fields (Lam2, Lam3): no division,
                  no determinant in the hot loop.
  partial         paper §4.1.2 (Poisson) — trilinear recalc of adj(K) only;
                  gScale (containing the division) is re-read from memory.

Shapes: x is (E, N1, N1, N1) for a scalar field (d = 1),
(E, d, N1, N1, N1) for a vector field, or (E, nrhs, d, N1, N1, N1) for an
RHS batch; factors broadcast over the batch axes.

Backends: "reference" (plain torch, any dtype and device), "cuda" (the
hand-written kernels through `kernels.axhelm.ops`, which runs their plain
versions on CPU tensors), and "auto" — "cuda" for float32 and bfloat16 on
a CUDA device, "reference" on the CPU; float64 on a CUDA device raises at
setup rather than leaving the kernels quietly.  The kernels run orders up
to `N1_STAGED_MAX - 1` (orders `N1_MAX` to `N1_PLANE_MAX - 1` through the
plane body, above that through the staged body).  Both backends take the same operands and share one plain version,
`kernels/axhelm/ref.py`.

bfloat16 is a storage type: the operator computes in float32 and rounds its
output once (the reference's Pallas kernel semantics), and the setup
products are computed in float32 from the bf16-rounded vertices and
lambdas and rounded once (see `make_axhelm_elem_ops`).
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
    "axhelm_parallelepiped",
    "axhelm_merged",
    "axhelm_partial",
    "setup_merged_lambdas",
    "setup_partial_gscale",
    "element_diagonal",
    "make_axhelm",
    "make_axhelm_elem_ops",
    "setup_factors",
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


def axhelm_parallelepiped(x: torch.Tensor, verts: torch.Tensor,
                          basis: SpectralBasis, dhat: torch.Tensor,
                          lam0: Optional[torch.Tensor] = None,
                          lam1: Optional[torch.Tensor] = None,
                          helmholtz: bool = False) -> torch.Tensor:
    """Paper Algorithm 4: constant-J elements, 7 scalars per element."""
    factors = geometry.factors_parallelepiped(verts, basis)
    return axhelm_precomputed(x, factors, dhat, lam0, lam1, helmholtz)


def _weights_and_det(verts: torch.Tensor, basis: SpectralBasis):
    """w3 and det(J~) of the unscaled trilinear Jacobian at every node."""
    jt = geometry.jacobian_trilinear(verts, basis, unscaled=True)
    w3 = torch.as_tensor(basis.w3, dtype=verts.dtype, device=verts.device)
    return w3, geometry.det3(jt)


def setup_merged_lambdas(verts: torch.Tensor, basis: SpectralBasis,
                         lam0: torch.Tensor, lam1: torch.Tensor):
    """Precompute Lam2 = gScale*lam0 and Lam3 = gwj*lam1 (paper §4.1.1).

    Done once before the solve; the hot kernel then avoids the determinant
    and the division entirely.
    """
    w3, det = _weights_and_det(verts, basis)
    gscale = geometry.JT_SCALE * w3 / det
    gwj = (geometry.JT_SCALE ** 3) * w3 * det
    return gscale * lam0, gwj * lam1


def setup_partial_gscale(verts: torch.Tensor,
                         basis: SpectralBasis) -> torch.Tensor:
    """Precompute gScale = w3/(8 det(Jt)) for partial recalculation (§4.1.2)."""
    w3, det = _weights_and_det(verts, basis)
    return geometry.JT_SCALE * w3 / det


def _points(basis: SpectralBasis, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(basis.points, dtype=like.dtype, device=like.device)


def axhelm_merged(x: torch.Tensor, verts: torch.Tensor, basis: SpectralBasis,
                  dhat: torch.Tensor, lam2: torch.Tensor,
                  lam3: torch.Tensor) -> torch.Tensor:
    """Paper §4.1.1 (Helmholtz): G = adj(K~) * Lam2, mass = Lam3 — the
    division-free half of Algorithm 3, run by the kernel's plain version."""
    return kref.axhelm_merged(x, verts, _points(basis, verts), dhat, lam2,
                              lam3)


def axhelm_partial(x: torch.Tensor, verts: torch.Tensor, basis: SpectralBasis,
                   dhat: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """Paper §4.1.2 (Poisson): recompute adj(K~), re-read gScale from memory
    (the kernel's plain version)."""
    return kref.axhelm_partial(x, verts, _points(basis, verts), dhat, gscale)


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
                     device: torch.device, n1: int) -> str:
    """Map a backend choice to a concrete implementation.

    None means "auto".  "auto" picks the CUDA kernels on a CUDA device and
    the plain reference on the CPU.  The kernels store float32 or bfloat16,
    so another dtype raises for "cuda", and for "auto" on a CUDA device:
    the plain version runs on the card only when the caller asks for it.
    On a CPU device "cuda" runs the kernels' plain versions.  The kernels
    run N1 = order + 1 up to `kops.N1_STAGED_MAX` (above `kops.N1_MAX`
    through the plane body, above `kops.N1_PLANE_MAX` through the staged
    body): a larger `n1` raises for "auto" and "cuda" on a CUDA
    device.
    """
    if backend is None:
        backend = "auto"
    if backend not in BACKENDS:
        raise ValueError(f"unknown axhelm backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "auto":
        backend = "cuda" if torch.device(device).type == "cuda" \
            else "reference"
        if backend == "cuda" and dtype not in kops.KERNEL_DTYPES:
            raise ValueError(
                f"axhelm backend 'auto' on a CUDA device runs the float32 "
                f"or bfloat16 kernels; got dtype {dtype} (pass "
                f"backend='reference' to run the plain version on the card)")
    elif backend == "cuda" and dtype not in kops.KERNEL_DTYPES:
        raise ValueError(f"axhelm backend 'cuda' stores float32 or bfloat16 "
                         f"only; got dtype {dtype} (use backend='reference')")
    if backend == "cuda" and torch.device(device).type == "cuda" \
            and n1 > kops.N1_STAGED_MAX:
        raise ValueError(
            f"the axhelm CUDA kernels run orders up to "
            f"{kops.N1_STAGED_MAX - 1} (N1_STAGED_MAX = "
            f"{kops.N1_STAGED_MAX}: the staged body's panel of a larger "
            f"element does not fit in a block's shared memory); got order "
            f"{n1 - 1} (pass backend='reference' to run the plain version on "
            f"the card)")
    return backend


def _validate_setup(variant: str, basis: SpectralBasis, verts, lam0, lam1,
                    helmholtz: bool) -> None:
    """Shared argument validation for BOTH axhelm entry points, with the
    reference package's errors."""
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


def setup_factors(variant: str, basis: SpectralBasis, verts,
                  dtype: torch.dtype, elem_ops=None) -> GeomFactors:
    """The `GeomFactors` of `variant` that `AxhelmOp` carries for the
    Jacobi diagonal: computed in the setup dtype from `verts` rounded to
    `dtype`, then rounded to `dtype` once.  The precomputed variant reads
    them from the planar [g6, gwj] operand of `elem_ops` when given;
    merged and partial share the trilinear factors."""
    verts = torch.as_tensor(verts, dtype=dtype).to(_setup_dtype(dtype))
    if variant == "precomputed" and elem_ops is not None:
        factors = GeomFactors(*kref.factors_of_planes(elem_ops["geom"]))
    elif variant == "precomputed":
        factors = geometry.factors_discrete(
            geometry.node_coords(verts, basis), basis)
    elif variant == "parallelepiped":
        factors = geometry.factors_parallelepiped(verts, basis)
    else:
        factors = geometry.factors_trilinear(verts, basis)
    return GeomFactors(factors.g.to(dtype), factors.gwj.to(dtype))


def _setup_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype setup products are computed in: float32 for a sub-fp32
    storage dtype (then rounded once), the storage dtype otherwise."""
    return torch.float32 if torch.finfo(dtype).bits < 32 else dtype


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
    factors = setup_factors(variant, basis, verts, dtype, elem_ops)

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

    elem_ops keys, the same for both backends, are the kernel's operands:

      precomputed     geom = (E, 7, N1,N1,N1) planes [g6, gwj]
                      (`kref.planar_factors`); lam0/lam1
      trilinear       geom = (E, 8, 3) vertices; lam0/lam1
      parallelepiped  geom = (E, 7) `gelem_from_verts`; lam0/lam1
      merged          geom = vertices; lam0 = Lam2, lam1 = Lam3
                      (`setup_merged_lambdas`, a missing lambda is 1)
      partial         geom = vertices; lam0 = gScale
                      (`setup_partial_gscale`; lam0/lam1 are not read)

    Lambdas are contiguous per-node fields, scalars broadcast.  A lambda
    slot missing from the elem_ops handed to `apply` falls back to the
    one assembled here — Lam2/Lam3 and gScale for merged and partial.

    With a bfloat16 `dtype` every setup product is computed in float32 from
    the vertices and lambdas rounded to bfloat16 (the node coordinates of
    `precomputed` in float32), and rounded to bfloat16 once.  The reference
    computes them in bfloat16 arithmetic instead, and for `precomputed` at
    N=7 that is broken: D-hat times bf16 coordinates cancels
    catastrophically in `factors_discrete`, and on a 3x3x2 mesh its factors
    are off by up to 30x and its bf16 operator 314% off the fp32 one.  The
    port is held to the reference's documented invariant there (bf16
    operator within 3% of the fp32 one), not to that output.
    """
    _validate_setup(variant, basis, verts, lam0, lam1, helmholtz)
    device = torch.as_tensor(verts).device if device is None \
        else torch.device(device)
    backend = _resolve_backend(backend, dtype, device, basis.n1)
    verts = torch.as_tensor(verts, dtype=dtype, device=device)
    device = verts.device
    node_shape = tuple(verts.shape[:-2]) + (basis.n1,) * 3
    work = _setup_dtype(dtype)       # the setup products' arithmetic

    def stored(a) -> torch.Tensor:
        """Round to the storage dtype, then widen to the work dtype."""
        return torch.as_tensor(a, dtype=dtype, device=device).to(work)

    verts_w = verts.to(work)
    if variant == "precomputed":
        # node coordinates stay at the work dtype: rounding them to bf16 is
        # what breaks the reference's factors
        coords = geometry.node_coords(verts_w, basis) if coords is None \
            else torch.as_tensor(coords, dtype=work, device=device)
        factors = geometry.factors_discrete(coords, basis)
        geom = kref.planar_factors(factors.g, factors.gwj)
    elif variant == "parallelepiped":
        geom = kref.gelem_from_verts(verts_w)
    else:  # trilinear, merged, partial
        geom = verts_w
    # the kernels take per-node lambda fields only: scalars broadcast
    lams = {name: stored(lam).expand(node_shape)
            for name, lam in (("lam0", lam0), ("lam1", lam1))
            if lam is not None}
    if variant == "merged":
        ones = torch.ones(node_shape, dtype=work, device=device)
        lams["lam0"], lams["lam1"] = setup_merged_lambdas(
            verts_w, basis, lams.get("lam0", ones), lams.get("lam1", ones))
    elif variant == "partial":
        lams = {"lam0": setup_partial_gscale(verts_w, basis)}
    lams = {name: lam.to(dtype).contiguous() for name, lam in lams.items()}
    elem_ops = {"geom": geom.to(dtype).contiguous(), **lams}
    element_op = kops.axhelm if backend == "cuda" else kops.reference

    def apply(x, elem_ops):
        return element_op(x.contiguous(), basis, variant, elem_ops["geom"],
                          lam0=elem_ops.get("lam0", lams.get("lam0")),
                          lam1=elem_ops.get("lam1", lams.get("lam1")),
                          helmholtz=helmholtz)
    return elem_ops, apply, backend
