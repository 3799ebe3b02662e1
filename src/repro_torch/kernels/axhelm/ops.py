"""Public wrapper for the axhelm CUDA kernels.

Counterpart of `repro.kernels.axhelm.ops`: it normalizes the field layouts
((E, N1^3) scalar, (E, d, N1^3) vector, (E, nrhs, d, N1^3) RHS-batched) to
the kernel's (E, nrhs, d, N1^3), keeps the reference package's geometry
layouts at its signature, and dispatches on the device of the tensors it is
given:

  * a CPU tensor goes to the plain PyTorch version (`ref.py`);
  * a CUDA tensor launches the hand-written kernel or raises — there is no
    fallback to the plain version.

One thread block per element needs no element padding, so there is no block
size to choose and no tuner.  `launch_counts` counts the kernel launches of
each variant, so a run can show that a solve went through the kernels.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.spectral import SpectralBasis, basis as make_basis
from repro_torch.kernels.axhelm import build
from repro_torch.kernels.axhelm import ref as ref_mod

__all__ = ["KERNEL_VARIANTS", "KERNEL_N1", "launch_counts",
           "reset_launch_counts", "axhelm", "reference"]

KERNEL_VARIANTS = ("precomputed", "trilinear")
KERNEL_N1 = (4, 8)   # the N1 = N + 1 instantiated in csrc/axhelm.cu
# variants of the reference package's kernel that are not ported yet
_NOT_PORTED = {"parallelepiped": "K3", "merged": "K4", "partial": "K5"}

launch_counts = {v: 0 for v in KERNEL_VARIANTS}


def reset_launch_counts() -> None:
    for v in launch_counts:
        launch_counts[v] = 0


def check_variant(variant: str) -> None:
    """Raise for a variant the port has no kernel for."""
    if variant in _NOT_PORTED:
        raise NotImplementedError(
            f"axhelm variant {variant!r} (kernel {_NOT_PORTED[variant]}) is "
            f"not ported yet: see ROADMAP.md, Queue 2 (TPU kernels to port)")
    if variant not in KERNEL_VARIANTS:
        raise ValueError(f"unknown axhelm variant {variant!r}")


def _as_batched(x: torch.Tensor) -> torch.Tensor:
    """(E, N1^3) / (E, d, N1^3) / (E, nrhs, d, N1^3) -> (E, nrhs, d, N1^3)."""
    if x.ndim == 4:
        return x[:, None, None]
    if x.ndim == 5:
        return x[:, None]
    if x.ndim == 6:
        return x
    raise ValueError(
        f"axhelm: x must be (E, N1,N1,N1), (E, d, N1,N1,N1) or "
        f"(E, nrhs, d, N1,N1,N1), got shape {tuple(x.shape)}")


def axhelm(x: torch.Tensor, basis: SpectralBasis, variant: str,
           geom: torch.Tensor,
           lam0: Optional[torch.Tensor] = None,
           lam1: Optional[torch.Tensor] = None,
           helmholtz: bool = False) -> torch.Tensor:
    """Apply axhelm: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.

    x:    (E, N1,N1,N1), (E, d, N1,N1,N1) or (E, nrhs, d, N1,N1,N1) — every
          column reuses the element's single factor set.
    geom: precomputed: (E, N1,N1,N1, 7)   [g00..g22, gwj] packed
          trilinear:   (E, 8, 3)          vertices
    lam0, lam1: optional per-node (E, N1,N1,N1) fields.
    """
    check_variant(variant)
    xb = _as_batched(x)
    if xb.device.type == "cpu":
        y = reference(xb, basis, variant, geom, lam0, lam1, helmholtz)
    else:
        y = _launch(xb, basis, variant, geom, lam0, lam1, helmholtz)
    return y.reshape(x.shape)


def reference(x, basis: SpectralBasis, variant: str, geom, lam0=None,
              lam1=None, helmholtz=False):
    """The plain PyTorch version with the same operand convention
    (including the RHS-batched (E, nrhs, d, N1^3) layout), on any device."""
    check_variant(variant)
    squeeze = x.ndim == 4
    if squeeze:
        x = x[:, None]
    dhat, xi, w3 = _constants(basis.n, x.dtype, x.device)
    if variant == "precomputed":
        y = ref_mod.axhelm_precomputed(x, geom[..., :6], geom[..., 6], dhat,
                                       lam0, lam1, helmholtz)
    else:
        y = ref_mod.axhelm_trilinear(x, geom, xi, w3, dhat, lam0, lam1,
                                     helmholtz)
    return y[:, 0] if squeeze else y


def _check_kernel_operands(xb, basis, variant, geom, lam0, lam1) -> None:
    """Everything the CUDA kernel does not take raises here: another dtype
    than float32, another device, a shape off the layout, a non-contiguous
    tensor, or an order that is not instantiated."""
    named = [("x", xb), ("geom", geom), ("lam0", lam0), ("lam1", lam1)]
    named = [(n, t) for n, t in named if t is not None]
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"axhelm CUDA kernel takes float32 only; {name} "
                            f"is {t.dtype}")
    for name, t in named:
        if t.device.type != "cuda" or t.device != xb.device:
            raise ValueError(f"axhelm CUDA kernel needs every operand on "
                             f"x's CUDA device; {name} is on {t.device}, x on "
                             f"{xb.device}")
    n1 = basis.n1
    e = xb.shape[0]
    if tuple(xb.shape[3:]) != (n1,) * 3:
        raise ValueError(f"axhelm: x has node axes {tuple(xb.shape[3:])}, "
                         f"expected {(n1,) * 3} for order {basis.n}")
    want = (e, n1, n1, n1, 7) if variant == "precomputed" else (e, 8, 3)
    if tuple(geom.shape) != want:
        raise ValueError(f"axhelm {variant}: geom must have shape {want}, "
                         f"got {tuple(geom.shape)}")
    for name, lam in (("lam0", lam0), ("lam1", lam1)):
        if lam is not None and tuple(lam.shape) != (e, n1, n1, n1):
            raise ValueError(f"axhelm: {name} must have shape "
                             f"{(e, n1, n1, n1)}, got {tuple(lam.shape)}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"axhelm CUDA kernel needs contiguous operands; "
                             f"{name} is not")
    if n1 not in KERNEL_N1:
        raise ValueError(f"axhelm CUDA kernel is instantiated for N1 in "
                         f"{KERNEL_N1}, got N1={n1} (order {basis.n})")


@functools.lru_cache(maxsize=None)
def _constants(n: int, dtype: torch.dtype, device: torch.device):
    """dhat (N1, N1), xi (N1,), w3 (N1, N1, N1), contiguous, in `dtype` on
    `device` — made once, not copied from the host at every call."""
    b = make_basis(n)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device).contiguous()
                 for a in (b.dhat, b.points, b.w3))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(xb, basis, variant, geom, lam0, lam1, helmholtz) -> torch.Tensor:
    _check_kernel_operands(xb, basis, variant, geom, lam0, lam1)
    y = torch.empty_like(xb)
    e, ncols = xb.shape[0], xb.shape[1] * xb.shape[2]
    if e == 0 or ncols == 0:
        return y
    lib = build.library()
    dhat, xi, w3 = _constants(basis.n, torch.float32, xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        common = (_ptr(xb), _ptr(y), _ptr(geom), _ptr(lam0), _ptr(lam1),
                  _ptr(dhat))
        if variant == "precomputed":
            rc = lib.axhelm_precomputed_f32(*common, basis.n1, e, ncols,
                                            int(helmholtz), stream)
        else:
            rc = lib.axhelm_trilinear_f32(*common, _ptr(xi), _ptr(w3),
                                          basis.n1, e, ncols, int(helmholtz),
                                          stream)
    if rc != 0:
        raise RuntimeError(f"axhelm {variant} kernel launch failed with CUDA "
                           f"error {rc}")
    launch_counts[variant] += 1
    return y
