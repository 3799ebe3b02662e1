"""Sum-factorization tensor contractions (paper Definition 1, Eq. 5).

Fields on an element are stored as tensors of shape ``(..., N1, N1, N1)``
with axis order ``(k, j, i)`` so that flattening the last three axes
reproduces the paper's linearization ``i + j*N1 + k*N1**2`` (i fastest).

Each contraction multiplies the (N1, N1) differentiation matrix against one
tensor axis — O(N1^4) FLOPs per element instead of the O(N1^6) of a full
``D_r @ x``.
"""

from __future__ import annotations

import torch

__all__ = ["grad_ref", "grad_ref_transpose", "apply_dr", "apply_ds", "apply_dt"]


def _einsum(subscripts: str, dhat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Contraction with >= fp32 accumulation.

    Sub-fp32 float inputs (bf16, fp16) are contracted in fp32 and rounded
    once at the end, so no sum accumulates at the storage width; fp32 and
    fp64 inputs contract as they are.
    """
    out_dt = torch.promote_types(dhat.dtype, x.dtype)
    if out_dt.is_floating_point and torch.finfo(out_dt).bits < 32:
        return torch.einsum(subscripts, dhat.float(), x.float()).to(out_dt)
    return torch.einsum(subscripts, dhat, x)


def apply_dr(x: torch.Tensor, dhat: torch.Tensor) -> torch.Tensor:
    """y(..., k, j, i) = sum_m Dhat(i, m) x(..., k, j, m)."""
    return _einsum("im,...m->...i", dhat, x)


def apply_ds(x: torch.Tensor, dhat: torch.Tensor) -> torch.Tensor:
    """y(..., k, j, i) = sum_m Dhat(j, m) x(..., k, m, i)."""
    return _einsum("jm,...mi->...ji", dhat, x)


def apply_dt(x: torch.Tensor, dhat: torch.Tensor) -> torch.Tensor:
    """y(..., k, j, i) = sum_m Dhat(k, m) x(..., m, j, i)."""
    return _einsum("km,...mji->...kji", dhat, x)


def grad_ref(x: torch.Tensor, dhat: torch.Tensor):
    """Reference-space gradient (y_r, y_s, y_t) = (D_r x, D_s x, D_t x)."""
    return apply_dr(x, dhat), apply_ds(x, dhat), apply_dt(x, dhat)


def grad_ref_transpose(gr: torch.Tensor, gs: torch.Tensor, gt: torch.Tensor,
                       dhat: torch.Tensor) -> torch.Tensor:
    """y = D_r^T gr + D_s^T gs + D_t^T gt (the adjoint contractions)."""
    y = _einsum("mi,...m->...i", dhat, gr)
    y = y + _einsum("mj,...mi->...ji", dhat, gs)
    y = y + _einsum("mk,...mji->...kji", dhat, gt)
    return y
