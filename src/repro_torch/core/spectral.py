"""Spectral (GLL) basis constants for HOSFEM.

Implements the quantities of paper Table 1:

  * Legendre polynomials ``L_N`` (recurrence) and derivatives.
  * Gauss-Lobatto-Legendre (GLL) points ``Xi_N`` — zeros of (1-x^2) L'_N(x).
  * GLL quadrature weights ``W_N`` — 2 / (N (N+1) [L_N(xi_i)]^2).
  * The differentiation matrix ``Dhat_N`` with Dhat(i, j) = pi'_j(xi_i)
    (derivative of the j-th cardinal Lagrange function at node i).

Everything here is a host-side constant fixed once the order N is chosen,
computed in numpy float64; callers cast to their dtype and device.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "legendre",
    "legendre_deriv",
    "gll_points",
    "gll_weights",
    "diff_matrix",
    "SpectralBasis",
    "basis",
]


def legendre(n: int, x: np.ndarray) -> np.ndarray:
    """Evaluate the Legendre polynomial L_n(x) via the three-term recurrence."""
    x = np.asarray(x, dtype=np.float64)
    if n == 0:
        return np.ones_like(x)
    if n == 1:
        return x.copy()
    p_prev = np.ones_like(x)
    p = x.copy()
    for k in range(2, n + 1):
        p_prev, p = p, ((2 * k - 1) * x * p - (k - 1) * p_prev) / k
    return p


def legendre_deriv(n: int, x: np.ndarray) -> np.ndarray:
    """L'_n(x) from the standard relation (1-x^2) L'_n = n (L_{n-1} - x L_n)."""
    x = np.asarray(x, dtype=np.float64)
    if n == 0:
        return np.zeros_like(x)
    ln = legendre(n, x)
    lnm1 = legendre(n - 1, x)
    denom = 1.0 - x * x
    # At the endpoints use L'_n(+-1) = (+-1)^(n-1) n (n+1) / 2.
    endpoint = np.isclose(np.abs(x), 1.0)
    safe = np.where(endpoint, 1.0, denom)
    interior = n * (lnm1 - x * ln) / safe
    end_val = np.sign(x) ** (n - 1) * n * (n + 1) / 2.0
    return np.where(endpoint, end_val, interior)


def gll_points(n: int) -> np.ndarray:
    """The N+1 GLL points: -1, zeros of L'_N, +1 (ascending).

    Newton iteration on L'_N with Chebyshev-Gauss-Lobatto initial guesses.
    L''_N comes from the Legendre ODE: (1-x^2) L'' = 2 x L' - N(N+1) L.
    """
    if n < 1:
        raise ValueError("GLL requires order N >= 1")
    if n == 1:
        return np.array([-1.0, 1.0])
    x = -np.cos(np.pi * np.arange(1, n) / n)
    for _ in range(100):
        lp = legendre_deriv(n, x)
        ln = legendre(n, x)
        lpp = (2.0 * x * lp - n * (n + 1) * ln) / (1.0 - x * x)
        dx = lp / lpp
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    return np.concatenate([[-1.0], x, [1.0]])


def gll_weights(n: int, points: np.ndarray | None = None) -> np.ndarray:
    """GLL weights: w_i = 2 / (N (N+1) [L_N(xi_i)]^2)."""
    if points is None:
        points = gll_points(n)
    ln = legendre(n, points)
    return 2.0 / (n * (n + 1) * ln * ln)


def diff_matrix(n: int, points: np.ndarray | None = None) -> np.ndarray:
    """GLL differentiation matrix Dhat(i, j) = pi'_j(xi_i).

    Standard closed form (Deville-Fischer-Mund (2.4.9)):
        D(i,j) = L_N(xi_i) / (L_N(xi_j) (xi_i - xi_j)),   i != j
        D(0,0) = -N (N+1) / 4,   D(N,N) = +N (N+1) / 4,   else 0.
    """
    if points is None:
        points = gll_points(n)
    ln = legendre(n, points)
    n1 = n + 1
    d = np.zeros((n1, n1), dtype=np.float64)
    for i in range(n1):
        for j in range(n1):
            if i != j:
                d[i, j] = ln[i] / (ln[j] * (points[i] - points[j]))
    d[0, 0] = -n * (n + 1) / 4.0
    d[n, n] = n * (n + 1) / 4.0
    return d


class SpectralBasis:
    """Bundle of the order-N constants (points, weights, Dhat, 3D weight tensor)."""

    def __init__(self, n: int):
        self.n = n
        self.n1 = n + 1
        self.points = gll_points(n)
        self.weights = gll_weights(n, self.points)
        self.dhat = diff_matrix(n, self.points)
        # w3[k, j, i] = w_k w_j w_i  (the (k, j, i) axis convention used
        # throughout: flattening gives the paper's i + j*N1 + k*N1^2 order).
        w = self.weights
        self.w3 = w[:, None, None] * w[None, :, None] * w[None, None, :]

    def __repr__(self) -> str:  # pragma: no cover
        return f"SpectralBasis(N={self.n})"


@functools.lru_cache(maxsize=None)
def basis(n: int) -> SpectralBasis:
    """Cached SpectralBasis for order N (host-side constants)."""
    return SpectralBasis(n)
