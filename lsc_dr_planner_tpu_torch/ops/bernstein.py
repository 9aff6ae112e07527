"""Bernstein-polynomial machinery (port of lsc_dr_planner_tpu/ops/bernstein.py).

The constant matrix builders are numpy, copied as they are; they are
built once and handed to torch code as constants. `bernstein_basis` is
the torch evaluation helper.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def binom(n: int, k: int) -> int:
    if k < 0 or k > n:
        return 0
    return math.comb(n, k)


def falling_factorial(i: int, k: int) -> int:
    """i·(i-1)···(i-k+1); 0 when i < k."""
    if i < k:
        return 0
    out = 1
    for j in range(k):
        out *= i - j
    return out


@functools.lru_cache(maxsize=None)
def basis_matrix(n: int) -> np.ndarray:
    """Monomial-coefficient matrix B of the degree-n Bernstein basis
    (row i = monomial coefficients of b_{i,n})."""
    B = np.zeros((n + 1, n + 1), dtype=np.float64)
    for i in range(n + 1):
        for j in range(i, n + 1):
            B[i, j] = binom(n, i) * binom(n - i, n - j) * (-1.0) ** (j - i)
    return B


@functools.lru_cache(maxsize=None)
def basis_matrix_inv(n: int) -> np.ndarray:
    return np.linalg.inv(basis_matrix(n))


@functools.lru_cache(maxsize=None)
def subsegment_matrix(n: int, t0: float, tf: float) -> np.ndarray:
    """Matrix S with c' = cᵀS re-parameterizing a Bézier segment to the
    normalized sub-interval [t0, tf]."""
    a, b = tf - t0, t0
    A = np.zeros((n + 1, n + 1), dtype=np.float64)
    for i in range(n + 1):
        for j in range(i + 1):
            A[i, j] = binom(i, j) * (a**j) * (b ** (i - j))
    return basis_matrix(n) @ A @ basis_matrix_inv(n)


def bernstein_basis(n: int, tau: torch.Tensor) -> torch.Tensor:
    """Bernstein basis values b_{i,n}(tau), i = 0..n: tau.shape + (n+1,)."""
    i = torch.arange(n + 1, device=tau.device)
    coeff = torch.tensor([binom(n, k) for k in range(n + 1)],
                         dtype=tau.dtype, device=tau.device)
    t = tau[..., None]
    fi = i.to(tau.dtype)
    # guard 0**0 at the interval ends
    ti = torch.where(i == 0, 1.0, t**fi)
    si = torch.where(i == n, 1.0, (1.0 - t) ** (n - fi))
    return coeff * ti * si


@functools.lru_cache(maxsize=None)
def jerk_cost_matrix(n: int, phi: int, phi_n: int, dt: float) -> np.ndarray:
    """Per-segment control-input cost base Q (segment cost cᵀQc per
    spatial dimension), integrating the squared phi-th derivative."""
    B = basis_matrix(n)
    Q = np.zeros((n + 1, n + 1), dtype=np.float64)
    for k in range(phi, phi - phi_n, -1):
        Z = np.zeros((n + 1, n + 1), dtype=np.float64)
        for i in range(n + 1):
            for j in range(n + 1):
                if i + j - 2 * k + 1 > 0:
                    Z[i, j] = (
                        falling_factorial(i, k)
                        * falling_factorial(j, k)
                        / (i + j - 2 * k + 1)
                    )
        Q += (B @ Z @ B.T) * dt ** (-2 * k + 1)
    return Q


@functools.lru_cache(maxsize=None)
def endpoint_difference_matrices(n: int) -> tuple:
    """(A0, AT): row j maps control points to the j-th forward/backward
    difference at the segment start/end."""
    A0 = np.zeros((n + 1, n + 1), dtype=np.float64)
    AT = np.zeros((n + 1, n + 1), dtype=np.float64)
    for j in range(n + 1):
        for i in range(j + 1):
            c = (-1.0) ** (j - i) * binom(j, i)
            A0[j, i] = c
            AT[j, n - j + i] = c
    return A0, AT


@functools.lru_cache(maxsize=None)
def continuity_matrix(M: int, n: int, phi: int, dt: float) -> np.ndarray:
    """Junction continuity rows for segments m = 2..M−1:
    [(M−2)·phi, M·(n+1)] on a flattened per-dimension control vector."""
    A0, AT = endpoint_difference_matrices(n)
    out = np.zeros(((M - 2) * phi, M * (n + 1)), dtype=np.float64)
    for m in range(2, M):
        nn = 1.0
        for j in range(phi):
            row = phi * (m - 2) + j
            out[row, (n + 1) * (m - 1) : (n + 1) * m] = dt ** (-j) * nn * AT[j]
            out[row, (n + 1) * m : (n + 1) * (m + 1)] = -(dt ** (-j)) * nn * A0[j]
            nn *= n - j
    return out


@functools.lru_cache(maxsize=None)
def uncertainty_growth_ctrl(n: int, dt: float, max_acc: float, m: int) -> np.ndarray:
    """Control points (degree n) of the per-segment radius-growth
    polynomial p(τ) = ½a(m·dt)² + a·m·dt·dt·τ + ½a·dt²·τ²."""
    coef = np.zeros(n + 1, dtype=np.float64)
    coef[0] = 0.5 * max_acc * (m * dt) ** 2
    coef[1] = max_acc * m * dt * dt
    coef[2] = 0.5 * max_acc * dt**2
    return coef @ basis_matrix_inv(n)
