"""Linear Kalman filter: 6-state constant-velocity position tracker.

Capability parity with the reference's mocap velocity estimator used on
the real-hardware path (reference: src/linear_kalman_filter.cpp —
predict :124-132, update :133-148, F/G/Q/R builders :150-199; abstract
base include/kalman_filter.hpp). Batched: filters a whole set of
tracked objects at once (leading axes broadcast).

State x = [p; v] ∈ R⁶, measurement z = p ∈ R³:
    F(dt) = [I, dt·I; 0, I],  G(dt) = [½dt²·I; dt·I]
    Q = G diag(σ_Q²) Gᵀ,      R = diag(σ_R)

A copy of `lsc_dr_planner_tpu/utils/kalman.py` (numpy only).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class KFState(NamedTuple):
    x: np.ndarray  # [..., 6]
    P: np.ndarray  # [..., 6, 6]


def kf_init(position, sigma_p: float = 0.1, sigma_v: float = 1.1) -> KFState:
    """Initialize from a first position fix (reference :100-118)."""
    position = np.asarray(position, dtype=np.float64)
    batch = position.shape[:-1]
    x = np.zeros(batch + (6,))
    x[..., :3] = position
    P = np.zeros(batch + (6, 6))
    idx = np.arange(3)
    P[..., idx, idx] = sigma_p
    P[..., idx + 3, idx + 3] = sigma_v
    return KFState(x, P)


def _fgq(dt: float, sigma_q):
    F = np.eye(6)
    F[:3, 3:] = dt * np.eye(3)
    G = np.zeros((6, 3))
    G[:3] = 0.5 * dt * dt * np.eye(3)
    G[3:] = dt * np.eye(3)
    Q = G @ np.diag(np.square(sigma_q)) @ G.T
    return F, Q


def kf_step(
    state: KFState,
    measurement,
    dt: float,
    sigma_q=(20.0, 20.0, 20.0),
    sigma_r=(0.001, 0.001, 0.001),
) -> KFState:
    """One predict+update cycle with a position measurement."""
    F, Q = _fgq(dt, np.asarray(sigma_q, dtype=np.float64))
    H = np.zeros((3, 6))
    H[:, :3] = np.eye(3)
    R = np.diag(np.asarray(sigma_r, dtype=np.float64))

    x_pred = np.einsum("ij,...j->...i", F, state.x)
    P_pred = F @ state.P @ F.T + Q

    z = np.asarray(measurement, dtype=np.float64)
    resid = z - x_pred[..., :3]
    S = R + H @ P_pred @ H.T
    K = P_pred @ H.T @ np.linalg.inv(S)
    x_est = x_pred + np.einsum("...ij,...j->...i", K, resid)
    P_est = P_pred - K @ S @ np.swapaxes(K, -1, -2)
    return KFState(x_est, P_est)


class LinearKalmanFilter:
    """Stateful convenience wrapper mirroring the reference class."""

    def __init__(self, sigma_q=(20.0, 20.0, 20.0), sigma_r=(0.001, 0.001, 0.001)):
        self.sigma_q = sigma_q
        self.sigma_r = sigma_r
        self.state: KFState | None = None
        self._t_last: float | None = None

    def observe(self, position, t: float) -> Tuple[np.ndarray, np.ndarray]:
        """Feed a position fix at time t; returns (position, velocity)
        estimates (reference pose_cb, :36-122)."""
        if self.state is None:
            self.state = kf_init(position)
            self._t_last = t
        else:
            dt = max(t - self._t_last, 1e-6)
            self.state = kf_step(self.state, position, dt,
                                 self.sigma_q, self.sigma_r)
            self._t_last = t
        return self.state.x[..., :3].copy(), self.state.x[..., 3:].copy()
