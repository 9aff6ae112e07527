"""Batched piecewise-Bézier trajectory operations (port of
lsc_dr_planner_tpu/ops/trajectory.py).

A trajectory is a tensor of control points `ctrl` [..., M, n+1, D]
with uniform segment time dt; every op batches over the leading axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lsc_dr_planner_tpu_torch.ops import bernstein


def const_vel_ctrl(pos, vel, M: int, n: int, dt: float):
    """Constant-velocity control points: ctrl[m, i] = pos + vel·(m + i/n)·dt.
    pos, vel: [..., D] → [..., M, n+1, D]."""
    t = _cv_times(M, n, dt, pos.dtype, pos.device)  # [M, n+1]
    return pos[..., None, None, :] + vel[..., None, None, :] * t[:, :, None]


@functools.lru_cache(maxsize=None)
def _cv_times(M: int, n: int, dt: float, dtype, device):
    """(m + i/n)·dt in `dtype`, one rounding an operation and i/n a true
    division, on every device (torch divides a CUDA tensor by a Python
    number through its reciprocal), made once per device: [M, n+1]."""
    f = np.float32 if dtype == torch.float32 else np.float64
    m = np.arange(M, dtype=f)[:, None]
    i = np.arange(n + 1, dtype=f)[None, :]
    return torch.as_tensor((m + i / f(n)) * f(dt), dtype=dtype, device=device)


def derivative_ctrl(ctrl, dt: float):
    """Derivative control points: [..., M, n+1, D] → [..., M, n, D]."""
    n = ctrl.shape[-2] - 1
    return (ctrl[..., 1:, :] - ctrl[..., :-1, :]) * (n / dt)


def eval_at(ctrl, t: float, dt: float):
    """Evaluate the trajectory at time t (segment-local Bernstein basis).
    ctrl: [..., M, n+1, D] → [..., D]."""
    M, n_ctrl, D = ctrl.shape[-3:]
    batch = ctrl.shape[:-3]
    tt = torch.full(batch, t, dtype=ctrl.dtype, device=ctrl.device)
    seg = torch.clamp(torch.floor(tt / dt), 0, M - 1).to(torch.int64)
    tau = torch.clamp(tt / dt - seg.to(ctrl.dtype), 0.0, 1.0)
    basis = bernstein.bernstein_basis(n_ctrl - 1, tau)  # [..., n+1]
    idx = seg[..., None, None, None].expand(*batch, 1, n_ctrl, D)
    c = torch.gather(ctrl, -3, idx)[..., 0, :, :]
    return torch.einsum("...i,...id->...d", basis, c)


def state_at(ctrl, t: float, dt: float):
    """(position, velocity, acceleration) at time t."""
    d1 = derivative_ctrl(ctrl, dt)
    d2 = derivative_ctrl(d1, dt)
    return eval_at(ctrl, t, dt), eval_at(d1, t, dt), eval_at(d2, t, dt)


def shift_one_segment(ctrl):
    """LSC previous-solution shift: drop the first segment and repeat the
    last point as a stationary final segment."""
    hold = ctrl[..., -1:, -1:, :].expand(*ctrl.shape[:-3], 1, *ctrl.shape[-2:])
    return torch.cat([ctrl[..., 1:, :, :], hold], dim=-3)


def subsegment_first(ctrl, frac: float):
    """DLSC sub-step shift: re-parameterize the first segment to [frac, 1]
    and keep the rest (the C⁰-continuous relaxed-LSC prediction). Each
    new point Σ_i S[i, j]·c_i sums left to right, each product and sum
    rounded on its own (the prediction kernel's order)."""
    n = ctrl.shape[-2] - 1
    S = torch.as_tensor(bernstein.subsegment_matrix(n, frac, 1.0), dtype=ctrl.dtype,
                        device=ctrl.device)
    c0 = ctrl[..., 0, :, :]  # [..., n+1, D]
    first = S[0, :, None] * c0[..., 0:1, :]
    for i in range(1, n + 1):
        first = first + S[i, :, None] * c0[..., i:i + 1, :]
    return torch.cat([first[..., None, :, :], ctrl[..., 1:, :, :]], dim=-3)


def last_point(ctrl):
    return ctrl[..., -1, -1, :]
