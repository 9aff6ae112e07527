"""Batched piecewise-Bézier trajectory operations (port of
lsc_dr_planner_tpu/ops/trajectory.py).

A trajectory is a tensor of control points `ctrl` [..., M, n+1, D]
with uniform segment time dt; every op batches over the leading axes.
"""

from __future__ import annotations

import torch

from lsc_dr_planner_tpu_torch.ops import bernstein


def const_vel_ctrl(pos, vel, M: int, n: int, dt: float):
    """Constant-velocity control points: ctrl[m, i] = pos + vel·(m + i/n)·dt.
    pos, vel: [..., D] → [..., M, n+1, D]."""
    m = torch.arange(M, dtype=pos.dtype, device=pos.device)[:, None]
    i = torch.arange(n + 1, dtype=pos.dtype, device=pos.device)[None, :]
    t = (m + i / n) * dt  # [M, n+1]
    return pos[..., None, None, :] + vel[..., None, None, :] * t[:, :, None]


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


def last_point(ctrl):
    return ctrl[..., -1, -1, :]
