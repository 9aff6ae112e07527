"""Goal planning (port of lsc_dr_planner_tpu/planner/goal.py): the goal LP
of the grid-based DR goal mode, the right-hand-rule detour with its
deadlock test, and the host-side line-of-sight goal of the priority-based
mode.

The 1-D goal LP is solved in closed form: minimizing t ∈ [0, 1] for
goal = (g_cur − w)·t + w subject to half-spaces a·t ≥ b is a max over
per-constraint ratios, batched over the fleet. Its sums over coordinates
run left to right and its norms take a float64 square root
(geometry._dotn, geometry._norm), and the detour's cross product is
geometry._cross, so that the goal kernel (csrc/step_stages.cu) repeats
them bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from lsc_dr_planner_tpu_torch.ops import geometry

_EPS = 1e-6


def goal_lp(
    current_goal,  # [A, 3]
    next_waypoint,  # [A, 3]
    lsc_normals_last,  # [A, O, 3]  LSC normals at (m = M−1, i = n)
    lsc_anchor_last,  # [A, O, 3]
    lsc_margin_last,  # [A, O]
    lsc_valid,  # [A, O] bool
    sfc_lo_last,  # [A, 3] last-segment SFC box (world coords)
    sfc_hi_last,  # [A, 3]
    world_dimension: int,
    use_sfc: bool = True,
):
    """Pull the goal toward the next waypoint as far as the last-segment
    LSC rows and SFC faces allow. Returns (goal [A, 3], infeasible [A])."""
    d = world_dimension
    g = current_goal[..., :d]
    w = next_waypoint[..., :d]
    gw = g - w  # [A, d]

    n_l = lsc_normals_last[..., :d]
    a_l = geometry._dotn(n_l, gw[:, None, :])
    b_l = lsc_margin_last + geometry._dotn(n_l, lsc_anchor_last[..., :d] - w[:, None, :])
    valid_l = lsc_valid & (geometry._norm(n_l) > _EPS)

    inf = float("inf")
    lower_l = torch.where(valid_l & (a_l > _EPS), b_l / a_l, -inf)
    upper_l = torch.where(valid_l & (a_l < -_EPS), b_l / a_l, inf)
    # a ≈ 0 rows with b > 0 cannot be met by any t: keep the current goal
    infeas_l = valid_l & (torch.abs(a_l) <= _EPS) & (b_l > _EPS)

    lower = lower_l.amax(dim=-1)
    upper = upper_l.amin(dim=-1)

    if use_sfc:
        lo = sfc_lo_last[..., :d]
        hi = sfc_hi_last[..., :d]
        for sign, bound in ((1.0, lo), (-1.0, hi)):
            a_s = sign * gw
            b_s = sign * (bound - w)
            lower_s = torch.where(a_s > _EPS, b_s / a_s, -inf)
            upper_s = torch.where(a_s < -_EPS, b_s / a_s, inf)
            lower = torch.maximum(lower, lower_s.amax(dim=-1))
            upper = torch.minimum(upper, upper_s.amin(dim=-1))

    t = torch.clamp(torch.clamp(lower, min=0.0), 0.0, 1.0 + _EPS)
    infeasible = (t > upper + 1e-5) | torch.any(infeas_l, dim=-1)
    t = torch.where(infeasible, 1.0, t)

    goal = gw * t[..., None] + w
    if d == 2:
        goal = torch.cat([goal, current_goal[..., 2:]], dim=-1)
    return goal, infeasible


def right_hand_goal(position, desired_goal, is_deadlock):
    """Right-hand-rule detour: where an agent is deadlocked, its goal
    direction rotated about +z (the cross product with ẑ). [A, 3]."""
    z = torch.tensor([0.0, 0.0, 1.0], dtype=position.dtype, device=position.device)
    detour = position + geometry._cross(desired_goal - position, z.expand_as(position))
    return torch.where(is_deadlock[..., None], detour, desired_goal)


def is_deadlock(planner_seq: int, velocity, position, desired_goal,
                vel_threshold: float, seq_threshold: int):
    """Velocity-threshold deadlock test: past seq_threshold planner steps,
    slower than vel_threshold and more than 0.2 m from the goal. [A]."""
    dist = geometry._norm(position - desired_goal)
    speed = geometry._norm(velocity)
    return (planner_seq > seq_threshold) & (speed < vel_threshold) & (dist > 0.2)


# ----------------------------------------------------------------------
# line-of-sight goal (host numpy; the priority-based goal mode)
# ----------------------------------------------------------------------


def cast_ray(distance_fn, p0, p1, radius, world_max_dist=1.0, world_resolution=0.1,
             _depth=0) -> bool:
    """Recursive bisection sphere-check raycast: True when the segment
    p0 → p1 keeps `radius` (plus half a cell) from every obstacle by the
    distances `distance_fn` gives."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    dist_to_goal = np.linalg.norm(p0 - p1)
    thresh = np.sqrt(0.25 * dist_to_goal**2 + radius**2)
    d0 = float(distance_fn(p0))
    d1 = float(distance_fn(p1))
    if d0 < radius + 0.5 * world_resolution - 1e-6:
        return False
    if d1 < radius + 0.5 * world_resolution - 1e-6:
        return False
    if thresh < world_max_dist and d0 > thresh and d1 > thresh:
        return True
    if _depth > 40:
        return True
    mid = 0.5 * (p0 + p1)
    return cast_ray(distance_fn, p0, mid, radius, world_max_dist,
                    world_resolution, _depth + 1) and cast_ray(
        distance_fn, mid, p1, radius, world_max_dist, world_resolution,
        _depth + 1)


def find_los_free_goal(distance_fn, current_position, path, goal_position,
                       radius, world_max_dist=1.0, world_resolution=0.1):
    """Walk the grid path (then the final goal) and keep the farthest point
    with a collision-free straight line from `current_position`."""
    los_free = np.asarray(current_position, dtype=np.float64)
    pts = list(path) + [np.asarray(goal_position, dtype=np.float64)]
    for p in pts:
        if cast_ray(distance_fn, current_position,
                    p, radius + 0.5 * world_resolution,
                    world_max_dist, world_resolution):
            los_free = np.asarray(p, dtype=np.float64)
        else:
            break
    if np.linalg.norm(los_free - np.asarray(current_position)) < 1e-6 and len(pts) > 2:
        los_free = np.asarray(pts[1], dtype=np.float64)
    return los_free
