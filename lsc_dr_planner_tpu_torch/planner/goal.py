"""Goal planning for the grid-based DR goal mode (port of
lsc_dr_planner_tpu/planner/goal.py::goal_lp).

The 1-D goal LP is solved in closed form: minimizing t ∈ [0, 1] for
goal = (g_cur − w)·t + w subject to half-spaces a·t ≥ b is a max over
per-constraint ratios, batched over the fleet.
"""

from __future__ import annotations

import torch

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
    a_l = torch.einsum("aod,ad->ao", n_l, gw)
    b_l = lsc_margin_last + torch.einsum(
        "aod,aod->ao", n_l, lsc_anchor_last[..., :d] - w[:, None, :])
    valid_l = lsc_valid & (torch.linalg.vector_norm(n_l, dim=-1) > _EPS)

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
