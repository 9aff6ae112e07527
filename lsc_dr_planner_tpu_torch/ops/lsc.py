"""Linear Safe Corridor construction (port of lsc_dr_planner_tpu/ops/lsc.py),
batched over (agent × obstacle × segment).

An LSC row means (x_{m,i} − anchor_{o,m,i})·normal_{o,m} ≥ margin_{o,m,i};
masked neighbour slots get zero normals, which the QP assembly turns
into vacuous rows. Only the communication-aware CLSC of the DR goal
mode is ported; plain LSC, BVC and RSFC are later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lsc_dr_planner_tpu_torch.ops import geometry

_EPS_F = 1e-6


@dataclass
class LSCSet:
    normals: torch.Tensor  # [A, O, M, 3]
    anchors: torch.Tensor  # [A, O, M, N, 3]
    margins: torch.Tensor  # [A, O, M, N]


def downwash_between(agent_radius, agent_downwash, obs_radius, obs_downwash,
                     obs_is_agent):
    """Pairwise combined downwash coefficient."""
    dw_agent = (agent_downwash * agent_radius + obs_downwash * obs_radius) / (
        agent_radius + obs_radius
    )
    dw_obs = (agent_radius + obs_downwash * obs_radius) / (agent_radius + obs_radius)
    return torch.where(obs_is_agent, dw_agent, dw_obs)


def _z_scale(x, dw):
    """Divide the z component by dw (broadcast over trailing dims)."""
    return torch.cat([x[..., :2], (x[..., 2] / dw)[..., None]], dim=-1)


def build_clsc(
    initial_ctrl,  # [A, M, N, 3]
    obs_ctrl,  # [A, O, M, N, 3]
    obs_goal,  # [A, O, 3]
    agent_radius,  # [A]
    agent_downwash,  # [A]
    obs_radius,  # [A, O]
    obs_downwash,  # [A, O]
    obs_is_agent,  # [A, O] bool
    current_goal,  # [A, 3]
    obs_mask,  # [A, O] bool
    world_dimension: int,
) -> LSCSet:
    """Communication-aware LSC: segments m < M−1 from the hull of relative
    control points; the last segment from the closest points between
    (obs end → obs goal) and (agent end → agent goal), anchored at the
    obstacle-side point, with the hull plane as the fallback where the
    initial last segment would violate it. In 2-D no downwash transform
    is applied."""
    A, O, M, N, _ = obs_ctrl.shape
    dw = downwash_between(agent_radius[:, None], agent_downwash[:, None],
                          obs_radius, obs_downwash, obs_is_agent)
    dw_eff = torch.ones_like(dw) if world_dimension == 2 else dw
    dwb = dw_eff[..., None, None]

    init_t = _z_scale(initial_ctrl[:, None].expand(obs_ctrl.shape), dwb)
    obs_t = _z_scale(obs_ctrl, dwb)
    rel = init_t - obs_t

    closest, dist = geometry.closest_point_origin_to_hull(rel)
    normal_poly = closest / torch.clamp(dist[..., None], min=_EPS_F)

    collision_dist = (agent_radius[:, None] + obs_radius)[..., None, None]
    proj = torch.einsum("aomnd,aomd->aomn", rel, normal_poly)
    margins_poly = 0.5 * (collision_dist + proj)

    # ---- last segment: segment-to-segment construction
    obs_last = obs_t[..., M - 1, N - 1, :]  # [A, O, 3]
    agent_last = init_t[..., M - 1, N - 1, :]
    obs_goal_t = _z_scale(obs_goal, dw_eff)
    agent_goal_t = _z_scale(current_goal[:, None, :].expand(A, O, 3), dw_eff)
    cp_obs, cp_agent, seg_dist = geometry.closest_between_segments(
        obs_last, obs_goal_t, agent_last, agent_goal_t)
    normal_last = (cp_agent - cp_obs) / torch.clamp(seg_dist[..., None], min=_EPS_F)
    margin_last = 0.5 * (collision_dist[..., 0, 0] + seg_dist)  # [A, O]

    # feasibility guard: where the initial last segment violates the
    # segment plane, fall back to the per-control-point hull plane
    init_last = init_t[..., M - 1, :, :]  # [A, O, N, 3]
    proj_init = torch.einsum("aond,aod->aon",
                             init_last - cp_obs[..., None, :], normal_last)
    clsc_ok = torch.all(proj_init >= margin_last[..., None] - 1e-4, dim=-1)

    normal_m1 = torch.where(clsc_ok[..., None], normal_last,
                            normal_poly[..., M - 1, :])
    margins_m1 = torch.where(clsc_ok[..., None], margin_last[..., None],
                             margins_poly[..., M - 1, :])
    anchors_m1 = torch.where(clsc_ok[..., None, None],
                             cp_obs[..., None, :].expand(A, O, N, 3),
                             obs_ctrl[..., M - 1, :, :])

    normal = torch.cat([normal_poly[..., :M - 1, :], normal_m1[..., None, :]], dim=-2)
    margins = torch.cat([margins_poly[..., :M - 1, :], margins_m1[..., None, :]], dim=-2)
    anchors = torch.cat([obs_ctrl[..., :M - 1, :, :], anchors_m1[..., None, :, :]],
                        dim=-3)

    # back to world coordinates
    normal = torch.cat([normal[..., :2], (normal[..., 2] / dw[..., None])[..., None]],
                       dim=-1)
    normal = torch.where(obs_mask[..., None, None], normal, 0.0)
    return LSCSet(normals=normal, anchors=anchors, margins=margins)
