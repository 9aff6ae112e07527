"""Linear Safe Corridor construction (port of lsc_dr_planner_tpu/ops/lsc.py),
batched over (agent × obstacle × segment).

An LSC row means (x_{m,i} − anchor_{o,m,i})·normal_{o,m} ≥ margin_{o,m,i};
masked neighbour slots get zero normals, which the QP assembly turns
into vacuous rows. Four constructions, one per planner mode: plain LSC
(LSC and DLSC without the DR goal layer), the communication-aware CLSC
(the DR goal mode), the Buffered Voronoi Cell and Reciprocal RSFC. Each
works in downwash-scaled coordinates (z divided by the pairwise downwash
coefficient) and scales the normal's z back.

CLSC, the main path's construction, runs on CUDA tensors as one launch
of a hand-written kernel (`hull_cuda.build_clsc_cuda`,
csrc/hull_closest.cu: a thread per hull, the whole construction, no host
read), and on CPU tensors, or with `plain=True`, as the torch body of
`build_clsc`, its plain version (~106 ops around the hull query). The
plain body pins the rounding torch leaves open (its projections and the
segment construction's dot products as `geometry._dot3`, the segment
distance as a float64 square root), so that the kernel repeats it bit
for bit on the card and a Python twin on the CPU; `plain_cuda_calls`
counts plain bodies run on CUDA tensors since `reset_counts()`. Plain
LSC keeps the hull query as its own launch (`geometry`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lsc_dr_planner_tpu_torch.ops import geometry, hull_cuda

_EPS_F = 1e-6

plain_cuda_calls = 0  # plain build_clsc bodies run on CUDA tensors since the last reset


def reset_counts():
    global plain_cuda_calls
    plain_cuda_calls = 0


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


def _to_world_normal(normal, dw):
    """Normals from downwash-scaled back to world coordinates: n_z /= dw
    (dw broadcasts against normal[..., 2])."""
    return torch.cat([normal[..., :2], (normal[..., 2] / dw)[..., None]], dim=-1)


def build_lsc(
    initial_ctrl,  # [A, M, N, 3]
    obs_ctrl,  # [A, O, M, N, 3]
    obs_pred_sizes,  # [A, O, M, N] (radius + uncertainty inflation)
    agent_radius,  # [A]
    agent_downwash,  # [A]
    obs_radius,  # [A, O]
    obs_downwash,  # [A, O]
    obs_is_agent,  # [A, O] bool
    obs_position,  # [A, O, 3] current obstacle positions (normal fallback)
    current_goal,  # [A, 3]
    obs_mask,  # [A, O] bool
) -> LSCSet:
    """Plain LSC: the normal from the closest point between the origin and
    the hull of relative control points; margin ½(r_i + r_j + rel·n) for
    agents, predicted size + radius for dynamic obstacles. Where the hull
    holds the origin (degenerate), the normal points from the obstacle
    toward the agent's goal."""
    A, O, M, N, _ = obs_ctrl.shape
    dw = downwash_between(agent_radius[:, None], agent_downwash[:, None],
                          obs_radius, obs_downwash, obs_is_agent)
    dwb = dw[..., None, None]
    init_t = _z_scale(initial_ctrl[:, None].expand(obs_ctrl.shape), dwb)
    obs_t = _z_scale(obs_ctrl, dwb)
    rel = init_t - obs_t

    closest, dist = geometry.closest_point_origin_to_hull(rel)
    normal = closest / torch.clamp(dist[..., None], min=_EPS_F)

    fallback_dir = _z_scale(current_goal[:, None, :] - obs_position, dw)
    fallback = fallback_dir / torch.clamp(
        torch.linalg.vector_norm(fallback_dir, dim=-1, keepdim=True), min=_EPS_F)
    normal = torch.where(dist[..., None] < _EPS_F, fallback[:, :, None, :], normal)

    collision_dist = (agent_radius[:, None] + obs_radius)[..., None, None]
    proj = torch.einsum("aomnd,aomd->aomn", rel, normal)
    d_agent = 0.5 * (collision_dist + proj)
    d_dyn = obs_pred_sizes + agent_radius[:, None, None, None]
    margins = torch.where(obs_is_agent[..., None, None], d_agent, d_dyn)

    normal = torch.where(obs_mask[..., None, None], _to_world_normal(normal, dw[..., None]),
                         0.0)
    return LSCSet(normals=normal, anchors=obs_ctrl, margins=margins)


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
    plain: bool = False,
) -> LSCSet:
    """Communication-aware LSC: segments m < M−1 from the hull of relative
    control points; the last segment from the closest points between
    (obs end → obs goal) and (agent end → agent goal), anchored at the
    obstacle-side point, with the hull plane as the fallback where the
    initial last segment would violate it. In 2-D no downwash transform
    is applied.

    CUDA tensors go to the kernel (one launch; a failure to build or
    launch raises), CPU tensors to the plain body; `plain` forces the
    plain body (and its plain hull enumeration) on any device, for
    comparisons. Any other device raises."""
    global plain_cuda_calls
    args = (initial_ctrl, obs_ctrl, obs_goal, agent_radius, agent_downwash, obs_radius,
            obs_downwash, obs_is_agent, current_goal, obs_mask)
    dev = obs_ctrl.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no CLSC construction for device {dev}")
    if dev.type == "cuda" and not plain:
        return LSCSet(*hull_cuda.build_clsc_cuda(*(t.contiguous() for t in args),
                                                 world_dimension))
    if dev.type == "cuda":
        plain_cuda_calls += 1
    return _build_clsc_plain(*args, world_dimension, plain)


def _build_clsc_plain(initial_ctrl, obs_ctrl, obs_goal, agent_radius, agent_downwash,
                      obs_radius, obs_downwash, obs_is_agent, current_goal, obs_mask,
                      world_dimension: int, plain: bool) -> LSCSet:
    """build_clsc's plain version (the torch body)."""
    A, O, M, N, _ = obs_ctrl.shape
    dw = downwash_between(agent_radius[:, None], agent_downwash[:, None],
                          obs_radius, obs_downwash, obs_is_agent)
    dw_eff = torch.ones_like(dw) if world_dimension == 2 else dw
    dwb = dw_eff[..., None, None]

    init_t = _z_scale(initial_ctrl[:, None].expand(obs_ctrl.shape), dwb)
    obs_t = _z_scale(obs_ctrl, dwb)
    rel = init_t - obs_t

    closest, dist = geometry.closest_point_origin_to_hull(rel, plain=plain)
    normal_poly = closest / torch.clamp(dist[..., None], min=_EPS_F)

    collision_dist = (agent_radius[:, None] + obs_radius)[..., None, None]
    proj = geometry._dot3(rel, normal_poly[..., None, :])
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
    proj_init = geometry._dot3(init_last - cp_obs[..., None, :], normal_last[..., None, :])
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

    normal = torch.where(obs_mask[..., None, None], _to_world_normal(normal, dw[..., None]),
                         0.0)
    return LSCSet(normals=normal, anchors=anchors, margins=margins)


def build_bvc(
    initial_ctrl,  # [A, M, N, 3]
    obs_ctrl,  # [A, O, M, N, 3]
    agent_radius,
    agent_downwash,
    obs_radius,
    obs_downwash,
    obs_is_agent,
    obs_mask,
) -> LSCSet:
    """Buffered Voronoi Cell: one plane per neighbour from the current
    positions only, the same for every segment and control point."""
    A, O, M, N, _ = obs_ctrl.shape
    dw = downwash_between(agent_radius[:, None], agent_downwash[:, None],
                          obs_radius, obs_downwash, obs_is_agent)
    pa = _z_scale(initial_ctrl[:, None, 0, 0, :].expand(A, O, 3), dw)
    po = _z_scale(obs_ctrl[..., 0, 0, :], dw)
    rel = pa - po
    dist = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
    normal = rel / torch.clamp(dist, min=_EPS_F)
    collision_dist = (agent_radius[:, None] + obs_radius)[..., None]
    d = 0.5 * (collision_dist + torch.sum(rel * normal, dim=-1, keepdim=True))

    normal = _to_world_normal(normal, dw)[..., None, :].expand(A, O, M, 3)
    margins = d[..., None].expand(A, O, M, N)
    normal = torch.where(obs_mask[..., None, None], normal, 0.0)
    return LSCSet(normals=normal, anchors=obs_ctrl, margins=margins)


def build_reciprocal_rsfc(
    initial_ctrl,  # [A, M, N, 3]
    obs_ctrl,  # [A, O, M, N, 3]
    obs_pred_sizes,  # [A, O, M, N]
    agent_radius,
    agent_downwash,
    obs_radius,
    obs_downwash,
    obs_is_agent,
    obs_mask,
) -> LSCSet:
    """Reciprocal RSFC: per segment, the normal from the closest approach of
    the two simultaneously parameterized straight paths (segment start →
    end); margins from the predicted sizes, split in half where two agents'
    paths are already in conflict. The reference scales n_z by 1/dw² here."""
    A, O, M, N, _ = obs_ctrl.shape
    ag = initial_ctrl[:, None].expand(A, O, M, N, 3)
    cp_obs, cp_agent, dist = geometry.closest_between_line_paths(
        obs_ctrl[..., 0, :], obs_ctrl[..., N - 1, :], ag[..., 0, :], ag[..., N - 1, :])
    normal = (cp_agent - cp_obs) / torch.clamp(dist[..., None], min=_EPS_F)

    size_sum = obs_pred_sizes + agent_radius[:, None, None, None]
    in_conflict = obs_is_agent[..., None, None] & (dist[..., None] < size_sum)
    d = torch.where(in_conflict, 0.5 * (size_sum + dist[..., None]), size_sum)

    dw = downwash_between(agent_radius[:, None], agent_downwash[:, None],
                          obs_radius, obs_downwash, obs_is_agent)
    normal = _to_world_normal(normal, dw[..., None] ** 2)
    normal = torch.where(obs_mask[..., None, None], normal, 0.0)
    return LSCSet(normals=normal, anchors=obs_ctrl, margins=d)
