"""Priority-based goal planning (port of lsc_dr_planner_tpu/planner/priority.py),
host numpy: build the set of higher-priority neighbours, back away from
a too-close superior, otherwise run a single-agent A* on the coarse grid
with the higher-priority agents rendered as inflated obstacles and take
the farthest line-of-sight-free point on the path."""

from __future__ import annotations

from typing import List

import numpy as np

from lsc_dr_planner_tpu_torch.config import Param
from lsc_dr_planner_tpu_torch.mapf.grid import CoarseGrid, astar_path, inflate_obstacles
from lsc_dr_planner_tpu_torch.planner.goal import find_los_free_goal


def prior_based_goal(
    i: int,
    pos: np.ndarray,  # [A, 3]
    vel: np.ndarray,
    desired_goal: np.ndarray,  # [A, 3]
    prev_end: np.ndarray,  # [A, 3] previous-trajectory end points
    radius: np.ndarray,  # [A]
    downwash: np.ndarray,  # [A]
    neighbor_ids: List[int],
    coarse: CoarseGrid,
    distance_fn,
    param: Param,
) -> np.ndarray:
    """Agent i's current goal under the priority rule. `distance_fn`
    (point → distance to the nearest obstacle) is None in a world
    without obstacles: the goal is then the desired goal."""
    p = param
    dist_to_goal = np.linalg.norm(pos[i] - desired_goal[i])
    high_priority: List[int] = []
    closest_j, min_dist_to_obs = -1, np.inf

    for j in neighbor_ids:
        obs_dist_to_goal = np.linalg.norm(pos[j] - desired_goal[j])
        dist_to_obs = np.linalg.norm(pos[j] - pos[i])
        if obs_dist_to_goal < p.goal_threshold:
            continue  # neighbour parked at its goal
        # same-direction exemption
        if dist_to_goal > p.goal_threshold and np.dot(
            prev_end[j] - pos[j], pos[j] - pos[i]
        ) > 0:
            continue
        if dist_to_goal < p.goal_threshold or obs_dist_to_goal < dist_to_goal:
            if dist_to_obs < min_dist_to_obs:
                min_dist_to_obs = dist_to_obs
                closest_j = j
            high_priority.append(j)

    # too close to a superior: back away
    if min_dist_to_obs < p.priority_agent_distance:
        away = pos[i] - pos[closest_j]
        n = np.linalg.norm(away)
        if n < 1e-9:
            away, n = np.array([1.0, 0, 0]), 1.0
        return pos[i] + away / n * (p.priority_agent_distance + 0.1)

    def run_sapf(blocked_ids):
        occ = inflate_obstacles(
            coarse,
            [pos[j] for j in blocked_ids],
            [radius[j] for j in blocked_ids],
            [downwash[j] for j in blocked_ids],
            float(radius[i]),
            float(downwash[i]),
        )[:, :, 0]
        start = tuple(coarse.point_to_node(pos[i])[:2])
        goal = tuple(coarse.point_to_node(desired_goal[i])[:2])
        occ[start] = False
        occ[goal] = False
        return astar_path(occ, start, goal)

    path_cells = run_sapf(high_priority)
    if path_cells is None:
        path_cells = run_sapf([])
    if path_cells is None:
        return desired_goal[i].copy()

    path_pts = [
        coarse.node_to_point(np.array([c[0], c[1], 0])) for c in path_cells
    ]
    if distance_fn is None:
        return desired_goal[i].copy()
    return find_los_free_goal(
        distance_fn, prev_end[i], path_pts, desired_goal[i],
        float(radius[i]), p.world_max_dist, p.world_resolution,
    )
