"""Coarse planning grid for the MAPF / discrete-goal layer.

Capability parity with GridBasedPlanner's grid handling (reference:
src/grid_based_planner.cpp — grid sizing :86-100, occupancy from the EDT
:102-139, dynamic-obstacle inflation :142-204, start/goal unblocking
:207-283, world↔grid conversion :386-441) and the vendored
grid-pathfinding Grid (4-connected, z collapsed;
third_party/grid-pathfinding/graph/src/graph.cpp:371-402).

Host-side numpy: the coarse grid is tiny (~21×21 for the benchmark
worlds) and feeds the sequential PIBT/ECBS solvers, which run on host
off the TPU critical path.

A copy of `lsc_dr_planner_tpu/mapf/grid.py`,
with its imports pointed at the port (numpy only).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np


@dataclasses.dataclass
class CoarseGrid:
    grid_min: np.ndarray  # [3] world coords of node (0,0,0)
    resolution: float
    dims: Tuple[int, int, int]
    occ: np.ndarray  # [X, Y, Z] bool (True = occupied)
    world_dimension: int
    world_z_2d: float

    # ------------------------------------------------------------------
    def point_to_node(self, p) -> np.ndarray:
        idx = np.round((np.asarray(p) - self.grid_min) / self.resolution).astype(int)
        return np.clip(idx, 0, np.asarray(self.dims) - 1)

    def node_to_point(self, node) -> np.ndarray:
        node = np.asarray(node, dtype=np.float64)
        p = self.grid_min + node * self.resolution
        if self.world_dimension == 2:
            p = p.copy()
            p[..., 2] = self.world_z_2d
        return p

    # ------------------------------------------------------------------
    def occ2d(self) -> np.ndarray:
        """z-collapsed occupancy [X, Y] (reference: Problem grid ctor uses
        grid[x][y][0], problem.cpp:148-201)."""
        return self.occ[:, :, 0]


def build_coarse_grid(
    mission_world_min,
    mission_world_max,
    grid_resolution: float,
    world_dimension: int,
    world_z_2d: float,
    distance_fn=None,
    agent_radius: float = 0.0,
) -> CoarseGrid:
    """Build the coarse grid; occupancy via `distance_fn(points)->(dist to
    nearest occupied cell box, L∞)` semantics.

    `distance_fn`: callable mapping [K, 3] world points → [K] L∞ distance
    to the closest obstacle cell box (see GridWorld). Occupied where
    dist < agent_radius (reference: grid_based_planner.cpp:121-138).
    """
    world_min = np.asarray(mission_world_min, dtype=np.float64)
    world_max = np.asarray(mission_world_max, dtype=np.float64)
    gmin = np.empty(3)
    gmax = np.empty(3)
    for i in range(3):
        gmin[i] = -np.floor((-world_min[i] + 1e-9) / grid_resolution) * grid_resolution
        gmax[i] = np.floor((world_max[i] + 1e-9) / grid_resolution) * grid_resolution
    if world_dimension == 2:
        gmin[2] = world_z_2d
        gmax[2] = world_z_2d
    dims = tuple(int(np.round((gmax[i] - gmin[i]) / grid_resolution)) + 1 for i in range(3))

    occ = np.zeros(dims, dtype=bool)
    if distance_fn is not None:
        xs = gmin[0] + np.arange(dims[0]) * grid_resolution
        ys = gmin[1] + np.arange(dims[1]) * grid_resolution
        zs = gmin[2] + np.arange(dims[2]) * grid_resolution
        pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1).reshape(-1, 3)
        d = np.asarray(distance_fn(pts)).reshape(dims)
        occ = d < agent_radius - 1e-6

    return CoarseGrid(
        grid_min=gmin,
        resolution=grid_resolution,
        dims=dims,
        occ=occ,
        world_dimension=world_dimension,
        world_z_2d=world_z_2d,
    )


def inflate_obstacles(
    grid: CoarseGrid,
    positions: Sequence[np.ndarray],
    radii: Sequence[float],
    downwashes: Sequence[float],
    agent_radius: float,
    agent_downwash: float,
) -> np.ndarray:
    """Occupancy copy with higher-priority agents/obstacles rendered as
    inflated ellipsoidal blobs (reference: grid_based_planner.cpp:142-204).
    Returns a new occ array."""
    occ = grid.occ.copy()
    res = grid.resolution
    X, Y, Z = grid.dims
    for pos, r_obs, dw_obs in zip(positions, radii, downwashes):
        ci = grid.point_to_node(pos)
        dw = (agent_radius * agent_downwash + r_obs * dw_obs) / (agent_radius + r_obs)
        size_xy = int(np.ceil((agent_radius + r_obs) / res))
        size_z = int(np.ceil((agent_radius * agent_downwash + r_obs * dw_obs) / res))
        for i in range(max(ci[0] - size_xy, 0), min(ci[0] + size_xy, X - 1) + 1):
            for j in range(max(ci[1] - size_xy, 0), min(ci[1] + size_xy, Y - 1) + 1):
                for k in range(max(ci[2] - size_z, 0), min(ci[2] + size_z, Z - 1) + 1):
                    if occ[i, j, k]:
                        continue
                    p = grid.node_to_point((i, j, k))
                    d = p - pos
                    dist = np.sqrt(d[0] ** 2 + d[1] ** 2 + (d[2] / dw) ** 2)
                    if dist < agent_radius + r_obs:
                        occ[i, j, k] = True
    return occ


# ----------------------------------------------------------------------
# search primitives on the z-collapsed 4-connected grid
# ----------------------------------------------------------------------

_NBR4 = np.array([(-1, 0), (1, 0), (0, -1), (0, 1)], dtype=int)


def bfs_distances(occ2d: np.ndarray, goal: Tuple[int, int]) -> np.ndarray:
    """BFS distance-to-goal table over free cells; inf where unreachable.

    Reference: Solver distance tables, src/mapf/solver.cpp (BFS per agent).
    """
    X, Y = occ2d.shape
    dist = np.full((X, Y), np.inf)
    gx, gy = goal
    if occ2d[gx, gy]:
        return dist
    dist[gx, gy] = 0
    dq = deque([(gx, gy)])
    while dq:
        x, y = dq.popleft()
        d = dist[x, y] + 1
        for dx, dy in _NBR4:
            nx, ny = x + dx, y + dy
            if 0 <= nx < X and 0 <= ny < Y and not occ2d[nx, ny] and d < dist[nx, ny]:
                dist[nx, ny] = d
                dq.append((nx, ny))
    return dist


def astar_path(
    occ2d: np.ndarray, start: Tuple[int, int], goal: Tuple[int, int]
) -> Optional[List[Tuple[int, int]]]:
    """4-connected A* (reference: grid-pathfinding graph.cpp:18-90)."""
    import heapq

    X, Y = occ2d.shape
    if occ2d[goal[0], goal[1]] or occ2d[start[0], start[1]]:
        return None
    h = lambda x, y: abs(x - goal[0]) + abs(y - goal[1])
    openq = [(h(*start), 0, start, None)]
    came = {}
    gbest = {start: 0}
    while openq:
        f, g, node, parent = heapq.heappop(openq)
        if node in came:
            continue
        came[node] = parent
        if node == goal:
            path = [node]
            while came[path[-1]] is not None:
                path.append(came[path[-1]])
            return path[::-1]
        for dx, dy in _NBR4:
            nxt = (node[0] + dx, node[1] + dy)
            if not (0 <= nxt[0] < X and 0 <= nxt[1] < Y) or occ2d[nxt[0], nxt[1]]:
                continue
            ng = g + 1
            if ng < gbest.get(nxt, np.inf):
                gbest[nxt] = ng
                heapq.heappush(openq, (ng + h(*nxt), ng, nxt, node))
    return None
