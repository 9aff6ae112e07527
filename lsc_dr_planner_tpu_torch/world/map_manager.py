"""Per-agent map state: simulated local sensing and peer map merging
(port of lsc_dr_planner_tpu/world/map_manager.py).

In local-sensing mode (`world_use_global_map=False`) every agent knows
only the occupied cells it has sensed or been sent: a boolean known map
per agent over the global rasterized grid, `known` [A, X, Y, Z].

  * sensing reveals the occupied cells whose centre lies within the
    Euclidean sensor range of the agent: an [A, P] squared-distance test
    against the P occupied-cell centres (float64, summed in the JAX
    package's order), then a scatter into the maps;
  * merging is a single-hop union within the L∞ communication range per
    step: known[i] |= OR over in-range peers j of known[j], an exact
    float32 product of the [A, A] adjacency by the [A, X·Y·Z] maps (the
    counts stay below 2^24, and 0/1 operands are exact even under TF32);
  * each agent's map version counts its newly set cells, as the JAX
    package counts them, on the host.

The maps live on the planner's device, where the planning step reads
them (`StepInputs.occ_known`); `union_occ()` and the checkpoint copy
them to the host. The JAX package keeps them on the host, where its
integer merge product has no BLAS path (seconds per merge at 64 agents
on the repo's scaled forest).
"""

from __future__ import annotations

import numpy as np
import torch

from lsc_dr_planner_tpu_torch.device import DEFAULT as DEFAULT_DEVICE
from lsc_dr_planner_tpu_torch.device import resolve as resolve_device
from lsc_dr_planner_tpu_torch.world.grid import rasterize_boxes


class MapManager:
    """Fleet-wide per-agent known-occupancy state on `device` (the card
    by default; "cpu" runs the same torch code on the host)."""

    def __init__(self, boxes: np.ndarray, world_min, world_max,
                 resolution: float, n_agents: int,
                 use_global_map: bool = True, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.resolution = resolution
        self.A = n_agents
        occ, _, origin_idx, _ = rasterize_boxes(boxes, world_min, world_max, resolution)
        self.occ_true = occ
        self.origin_idx = origin_idx
        self.use_global_map = use_global_map

        # occupied cells (the "global map point cloud") and their centres
        idx = np.argwhere(occ)
        self._occ_cell = torch.as_tensor(np.ravel_multi_index(idx.T, occ.shape),
                                         device=self.device)
        self._occ_centers = torch.as_tensor((idx + origin_idx + 0.5) * resolution,
                                            dtype=torch.float64, device=self.device)

        occ_t = torch.as_tensor(occ, device=self.device)
        if use_global_map:
            self.known = occ_t.expand((n_agents,) + occ.shape).clone()
        else:
            self.known = torch.zeros((n_agents,) + occ.shape, dtype=torch.bool,
                                     device=self.device)
        self._version = np.zeros(n_agents, dtype=np.int64)
        self._union = None  # (version, host union) of the last union_occ()

    # ------------------------------------------------------------------
    def sense(self, positions: np.ndarray, sensor_range: float) -> None:
        """Reveal the occupied cells within Euclidean `sensor_range` of
        each agent (positions [A, 3], host)."""
        if self.use_global_map or len(self._occ_cell) == 0:
            return
        pos = torch.as_tensor(np.asarray(positions, dtype=np.float64), device=self.device)
        d = self._occ_centers[None] - pos[:, None]  # [A, P, 3]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        hit = d2 <= sensor_range * sensor_range  # [A, P]
        flat = self.known.view(self.A, -1)
        was = flat[:, self._occ_cell]
        flat[:, self._occ_cell] = was | hit
        self._version += (hit & ~was).sum(dim=1).cpu().numpy()

    # ------------------------------------------------------------------
    def merge(self, positions: np.ndarray, comm_range: float) -> None:
        """Single-hop map union from every peer within L∞ `comm_range`."""
        if self.use_global_map:
            return
        positions = np.asarray(positions, dtype=np.float64)
        d = np.max(np.abs(positions[:, None] - positions[None]), axis=-1)
        adj = (d < comm_range) if comm_range > 0 else np.ones_like(d, bool)
        np.fill_diagonal(adj, False)
        flat = self.known.view(self.A, -1)
        before = flat.sum(dim=1)
        adj_t = torch.as_tensor(adj, dtype=torch.float32, device=self.device)
        flat |= (adj_t @ flat.to(torch.float32)) > 0
        self._version += (flat.sum(dim=1) - before).cpu().numpy()

    # ------------------------------------------------------------------
    def union_occ(self) -> np.ndarray:
        """Union of all agents' known maps on the host [X, Y, Z] (the
        coarse MAPF grid's occupancy), copied once per map version."""
        v = self.version()
        if self._union is None or self._union[0] != v:
            self._union = (v, self.known.any(dim=0).cpu().numpy())
        return self._union[1]

    def version(self) -> int:
        """Monotone counter that changes whenever any map changes."""
        return int(self._version.sum())
