"""Static world preprocessing (port of lsc_dr_planner_tpu/world/grid.py).

The world is rasterized once on the host (numpy, copied as it is) into
an occupancy grid; `blocked_cumsum` turns occupancy into the blocked
lattice (points within the agent radius of an occupied cell) and its
3-D integral image on the planner's device. `GridWorld` holds them as
torch tensors, so "any blocked lattice point in this box?" is one
8-corner lookup, and the rasterized cell range of every box, for point
distance queries.

In local-sensing mode every agent plans in the part of the world it has
discovered: `blocked_cumsum` builds the images of per-agent occupancy
maps, batched over the fleet, and `local_grid_world` is a GridWorld
whose integral image carries that leading agent axis; its box queries
then take each query's agent.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class GridWorld:
    resolution: float
    world_min: np.ndarray  # host [3]
    world_max: np.ndarray  # host [3]
    origin_idx: np.ndarray  # host int [3]; lattice index 0 is at origin_idx*res
    occ: torch.Tensor  # [X, Y, Z] bool
    blocked_cumsum: torch.Tensor  # [X+2, Y+2, Z+2] int32 integral image of the
    #                               blocked lattice points [X+1, Y+1, Z+1];
    #                               [A, X+2, Y+2, Z+2] in a per-agent view
    cell_ranges: torch.Tensor  # [B, 3, 2] int32: rasterized cell index range
    #                            per box per axis [lo, hi) in global indices
    n_boxes: int
    radius: float

    def __post_init__(self):
        # device copies of the small constants, made once: a blocking
        # host-to-device copy inside the SFC loop would synchronise the
        # stream on every trip
        dev = self.blocked_cumsum.device
        self.dims_t = torch.tensor(self.dims, dtype=torch.int32, device=dev)
        self._origin_i = torch.as_tensor(self.origin_idx, dtype=torch.int32, device=dev)
        self._origin_f = self._origin_i.to(torch.float32)
        # the resolution as a device tensor: p / res is then a true
        # division on every device (PyTorch multiplies by the reciprocal
        # when a CUDA tensor is divided by a Python scalar, which can
        # round otherwise than the CPU's division and the SFC kernel's)
        self._res_t = torch.tensor(self.resolution, dtype=torch.float32, device=dev)

    @property
    def device(self) -> torch.device:
        return self.blocked_cumsum.device

    @property
    def dims(self) -> Tuple[int, int, int]:
        return tuple(int(d) for d in self.occ.shape)

    # ------------------------------------------------------------------
    def lattice_to_point(self, idx):
        """Lattice index [..., 3] → world coordinates."""
        return (idx.to(torch.float32) + self._origin_f) * self.resolution

    def point_to_lattice_floor(self, p):
        return (torch.floor(p / self._res_t + 1e-6).to(torch.int32)
                - self._origin_i)

    def point_to_lattice_ceil(self, p):
        return (torch.ceil(p / self._res_t - 1e-6).to(torch.int32)
                - self._origin_i)

    def point_to_lattice_round(self, p):
        # round half to even on f32, as jnp.round
        return (torch.round(p / self._res_t).to(torch.int32)
                - self._origin_i)

    # ------------------------------------------------------------------
    def box_blocked_count(self, lo, hi, agent=None):
        """Number of blocked lattice points with index in [lo, hi]
        (inclusive), via the integral image. lo, hi: [..., 3] int.
        Out-of-range indices are clamped before the gather. In a
        per-agent view `agent` [...] (int) names each query's agent."""
        S = self.blocked_cumsum
        SX, SY, SZ = S.shape[-3:]
        flat = S.reshape(-1)
        if S.dim() == 4:
            base = agent.long() * (SX * SY * SZ)
        elif agent is None:
            base = 0
        else:
            raise ValueError("an agent index needs a per-agent world view")

        def at(ix, iy, iz):
            return flat[base + (ix * SY + iy) * SZ + iz]

        x0, y0, z0 = (lo[..., k].long().clamp(0, e - 2) for k, e in enumerate(S.shape[-3:]))
        x1, y1, z1 = ((hi[..., k].long() + 1).clamp(0, e - 1)
                      for k, e in enumerate(S.shape[-3:]))
        return (
            at(x1, y1, z1)
            - at(x0, y1, z1)
            - at(x1, y0, z1)
            - at(x1, y1, z0)
            + at(x0, y0, z1)
            + at(x0, y1, z0)
            + at(x1, y0, z0)
            - at(x0, y0, z0)
        )

    def box_is_free(self, lo, hi, agent=None):
        return self.box_blocked_count(lo, hi, agent) == 0

    # ------------------------------------------------------------------
    def distance_to_obstacle(self, p):
        """Euclidean distance from point(s) p [..., 3] (float32, on the
        world's device) to the nearest occupied cell centre, and that
        centre: (dist [...], centre [..., 3]). With no obstacles, dist =
        +inf and centre = 0. Float32 as in the JAX package, so a point
        at a threshold distance falls on the same side in both."""
        if self.n_boxes == 0:
            return torch.full(p.shape[:-1], float("inf"), dtype=p.dtype,
                              device=p.device), torch.zeros_like(p)
        res = self.resolution
        # nearest cell of each box to p: the cell containing p, clamped
        # to the box's cell range
        pidx = torch.floor(p / res).to(torch.int32)
        lo = self.cell_ranges[..., 0]  # [B, 3]
        hi = self.cell_ranges[..., 1] - 1  # inclusive
        near = torch.minimum(torch.maximum(pidx[..., None, :], lo), hi)  # [..., B, 3]
        centers = (near.to(p.dtype) + 0.5) * res
        diff = p[..., None, :] - centers
        d = torch.sqrt((diff * diff).sum(-1))  # [..., B]
        best = torch.argmin(d, dim=-1, keepdim=True)
        dist = torch.take_along_dim(d, best, dim=-1)[..., 0]
        center = torch.take_along_dim(centers, best[..., None], dim=-2)[..., 0, :]
        return dist, center


# ----------------------------------------------------------------------
# Construction (host side, numpy; once per mission)
# ----------------------------------------------------------------------


def dilation_offsets(resolution: float, radius: float) -> Tuple[int, int]:
    """Cell-to-lattice dilation offset range: lattice point j is blocked
    iff an occupied cell i = j + d exists with d ∈ [d_lo, d_hi]."""
    r = radius / resolution
    eps = 1e-6
    return int(np.ceil(-r - 1 + eps)), int(np.floor(r - eps))


def blocked_cumsum(occ: torch.Tensor, resolution: float, radius: float):
    """The blocked lattice and its integral image of occupancy maps
    `occ` [..., X, Y, Z] bool (leading axes batch, e.g. one map per
    agent), on occ's device: (blocked [..., X+1, Y+1, Z+1] bool, cumsum
    [..., X+2, Y+2, Z+2] int32). Lattice point j is blocked iff some
    occupied cell i has L∞(j·res, cell box of i) < radius, i.e. (i−j) ∈
    (−radius/res − 1, radius/res): a dilation by shifted ORs, axis by
    axis, then three int32 cumsums (torch.cumsum would widen int32 to
    int64) under a leading zero pad."""
    d_lo, d_hi = dilation_offsets(resolution, radius)
    nb = occ.dim() - 3
    cur = occ
    for axis in range(nb, nb + 3):
        n_in = cur.shape[axis]
        shp = list(cur.shape)
        shp[axis] = n_in + 1
        nxt = torch.zeros(shp, dtype=torch.bool, device=occ.device)
        for d in range(d_lo, d_hi + 1):
            # lattice j gets cell j + d
            src_lo, src_hi = max(0, d), min(n_in, n_in + 1 + d)
            if src_hi <= src_lo:
                continue
            nxt.narrow(axis, src_lo - d, src_hi - src_lo).logical_or_(
                cur.narrow(axis, src_lo, src_hi - src_lo))
        cur = nxt
    S = cur.to(torch.int32)
    for axis in range(nb, nb + 3):
        S = torch.cumsum(S, dim=axis, dtype=torch.int32)
    out = torch.zeros(S.shape[:nb] + tuple(d + 1 for d in S.shape[nb:]),
                      dtype=torch.int32, device=occ.device)
    out[..., 1:, 1:, 1:] = S
    return cur, out


def local_grid_world(base: GridWorld, cumsum: torch.Tensor) -> GridWorld:
    """`base` seen through per-agent integral images `cumsum` [A, X+2,
    Y+2, Z+2] (`blocked_cumsum` of the agents' known maps): box queries
    read the querying agent's image; lattice geometry is the base's. It
    answers no distance queries (n_boxes = 0): the base's box list does
    not describe the agents' maps."""
    return dataclasses.replace(base, blocked_cumsum=cumsum, n_boxes=0)


def rasterize_boxes(boxes: np.ndarray, world_min, world_max, resolution: float):
    """Rasterize a box list (cx, cy, cz, sx, sy, sz) into an occupancy
    grid. Returns (occ [X, Y, Z] bool, cell_ranges [B, 3, 2] int32,
    origin_idx [3] int64, dims [3] int64)."""
    world_min = np.asarray(world_min, dtype=np.float64)
    world_max = np.asarray(world_max, dtype=np.float64)
    origin_idx = np.round(world_min / resolution).astype(np.int64)
    end_idx = np.round(world_max / resolution).astype(np.int64)
    dims = (end_idx - origin_idx).astype(np.int64)
    X, Y, Z = (int(d) for d in dims)

    occ = np.zeros((X, Y, Z), dtype=bool)
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 6)
    cell_ranges = np.zeros((max(len(boxes), 1), 3, 2), dtype=np.int32)
    for b, row in enumerate(boxes):
        com, size = row[:3], row[3:]
        lo = np.round((com - 0.5 * size) / resolution).astype(np.int64)
        hi = np.round((com + 0.5 * size) / resolution).astype(np.int64)
        cell_ranges[b, :, 0] = lo
        cell_ranges[b, :, 1] = hi
        clo = np.maximum(lo - origin_idx, 0)
        chi = np.minimum(hi - origin_idx, dims)
        if np.all(chi > clo):
            occ[clo[0] : chi[0], clo[1] : chi[1], clo[2] : chi[2]] = True
    return occ, cell_ranges, origin_idx, dims


def build_grid_world(boxes: np.ndarray, world_min, world_max, resolution: float,
                     radius: float, device) -> GridWorld:
    """Rasterize the box list on the host, then build the blocked lattice
    and its integral image on `device`."""
    occ, cell_ranges, origin_idx, _ = rasterize_boxes(boxes, world_min, world_max,
                                                      resolution)
    occ = torch.as_tensor(occ, device=device)
    return GridWorld(
        resolution=resolution,
        world_min=np.asarray(world_min, dtype=np.float64),
        world_max=np.asarray(world_max, dtype=np.float64),
        origin_idx=origin_idx,
        occ=occ,
        blocked_cumsum=blocked_cumsum(occ, resolution, radius)[1],
        cell_ranges=torch.as_tensor(cell_ranges, device=device),
        n_boxes=len(np.asarray(boxes).reshape(-1, 6)),
        radius=radius,
    )

