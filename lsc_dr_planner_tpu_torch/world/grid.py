"""Static world preprocessing (port of lsc_dr_planner_tpu/world/grid.py).

The world is rasterized once on the host (numpy, copied as it is) into
an occupancy grid, a blocked-lattice mask and its 3-D integral image;
`GridWorld` holds them as torch tensors on the planner's device, so
"any blocked lattice point in this box?" is one 8-corner lookup.
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
    #                               blocked lattice points [X+1, Y+1, Z+1]
    radius: float

    def __post_init__(self):
        # device copies of the small constants, made once: a blocking
        # host-to-device copy inside the SFC loop would synchronise the
        # stream on every trip
        dev = self.blocked_cumsum.device
        self.dims_t = torch.tensor(self.dims, dtype=torch.int32, device=dev)
        self._origin_i = torch.as_tensor(self.origin_idx, dtype=torch.int32, device=dev)
        self._origin_f = self._origin_i.to(torch.float32)

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
        return (torch.floor(p / self.resolution + 1e-6).to(torch.int32)
                - self._origin_i)

    def point_to_lattice_ceil(self, p):
        return (torch.ceil(p / self.resolution - 1e-6).to(torch.int32)
                - self._origin_i)

    def point_to_lattice_round(self, p):
        # round half to even on f32, as jnp.round
        return (torch.round(p / self.resolution).to(torch.int32)
                - self._origin_i)

    # ------------------------------------------------------------------
    def box_blocked_count(self, lo, hi):
        """Number of blocked lattice points with index in [lo, hi]
        (inclusive), via the integral image. lo, hi: [..., 3] int.
        Out-of-range indices are clamped before the gather."""
        S = self.blocked_cumsum
        SX, SY, SZ = S.shape
        flat = S.reshape(-1)

        def at(ix, iy, iz):
            return flat[(ix * SY + iy) * SZ + iz]

        x0, y0, z0 = (lo[..., k].long().clamp(0, e - 2) for k, e in enumerate(S.shape))
        x1, y1, z1 = ((hi[..., k].long() + 1).clamp(0, e - 1)
                      for k, e in enumerate(S.shape))
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

    def box_is_free(self, lo, hi):
        return self.box_blocked_count(lo, hi) == 0


# ----------------------------------------------------------------------
# Construction (host side, numpy; once per mission)
# ----------------------------------------------------------------------


def dilation_offsets(resolution: float, radius: float) -> Tuple[int, int]:
    """Cell-to-lattice dilation offset range: lattice point j is blocked
    iff an occupied cell i = j + d exists with d ∈ [d_lo, d_hi]."""
    r = radius / resolution
    eps = 1e-6
    return int(np.ceil(-r - 1 + eps)), int(np.floor(r - eps))


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
    """Rasterize the box list and precompute the static fields on the
    host, then place them on `device`."""
    occ, _, origin_idx, _ = rasterize_boxes(boxes, world_min, world_max, resolution)
    blocked = _blocked_lattice_mask(occ, resolution, radius)
    S = np.zeros(tuple(d + 1 for d in blocked.shape), dtype=np.int32)
    S[1:, 1:, 1:] = np.cumsum(np.cumsum(np.cumsum(blocked, 0), 1), 2)
    return GridWorld(
        resolution=resolution,
        world_min=np.asarray(world_min, dtype=np.float64),
        world_max=np.asarray(world_max, dtype=np.float64),
        origin_idx=origin_idx,
        occ=torch.as_tensor(occ, device=device),
        blocked_cumsum=torch.as_tensor(S, device=device),
        radius=radius,
    )


def _blocked_lattice_mask(occ: np.ndarray, res: float, radius: float) -> np.ndarray:
    """Lattice point j is blocked iff some occupied cell i has
    L∞(j·res, cell box of i) < radius, i.e. (i−j) ∈ (−radius/res − 1,
    radius/res); computed by separable dilation, axis by axis."""
    d_lo, d_hi = dilation_offsets(res, radius)
    cur = occ
    for axis in range(3):
        shp = list(cur.shape)
        shp[axis] += 1
        nxt = np.zeros(shp, dtype=bool)
        for d in range(d_lo, d_hi + 1):
            # lattice j gets cell j + d
            src_lo = max(0, d)
            src_hi = min(cur.shape[axis], shp[axis] + d)
            if src_hi <= src_lo:
                continue
            sl_src = [slice(None)] * 3
            sl_dst = [slice(None)] * 3
            sl_src[axis] = slice(src_lo, src_hi)
            sl_dst[axis] = slice(src_lo - d, src_hi - d)
            nxt[tuple(sl_dst)] |= cur[tuple(sl_src)]
        cur = nxt
    return cur
