"""Safe Flight Corridor update (port of lsc_dr_planner_tpu/ops/sfc.py),
'hull' mode (the DR goal mode) only.

Boxes live in integer lattice coordinates ([..., 3] inclusive index
ranges); the box-free predicate is one integral-image lookup. The
greedy expansion of the JAX package is a `lax.while_loop` per
(agent, lane); here all A·3 lanes advance together in one masked loop.
Each trip either grows a live lane by one cell or retires one of its
six directions, so with the expansion radius clamped to r cells no
lane needs more than 6·r + 6 trips.
"""

from __future__ import annotations

import math

import torch

from lsc_dr_planner_tpu_torch.world.grid import GridWorld

# direction encoding: 0,1,2 = -x,-y,-z; 3,4,5 = +x,+y,+z
_DIR_AXIS = (0, 1, 2, 0, 1, 2)
_DIR_SIGN = (-1, -1, -1, 1, 1, 1)
_MAX_ITERS = 4096  # the JAX loop's own cap when the radius is unclamped
_EXIT_CHECK = 8  # trips between host-side "any lane live?" checks


def default_axis_order(n_lanes: int, device):
    return torch.arange(6, dtype=torch.int64, device=device).expand(n_lanes, 6)


def expand_box(gw: GridWorld, lo, hi, axis_order, max_radius_cells: int = 0):
    """Greedy round-robin box expansion of L lanes at once.

    lo, hi: int32 [L, 3]; axis_order: int [L, 6] permutation of the six
    directions, tried cyclically. A direction retires when one more cell
    along it would hit an obstacle, leave the world, or (with
    `max_radius_cells` > 0) grow beyond that many cells past the seed
    face. Returns (lo, hi, ok) where ok = the seed box itself was free.
    """
    dev = lo.device
    L = lo.shape[0]
    dims = gw.dims_t
    seed_free = (gw.box_is_free(lo, hi) & torch.all(lo >= 0, dim=-1)
                 & torch.all(hi <= dims, dim=-1))
    if max_radius_cells > 0:
        lo_min = lo - max_radius_cells
        hi_max = hi + max_radius_cells
        max_trips = min(_MAX_ITERS, 6 * max_radius_cells + 6)
    else:
        lo_min = torch.full_like(lo, -(2**30))
        hi_max = torch.full_like(hi, 2**30)
        max_trips = _MAX_ITERS

    dir_axis = torch.tensor(_DIR_AXIS, device=dev)
    dir_sign = torch.tensor(_DIR_SIGN, dtype=torch.int32, device=dev)
    eye3 = torch.eye(3, dtype=torch.int32, device=dev)
    idx6 = torch.arange(6, device=dev)
    active = seed_free[:, None].expand(L, 6).clone()
    ptr = torch.zeros(L, dtype=torch.int64, device=dev)

    for trip in range(max_trips):
        if trip % _EXIT_CHECK == 0 and not bool(active.any()):
            break
        live = active.any(dim=-1)
        # next active slot in cyclic order starting at ptr
        order_pos = (ptr[:, None] + idx6) % 6
        step = torch.gather(active, 1, order_pos).to(torch.int32).argmax(dim=-1)
        slot = (ptr + step) % 6
        d = torch.gather(axis_order, 1, slot[:, None])[:, 0]
        sign = dir_sign[d][:, None]
        delta = sign * eye3[dir_axis[d]]
        nlo = torch.where(sign < 0, lo + delta, lo)
        nhi = torch.where(sign > 0, hi + delta, hi)
        in_bounds = (torch.all(nlo >= 0, dim=-1) & torch.all(nhi <= dims, dim=-1)
                     & torch.all(nlo >= lo_min, dim=-1)
                     & torch.all(nhi <= hi_max, dim=-1))
        # finished lanes are frozen, as under the JAX loop's vmap
        ok = live & in_bounds & gw.box_is_free(nlo, nhi)
        lo = torch.where(ok[:, None], nlo, lo)
        hi = torch.where(ok[:, None], nhi, hi)
        keep = torch.gather(active, 1, slot[:, None])[:, 0] & ok
        active = active.scatter(1, slot[:, None], keep[:, None])
        ptr = torch.where(ok, (slot + 1) % 6, slot)
    return lo, hi, seed_free


def sfc_to_world(gw: GridWorld, sfc_lo, sfc_hi, margin: float):
    """Lattice boxes → world boxes with margin compensation: each face
    not on the world boundary moves outward by margin − ⌊margin/res⌋·res."""
    res = gw.resolution
    delta = margin - math.floor(margin / res + 1e-9) * res
    dims = gw.dims_t
    lo_pt = gw.lattice_to_point(sfc_lo)
    hi_pt = gw.lattice_to_point(sfc_hi)
    lo_pt = torch.where(sfc_lo > 0, lo_pt - delta, lo_pt)
    hi_pt = torch.where(sfc_hi < dims, hi_pt + delta, hi_pt)
    return lo_pt, hi_pt


def _superset_of(gw: GridWorld, lo, hi, pts):
    """Containment of pts [..., P, 3] in the margin-compensated boxes
    lo, hi [..., 3]."""
    lop, hip = sfc_to_world(gw, lo, hi, gw.radius)
    inside = (pts >= lop[..., None, :] - 1e-6) & (pts <= hip[..., None, :] + 1e-6)
    return torch.all(inside.flatten(-2), dim=-1)


def update_sfc_fused(gw: GridWorld, sfc_lo, sfc_hi, init_done, last_pt, cgoal,
                     wpt, pos, max_radius_cells: int = 0):
    """Fleet SFC update in 'hull' mode with all greedy expansions in one
    batched loop: lane 0 seeds the initialization box from the current
    position; lanes 1-2 grow the new last box from {trajectory end,
    current goal, next waypoint} (round seed) and from {trajectory end,
    current goal} (floor/ceil seed intersected with the previous last
    box). Boxes shift one segment; the new last box takes lane 1, else
    lane 2, else the previous last box.

    sfc_lo, sfc_hi: int32 [A, M, 3]; init_done: bool [A]; last_pt,
    cgoal, wpt, pos: [A, 3]. Returns (new_lo, new_hi) [A, M, 3].
    """
    A, M, _ = sfc_lo.shape
    prev_lo, prev_hi = sfc_lo[:, -1], sfc_hi[:, -1]

    lo_i = gw.point_to_lattice_floor(pos)
    hi_i = gw.point_to_lattice_ceil(pos)
    hull_pts = torch.stack([last_pt, cgoal], dim=1)  # [A, 2, 3]
    pts_g = torch.cat([hull_pts, wpt[:, None]], dim=1)  # [A, 3, 3]
    lo1 = gw.point_to_lattice_round(pts_g.amin(dim=1))
    hi1 = gw.point_to_lattice_round(pts_g.amax(dim=1))
    lo2 = gw.point_to_lattice_floor(hull_pts.amin(dim=1))
    hi2 = gw.point_to_lattice_ceil(hull_pts.amax(dim=1))
    included = (torch.all(lo2 >= prev_lo, dim=-1)
                & torch.all(hi2 <= prev_hi, dim=-1))[:, None]
    lo2 = torch.where(included, lo2, torch.maximum(lo2, prev_lo))
    hi2 = torch.where(included, hi2, torch.minimum(hi2, prev_hi))

    # lanes agent-major: [A, 3 lanes, 3] → [A·3, 3]
    los = torch.stack([lo_i, lo1, lo2], dim=1).reshape(A * 3, 3)
    his = torch.stack([hi_i, hi1, hi2], dim=1).reshape(A * 3, 3)
    e_lo, e_hi, e_ok = expand_box(
        gw, los, his, default_axis_order(A * 3, los.device),
        max_radius_cells=max_radius_cells)
    e_lo = e_lo.reshape(A, 3, 3)
    e_hi = e_hi.reshape(A, 3, 3)
    e_ok = e_ok.reshape(A, 3)

    ok1 = (e_ok[:, 1] & _superset_of(gw, e_lo[:, 1], e_hi[:, 1], pts_g))[:, None]
    ok2 = (e_ok[:, 2] & _superset_of(gw, e_lo[:, 2], e_hi[:, 2], hull_pts))[:, None]
    new_lo = torch.where(ok1, e_lo[:, 1], torch.where(ok2, e_lo[:, 2], prev_lo))
    new_hi = torch.where(ok1, e_hi[:, 1], torch.where(ok2, e_hi[:, 2], prev_hi))
    ulo = torch.cat([sfc_lo[:, 1:], new_lo[:, None]], dim=1)
    uhi = torch.cat([sfc_hi[:, 1:], new_hi[:, None]], dim=1)
    ilo = e_lo[:, 0:1].expand(A, M, 3)
    ihi = e_hi[:, 0:1].expand(A, M, 3)
    done = init_done[:, None, None]
    return torch.where(done, ulo, ilo), torch.where(done, uhi, ihi)
