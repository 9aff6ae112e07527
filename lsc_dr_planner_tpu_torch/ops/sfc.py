"""Safe Flight Corridor update (port of lsc_dr_planner_tpu/ops/sfc.py) in
its three modes: 'hull' (the DR goal mode), 'point' (the other goal
modes) and 'substep' (DLSC with sub-step replanning).

Boxes live in integer lattice coordinates ([..., 3] inclusive index
ranges); the box-free predicate is one integral-image lookup. The
greedy expansion of the JAX package is a `lax.while_loop` per
(agent, lane). Here, on the card:
- 'hull' mode, the main path's, is one launch of a hand-written kernel
  (`sfc_cuda.update_sfc_hull_cuda`, csrc/sfc_expand.cu: a block of three
  warps per agent computes the seeds, the three lanes' expansions, the
  selection, the shift and the world boxes);
- 'point' and 'substep' seed and select in torch around `expand_box`,
  which grows all lanes of the fleet (A·2 or A·(M+2)) in one launch of
  the kernel's other entry (`sfc_cuda.expand_box_cuda`).
Both entries expand a lane with one warp that speculates on a chain of
growths, resolving up to 32 trips a round (see the source). On the CPU,
or with `plain=True`, the torch bodies run: `_update_sfc_plain`'s seeding
and selection around the masked loop `expand_box_plain`, whose lanes
advance together. Each trip either grows a live lane by one cell or
retires one of its six directions, so with the expansion radius clamped
to r cells no lane needs more than 6·r + 6 trips.

In local-sensing mode the world is a per-agent view
(`grid.local_grid_world`): every box query of a lane reads its own
agent's integral image, while lattice geometry and the containment
tests read the shared world, as in the JAX package.

Counters since the last `reset_counts()`: `trips` and `syncs`, the
plain loop's trips and its host reads of "is any lane live?" (0 on the
kernel paths); `plain_cuda_calls`, plain 'hull' bodies run on CUDA
tensors; on every path, each call's longest lane's trips summed on the
lanes' device, read by `read_lane_trips()` (one host read); `last_lanes`
keeps the last expansion's lanes (seeds, results, seed-free mask;
tensors the call made anyway). `tools/sfc_bench.py` and `chip_smoke.py`
read them.
"""

from __future__ import annotations

import math

import torch

from lsc_dr_planner_tpu_torch.ops import sfc_cuda
from lsc_dr_planner_tpu_torch.world.grid import GridWorld

# direction encoding: 0,1,2 = -x,-y,-z; 3,4,5 = +x,+y,+z
_DIR_AXIS = (0, 1, 2, 0, 1, 2)
_DIR_SIGN = (-1, -1, -1, 1, 1, 1)
_MAX_ITERS = 4096  # the JAX loop's own cap when the radius is unclamped
_EXIT_CHECK = 8  # trips between host-side "any lane live?" checks

trips = 0  # plain-loop trips run since the last reset_counts()
syncs = 0  # its host reads of "any lane live?" since then (one every _EXIT_CHECK trips)
plain_cuda_calls = 0  # plain 'hull' bodies run on CUDA tensors since then
last_lanes = None  # the last expansion's (seed_lo, seed_hi, lo, hi, seed_free)
_lane_trips = {}  # device -> int64 [1]: each call's longest lane's trips, summed
_hull_scratch = {}  # device -> int32 [2]: the fused kernel's per-call scratch (zero between calls)


def reset_counts():
    global trips, syncs, plain_cuda_calls
    trips = syncs = plain_cuda_calls = 0
    for t in _lane_trips.values():
        t.zero_()


def _trip_total(dev):
    total = _lane_trips.get(dev)
    if total is None:
        total = _lane_trips[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return total


def read_lane_trips() -> int:
    """The longest lane's trips of every expand_box call since the last
    reset_counts(), summed (one host read per device)."""
    return sum(int(t.item()) for t in _lane_trips.values())


def lane_trips(seed_lo, seed_hi, lo, hi, seed_free):
    """Trips each lane of an `expand_box` call was live [L] (int64): its
    growth in cells plus its six retirements, 0 for a blocked seed (a
    lane cut by the trip cap ran the cap's trips instead)."""
    grown = (seed_lo - lo).sum(-1) + (hi - seed_hi).sum(-1)
    return (grown.long() + 6) * seed_free.long()


def default_axis_order(n_lanes: int, device):
    return torch.arange(6, dtype=torch.int64, device=device).expand(n_lanes, 6)


def expand_box(gw: GridWorld, lo, hi, axis_order, max_radius_cells: int = 0,
               agent=None, plain: bool = False):
    """Greedy round-robin box expansion of L lanes at once.

    lo, hi: int32 [L, 3]; axis_order: int [L, 6] permutation of the six
    directions, tried cyclically. A direction retires when one more cell
    along it would hit an obstacle, leave the world, or (with
    `max_radius_cells` > 0) grow beyond that many cells past the seed
    face. `agent` [L]: each lane's agent in a per-agent world view.
    Returns (lo, hi, ok) where ok = the seed box itself was free.

    CUDA tensors go to the kernel (one launch, no host read; a failure
    to build or launch raises), CPU tensors to `expand_box_plain`;
    `plain` forces the plain loop on any device, for comparisons. Any
    other device raises."""
    global last_lanes
    dev = lo.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no SFC expansion for device {dev}")
    r = max_radius_cells
    max_trips = _max_trips(r)
    total = _trip_total(dev)
    if plain or dev.type == "cpu":
        out = expand_box_plain(gw, lo, hi, axis_order, r, agent, max_trips)
    else:
        out = expand_box_kernel(gw, lo, hi, axis_order, r, agent)
    if len(lo):  # a lane the cap cuts was live for all max_trips trips
        total += lane_trips(lo, hi, *out).clamp(max=max_trips).max()
    last_lanes = (lo, hi, *out)
    return out


def _max_trips(max_radius_cells: int) -> int:
    r = max_radius_cells
    return min(_MAX_ITERS, 6 * r + 6) if r > 0 else _MAX_ITERS


def expand_box_kernel(gw: GridWorld, lo, hi, axis_order, max_radius_cells: int = 0,
                      agent=None):
    """The kernel's launch alone, as `expand_box` makes it (CUDA tensors
    only; no counter but the wrapper's launches): what `chip_smoke.py`
    times as the kernel's ms."""
    return sfc_cuda.expand_box_cuda(
        gw.blocked_cumsum, gw.dims, lo.contiguous(), hi.contiguous(),
        axis_order.to(torch.int64).contiguous(), max_radius_cells, _max_trips(max_radius_cells),
        None if agent is None else agent.to(torch.int64).contiguous())


def expand_box_plain(gw: GridWorld, lo, hi, axis_order, max_radius_cells: int,
                     agent, max_trips: int):
    """The kernel's plain version: all lanes advance together in one
    masked loop of at most `max_trips` trips, which leaves finished
    lanes frozen (as under the JAX loop's vmap) and reads "is any lane
    live?" back to the host every _EXIT_CHECK trips."""
    global trips, syncs
    dev = lo.device
    L = lo.shape[0]
    dims = gw.dims_t
    seed_free = (gw.box_is_free(lo, hi, agent) & torch.all(lo >= 0, dim=-1)
                 & torch.all(hi <= dims, dim=-1))
    if max_radius_cells > 0:
        lo_min = lo - max_radius_cells
        hi_max = hi + max_radius_cells
    else:
        lo_min = torch.full_like(lo, -(2**30))
        hi_max = torch.full_like(hi, 2**30)

    dir_axis = torch.tensor(_DIR_AXIS, device=dev)
    dir_sign = torch.tensor(_DIR_SIGN, dtype=torch.int32, device=dev)
    eye3 = torch.eye(3, dtype=torch.int32, device=dev)
    idx6 = torch.arange(6, device=dev)
    active = seed_free[:, None].expand(L, 6).clone()
    ptr = torch.zeros(L, dtype=torch.int64, device=dev)

    for trip in range(max_trips):
        if trip % _EXIT_CHECK == 0:
            syncs += 1
            if not bool(active.any()):
                break
        trips += 1
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
        ok = live & in_bounds & gw.box_is_free(nlo, nhi, agent)
        lo = torch.where(ok[:, None], nlo, lo)
        hi = torch.where(ok[:, None], nhi, hi)
        keep = torch.gather(active, 1, slot[:, None])[:, 0] & ok
        active = active.scatter(1, slot[:, None], keep[:, None])
        ptr = torch.where(ok, (slot + 1) % 6, slot)
    return lo, hi, seed_free


def sfc_to_world(gw: GridWorld, sfc_lo, sfc_hi, margin: float):
    """Lattice boxes → world boxes with margin compensation: each face
    not on the world boundary moves outward by margin − ⌊margin/res⌋·res."""
    delta = _face_delta(margin, gw.resolution)
    dims = gw.dims_t
    lo_pt = gw.lattice_to_point(sfc_lo)
    hi_pt = gw.lattice_to_point(sfc_hi)
    lo_pt = torch.where(sfc_lo > 0, lo_pt - delta, lo_pt)
    hi_pt = torch.where(sfc_hi < dims, hi_pt + delta, hi_pt)
    return lo_pt, hi_pt


def goal_directed_axis_order(box_lo_pt, box_hi_pt, goal):
    """Axis try-order [..., 6] by descending |goal − box mid| (a stable
    sort), each axis's toward-goal direction first; the away directions
    follow in mirrored order. Points [..., 3]."""
    delta = goal - 0.5 * (box_lo_pt + box_hi_pt)
    offsets = torch.where(delta > 0, 3, 0)
    order = torch.sort(-torch.abs(delta), dim=-1, stable=True).indices
    off = torch.gather(offsets, -1, order)
    return torch.cat([order + off, (order + (3 - off)).flip(-1)], dim=-1)


def _contains(gw: GridWorld, lo, hi, pts, margin: float, eps: float):
    """Containment of pts [..., P, 3] in the world boxes of lo, hi [..., 3]
    with margin compensation `margin`, to eps."""
    lo_w, hi_w = sfc_to_world(gw, lo, hi, margin)
    inside = (pts >= lo_w[..., None, :] - eps) & (pts <= hi_w[..., None, :] + eps)
    return torch.all(inside.flatten(-2), dim=-1)


def _superset_of(gw: GridWorld, lo, hi, pts):
    """Containment in the boxes as the expansion compensates them (the
    world's own margin), to 1e-6."""
    return _contains(gw, lo, hi, pts, gw.radius, 1e-6)


def _update_sfc_plain(gw: GridWorld, mode: str, sfc_lo, sfc_hi, init_done, last_pt,
                      cgoal, wpt, pos, init_ctrl, margin: float, max_radius_cells: int,
                      plain: bool):
    """The torch body of `update_sfc`'s lattice boxes (the JAX package's
    update_sfc_fused): seeding and selection in torch around one
    `expand_box` of all lanes.

    Lane 0 seeds the initialization box from the current position. Then,
    by `mode`:
    - 'hull': lanes 1-2 grow the new last box from {trajectory end,
      current goal, next waypoint} (round seed) and from {trajectory end,
      current goal} (floor/ceil seed intersected with the previous last
      box); the boxes shift one segment and the new last box takes lane
      1, else lane 2, else the previous last box.
    - 'point': lane 1 grows the new last box from the trajectory end
      (intersected with the previous last box) in the goal-directed axis
      order; the boxes shift one segment, the new last box falling back
      to the previous one.
    - 'substep': lanes 1-2 as in 'hull', both also required to contain
      the whole initial last segment; lanes 3.. grow a box from each
      initial segment m < M−1. Box m takes the first of (previous box
      m+1, previous box m, its own lane's box) that contains initial
      segment m (with `margin`), else keeps previous box m; the last box
      is the rebuild, or the previous last box if neither lane holds.

    sfc_lo, sfc_hi: int32 [A, M, 3]; init_done: bool [A]; last_pt, cgoal,
    wpt, pos: [A, 3]; init_ctrl: [A, M, N, 3] (read in 'substep' mode).
    In a per-agent view of the world (integral images [A, ...]) agent
    a's lanes read image a. `plain` takes the plain loop for the
    expansion too. Returns (new_lo, new_hi) [A, M, 3]."""
    global plain_cuda_calls
    dev = sfc_lo.device
    if mode == "hull" and dev.type == "cuda":
        plain_cuda_calls += 1
    A, M, _ = sfc_lo.shape
    prev_lo, prev_hi = sfc_lo[:, -1], sfc_hi[:, -1]

    def within_prev(lo, hi):
        """The seed as it is if the previous last box holds it, else its
        intersection with that box."""
        included = (torch.all(lo >= prev_lo, dim=-1)
                    & torch.all(hi <= prev_hi, dim=-1))[:, None]
        return (torch.where(included, lo, torch.maximum(lo, prev_lo)),
                torch.where(included, hi, torch.minimum(hi, prev_hi)))

    hull_pts = torch.stack([last_pt, cgoal], dim=1)  # [A, 2, 3]
    los = [gw.point_to_lattice_floor(pos)]
    his = [gw.point_to_lattice_ceil(pos)]
    order_d = default_axis_order(A, dev)
    orders = [order_d]
    if mode == "point":
        lo_p, hi_p = within_prev(gw.point_to_lattice_floor(last_pt),
                                 gw.point_to_lattice_ceil(last_pt))
        los.append(lo_p)
        his.append(hi_p)
        orders.append(goal_directed_axis_order(gw.lattice_to_point(lo_p),
                                               gw.lattice_to_point(hi_p), cgoal))
    else:
        pts_g = torch.cat([hull_pts, wpt[:, None]], dim=1)  # [A, 3, 3]
        lo2, hi2 = within_prev(gw.point_to_lattice_floor(hull_pts.amin(dim=1)),
                               gw.point_to_lattice_ceil(hull_pts.amax(dim=1)))
        los += [gw.point_to_lattice_round(pts_g.amin(dim=1)), lo2]
        his += [gw.point_to_lattice_round(pts_g.amax(dim=1)), hi2]
        orders += [order_d, order_d]
    seeds_lo, seeds_hi = torch.stack(los, dim=1), torch.stack(his, dim=1)
    lane_order = torch.stack(orders, dim=1)
    if mode == "substep":
        segs = init_ctrl[:, :M - 1]  # [A, M-1, N, 3]
        seeds_lo = torch.cat([seeds_lo, gw.point_to_lattice_floor(segs.amin(dim=2))], dim=1)
        seeds_hi = torch.cat([seeds_hi, gw.point_to_lattice_ceil(segs.amax(dim=2))], dim=1)
        lane_order = torch.cat([lane_order, order_d[:, None].expand(A, M - 1, 6)], dim=1)

    # lanes agent-major: [A, L, 3] → [A·L, 3]
    L = seeds_lo.shape[1]
    agent = None
    if gw.blocked_cumsum.dim() == 4:
        agent = torch.arange(A, device=dev).repeat_interleave(L)
    e_lo, e_hi, e_ok = expand_box(
        gw, seeds_lo.reshape(A * L, 3), seeds_hi.reshape(A * L, 3),
        lane_order.reshape(A * L, 6), max_radius_cells=max_radius_cells, agent=agent,
        plain=plain)
    e_lo = e_lo.reshape(A, L, 3)
    e_hi = e_hi.reshape(A, L, 3)
    e_ok = e_ok.reshape(A, L)

    if mode == "point":
        ok = e_ok[:, 1:2]
        new_lo = torch.where(ok, e_lo[:, 1], prev_lo)
        new_hi = torch.where(ok, e_hi[:, 1], prev_hi)
    else:
        ok1 = e_ok[:, 1] & _superset_of(gw, e_lo[:, 1], e_hi[:, 1], pts_g)
        ok2 = e_ok[:, 2] & _superset_of(gw, e_lo[:, 2], e_hi[:, 2], hull_pts)
        if mode == "substep":
            # the new last box must hold the whole initial last segment (a
            # real moving arc here, not LSC's stationary horizon point)
            ok1 &= _superset_of(gw, e_lo[:, 1], e_hi[:, 1], init_ctrl[:, M - 1])
            ok2 &= _superset_of(gw, e_lo[:, 2], e_hi[:, 2], init_ctrl[:, M - 1])
        ok1, ok2 = ok1[:, None], ok2[:, None]
        new_lo = torch.where(ok1, e_lo[:, 1], torch.where(ok2, e_lo[:, 2], prev_lo))
        new_hi = torch.where(ok1, e_hi[:, 1], torch.where(ok2, e_hi[:, 2], prev_hi))
    if mode == "substep":
        shift_lo, shift_hi = sfc_lo[:, 1:], sfc_hi[:, 1:]
        hold_lo, hold_hi = sfc_lo[:, :M - 1], sfc_hi[:, :M - 1]
        c_shift = _contains(gw, shift_lo, shift_hi, segs, margin, 1e-3)[..., None]
        c_hold = _contains(gw, hold_lo, hold_hi, segs, margin, 1e-3)[..., None]
        eok = (e_ok[:, 3:] & _contains(gw, e_lo[:, 3:], e_hi[:, 3:], segs, margin,
                                       1e-3))[..., None]
        ulo = torch.where(c_shift, shift_lo,
                          torch.where(c_hold, hold_lo, torch.where(eok, e_lo[:, 3:], hold_lo)))
        uhi = torch.where(c_shift, shift_hi,
                          torch.where(c_hold, hold_hi, torch.where(eok, e_hi[:, 3:], hold_hi)))
        # keep_new: new_lo/new_hi already hold the previous last box where
        # neither lane does
        ulo = torch.cat([ulo, new_lo[:, None]], dim=1)
        uhi = torch.cat([uhi, new_hi[:, None]], dim=1)
    else:
        ulo = torch.cat([sfc_lo[:, 1:], new_lo[:, None]], dim=1)
        uhi = torch.cat([sfc_hi[:, 1:], new_hi[:, None]], dim=1)
    ilo = e_lo[:, 0:1].expand(A, M, 3)
    ihi = e_hi[:, 0:1].expand(A, M, 3)
    done = init_done[:, None, None]
    return torch.where(done, ulo, ilo), torch.where(done, uhi, ihi)


def update_sfc(gw: GridWorld, mode: str, sfc_lo, sfc_hi, init_done, last_pt, cgoal, wpt, pos,
               init_ctrl, margin: float, max_radius_cells: int = 0, plain: bool = False):
    """The planner's SFC stage: the fleet's new boxes (the JAX package's
    update_sfc_fused) and their world boxes with `margin` (sfc_to_world),
    (new_lo, new_hi, lo_w, hi_w) [A, M, 3]. In 'hull' mode CUDA tensors
    go to the fused kernel (one launch, no host read; a failure to build
    or launch raises). Every other case, and `plain=True` on any device
    (for comparisons), runs the torch body `_update_sfc_plain`, then
    `sfc_to_world`; its expansion takes the kernel on CUDA tensors unless
    `plain`."""
    global last_lanes
    if mode not in ("hull", "point", "substep"):
        raise ValueError(f"unknown SFC mode {mode!r}")
    dev = sfc_lo.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no SFC update for device {dev}")
    if mode != "hull" or plain or dev.type != "cuda":
        lo, hi = _update_sfc_plain(gw, mode, sfc_lo, sfc_hi, init_done, last_pt, cgoal, wpt,
                                   pos, init_ctrl, margin, max_radius_cells, plain)
        return (lo, hi, *sfc_to_world(gw, lo, hi, margin))
    scratch = _hull_scratch.get(dev)
    if scratch is None:
        scratch = _hull_scratch[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    res = gw.resolution
    out = sfc_cuda.update_sfc_hull_cuda(
        gw.blocked_cumsum, gw.dims, [int(v) for v in gw.origin_idx], res,
        sfc_lo.contiguous(), sfc_hi.contiguous(), init_done.contiguous(),
        last_pt, cgoal, wpt, pos,
        _face_delta(gw.radius, res), _face_delta(margin, res), max_radius_cells,
        _max_trips(max_radius_cells), _trip_total(dev), scratch)
    last_lanes = out[4:]
    return out[:4]


def _face_delta(margin: float, res: float) -> float:
    """sfc_to_world's outward shift of a face not on the world boundary."""
    return margin - math.floor(margin / res + 1e-9) * res
