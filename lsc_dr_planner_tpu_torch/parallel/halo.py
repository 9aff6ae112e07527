"""Neighbourhood halo exchange: spatially tiled neighbour communication
over the ranks (port of lsc_dr_planner_tpu/parallel/halo.py).

The reference's inter-agent interface is a range-limited broadcast: each
step every agent receives position, velocity, goal, radius, downwash and
previous trajectory from the neighbours within L∞ `communication_range`
(multi_sync_simulator.cpp:305-352, agent_manager.cpp:184-199). The
all-gather step (mesh.py) gives every rank the whole fleet's candidates,
O(A) bytes per rank per step. Here:

  * The host sorts the fleet along one axis (`spatial_permutation`), so
    rank i holds a contiguous slab of the world. Any in-range neighbour
    of an agent in slab i lies in slabs i−h..i+h for a hop count h
    (`required_hops` checks this fleet's slab widths).
  * Each rank sends its candidate block to the ranks ±1..±h and receives
    theirs (`dist.batch_isend_irecv`), O(A/d · h) bytes, then selects
    each local agent's OA nearest in-range candidates over its
    (2h+1)·A/d candidates. The slabs form a line, not a torus: a block
    whose source rank is out of range is dead; dead slots pad the
    candidates when there are fewer than OA.
  * The rest of the step is per agent and runs on the local block
    (`_step_impl(..., neighbors=)`); each rank solves its own QP batch
    (mesh.py says where that differs from one device).

The live candidate blocks are ordered by source rank, so the candidates
are in global id order and the selection's tie rule is the global
gather's: when every in-range neighbour lies within h hops, the step
equals the one-device step. (Slots left without an in-range neighbour
are invalid in both; what they hold can differ.)
"""

from __future__ import annotations


import numpy as np
import torch
import torch.distributed as dist

from lsc_dr_planner_tpu_torch.parallel.mesh import (
    map_agent_leading,
    pack_candidates,
    select_neighbors,
)
from lsc_dr_planner_tpu_torch.planner.pipeline import (
    FleetArrays,
    FleetPlanner,
    StepInputs,
    StepOutputs,
)


def spatial_permutation(pos: np.ndarray, sort_axis: int = 0) -> np.ndarray:
    """Host-side agent permutation: sort by one coordinate so equal-count
    contiguous index blocks are spatial slabs. Returns `perm` such that
    `x_sorted = x[perm]` for every agent-axis leaf."""
    return np.argsort(np.asarray(pos)[:, sort_axis], kind="stable")


def required_hops(pos: np.ndarray, n_shards: int, comm_range: float,
                  sort_axis: int = 0) -> int:
    """Minimum hop count h such that every in-range neighbour of an
    agent in slab i lies in slabs i−h..i+h, for THIS fleet layout
    (agents assumed already sorted along sort_axis)."""
    x = np.sort(np.asarray(pos)[:, sort_axis])
    A = len(x)
    # the ranks take equal contiguous blocks; with a ragged split the
    # slab starts below would drift from the actual layout and
    # under-estimate the hop bound
    if A % n_shards != 0:
        raise ValueError(
            f"agent count {A} must divide evenly into {n_shards} shards "
            "(pad the fleet or change the mesh)"
        )
    Al = A // n_shards
    # slab boundaries (first coordinate of each slab)
    starts = x[np.arange(n_shards) * Al]
    h = 1
    for i in range(n_shards):
        lo = starts[i] - comm_range
        hi = (x[-1] if i == n_shards - 1 else starts[i + 1]) + comm_range
        first = int(np.searchsorted(starts, lo, side="right")) - 1
        last = int(np.searchsorted(starts, hi, side="right")) - 1
        h = max(h, i - max(first, 0), min(last, n_shards - 1) - i)
    return h


def permute_agents(fleet: FleetArrays, inp: StepInputs, perm: torch.Tensor):
    """`fleet` and `inp` with every agent-leading tensor
    (`mesh.agent_leading`) reordered by `perm`."""
    return map_agent_leading(fleet, lambda v: v[perm]), map_agent_leading(inp, lambda v: v[perm])


def make_halo_step(planner: FleetPlanner, group=None, hops: int = 1):
    """step(fleet_l, inp_l) → this rank's block of StepOutputs, for
    `mesh.shard_step_inputs`' blocks of a spatially sorted fleet
    (`spatial_permutation`), with `hops >= required_hops(...)` for the
    one-device step's neighbour slots."""

    def step(fleet_l: FleetArrays, inp_l: StepInputs) -> StepOutputs:
        d, me = dist.get_world_size(group), dist.get_rank(group)
        Al = inp_l.pos.shape[0]
        dev = inp_l.pos.device
        mine = pack_candidates(fleet_l, inp_l)
        # live blocks by source rank (global id order), then the dead ones
        srcs = sorted(range(me - hops, me + hops + 1), key=lambda r: (not 0 <= r < d, r))
        blocks = {me: mine}
        ops = []
        for src in srcs:
            if src != me and 0 <= src < d:
                blocks[src] = torch.empty_like(mine)
                ops.append(dist.P2POp(dist.isend, mine, src, group))
                ops.append(dist.P2POp(dist.irecv, blocks[src], src, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        cand = torch.cat([blocks.get(src, torch.zeros_like(mine)) for src in srcs])
        cand_ids = torch.cat([src * Al + torch.arange(Al, device=dev) for src in srcs])
        cand_ok = torch.cat([torch.full((Al,), 0 <= src < d, dtype=torch.bool, device=dev)
                             for src in srcs])
        ids_l = me * Al + torch.arange(Al, device=dev)
        nd = select_neighbors(planner, inp_l.pos, ids_l, cand, cand_ids, cand_ok)
        return planner._step_impl(fleet_l, inp_l, neighbors=nd)

    return step
