"""The agent-sharded planning step over torch.distributed (port of
lsc_dr_planner_tpu/parallel/mesh.py).

The reference plans its agents one after another in one process
(multi_sync_simulator.cpp:354-374); its inter-agent interface is the
per-neighbour state and previous trajectory broadcast
(agent_manager.cpp:184-199). Here the fleet's agent axis is split over
the ranks of a process group, one rank per device: rank r holds agents
r·A/d .. (r+1)·A/d − 1 of every agent-leading tensor, and the dynamic
obstacles and scalars are replicated. The sharded step all-gathers the
neighbour candidate fields of the whole fleet (position, velocity,
previous solution, radius, downwash, goal), selects each local agent's
OA nearest in-range others by global id with the tie order of
`FleetPlanner._neighbor_slots`, and runs the step on the local block
with that `NeighborData` (`_step_impl(..., neighbors=)`).

Each rank solves its own QP batch. The ADMM kernel's exit test and the
compacted straggler rescue (the 64 most infeasible agents) are per
rank, as in the JAX package's halo step, which runs `_step_impl` per
device inside `shard_map`; the JAX package's all-gather step is one SPMD
program whose exit and rescue span the fleet. A fleet-wide exit would
need an all-reduce every 8-iteration chunk, which would break the
kernel's queued launches whose exit is counted on the device
(ops/qp_cuda.py). So results can differ from the one-device step where
the loop's exit chunk differs (within the JAX tests' one-chunk
tolerance), and, at d > 1 with more than 64 agents a rank, where the
rescue picks its 64 agents within the rank instead of across the fleet.

The backend comes from the device alone: NCCL for a CUDA device, gloo
for the CPU; nothing falls back from one to the other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from lsc_dr_planner_tpu_torch.device import resolve as resolve_device
from lsc_dr_planner_tpu_torch.planner.pipeline import (
    FleetArrays,
    FleetPlanner,
    NeighborData,
    StepInputs,
    StepOutputs,
)


def rank_device(device, rank: int) -> torch.device:
    """The device of `rank`: `device` itself, or for "cuda" without an
    index the rank's own card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return resolve_device(dev)


def init_group(device, rank: int, world_size: int, init_method: str):
    """Join the default process group as `rank` of `world_size`: NCCL on
    a CUDA device (the rank's card made current first), gloo on the CPU.
    Returns the group."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, rank=rank,
                                world_size=world_size, device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world_size)
    return dist.group.WORLD


def agent_leading(name: str, x) -> bool:
    """Whether a leaf of FleetArrays or StepInputs leads on the agent
    axis: every tensor but the dynamic obstacles and 0-d ones (the JAX
    package's `_spec_for`); absent leaves and `planner_seq` do not."""
    return torch.is_tensor(x) and x.dim() > 0 and not name.startswith("dynobs")


def map_agent_leading(obj, fn):
    """`obj` (FleetArrays or StepInputs) with `fn` applied to every
    agent-leading tensor; the other leaves are kept as they are."""
    return type(obj)(**{
        f.name: (fn(v) if agent_leading(f.name, v) else v)
        for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)})


def shard_step_inputs(fleet: FleetArrays, inp: StepInputs, rank: int, world_size: int):
    """Rank `rank`'s contiguous block of every agent-leading tensor of
    `fleet` and `inp` (the known maps and the duals included); dynamic
    obstacles and scalars whole. A must be a multiple of `world_size`."""
    A = inp.pos.shape[0]
    if A % world_size:
        raise ValueError(f"agent count {A} must divide evenly into {world_size} ranks "
                         "(pad the fleet or change the group)")
    Al = A // world_size
    sl = slice(rank * Al, (rank + 1) * Al)
    return map_agent_leading(fleet, lambda v: v[sl]), map_agent_leading(inp, lambda v: v[sl])


# neighbour candidate fields, packed into one float32 row per agent so that
# one collective carries them: (name, width)
def _candidate_layout(M: int, N: int):
    return (("pos", 3), ("vel", 3), ("goal", 3), ("radius", 1), ("downwash", 1),
            ("has_prev", 1), ("prev_ctrl", M * N * 3))


def pack_candidates(fleet: FleetArrays, inp: StepInputs) -> torch.Tensor:
    """The local agents' neighbour candidate fields as one [Al, F] float32
    tensor (exact: has_prev as 0/1)."""
    Al = inp.pos.shape[0]
    f32 = torch.float32
    cols = dict(pos=inp.pos, vel=inp.vel, goal=inp.current_goal,
                radius=fleet.radius[:, None], downwash=fleet.downwash[:, None],
                has_prev=inp.has_prev[:, None].to(f32),
                prev_ctrl=inp.prev_ctrl.reshape(Al, -1))
    return torch.cat([cols[k].to(f32) for k, _ in _candidate_layout(
        inp.prev_ctrl.shape[1], inp.prev_ctrl.shape[2])], dim=1)


def select_neighbors(planner: FleetPlanner, pos_l: torch.Tensor, ids_l: torch.Tensor,
                     cand: torch.Tensor, cand_ids: torch.Tensor,
                     cand_ok: torch.Tensor) -> NeighborData:
    """Each local agent's OA nearest in-range candidates (`_neighbor_slots`'
    rule: L∞ distance, self and dead candidates at 1e9, out of
    communication range at 1e9, a stable sort so the earlier candidate
    wins a tie; candidates in global id order give its slots exactly)."""
    p = planner.param
    M, N, OA = p.M, p.n + 1, planner.O_agents
    C = cand.shape[0]
    if C < OA:  # the selection needs at least OA candidates: dead slots
        pad = OA - C
        cand = torch.cat([cand, cand.new_zeros((pad, cand.shape[1]))])
        cand_ids = torch.cat([cand_ids, cand_ids.new_full((pad,), -1)])
        cand_ok = torch.cat([cand_ok, cand_ok.new_zeros((pad,))])
    fields, at = {}, 0
    for name, w in _candidate_layout(M, N):
        fields[name] = cand[:, at:at + w]
        at += w
    dist_ = (pos_l[:, None] - fields["pos"][None]).abs().amax(dim=-1)  # [Al, C]
    dist_ = torch.where((ids_l[:, None] == cand_ids[None]) | ~cand_ok[None], 1e9, dist_)
    if p.communication_range > 0:
        dist_ = torch.where(dist_ < p.communication_range, dist_, 1e9)
    srt = torch.sort(-dist_, dim=-1, descending=True, stable=True)
    order = srt.indices[:, :OA]
    Al = pos_l.shape[0]
    return NeighborData(
        prev_ctrl=fields["prev_ctrl"][order].reshape(Al, OA, M, N, 3),
        has_prev=fields["has_prev"][order][..., 0] > 0.5,
        pos=fields["pos"][order], vel=fields["vel"][order],
        radius=fields["radius"][order][..., 0], downwash=fields["downwash"][order][..., 0],
        goal=fields["goal"][order], valid=-srt.values[:, :OA] < 1e8)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[n, ...] on every rank → [d·n, ...], rank-major (bool as uint8 on
    the wire)."""
    d = dist.get_world_size(group)
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(wire) for _ in range(d)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts)
    return out.bool() if x.dtype == torch.bool else out


def make_sharded_step(planner: FleetPlanner, group=None):
    """step(fleet_l, inp_l) → this rank's block of StepOutputs, for
    `shard_step_inputs`' blocks: the candidates of the whole fleet by
    all-gather, then the step with the neighbour override."""

    def step(fleet_l: FleetArrays, inp_l: StepInputs) -> StepOutputs:
        rank = dist.get_rank(group)
        Al = inp_l.pos.shape[0]
        dev = inp_l.pos.device
        cand = all_gather_rows(pack_candidates(fleet_l, inp_l), group)
        ids = torch.arange(cand.shape[0], device=dev)
        nd = select_neighbors(planner, inp_l.pos, ids[rank * Al:(rank + 1) * Al], cand, ids,
                              torch.ones(cand.shape[0], dtype=torch.bool, device=dev))
        return planner._step_impl(fleet_l, inp_l, neighbors=nd)

    return step


def gather_outputs(out_l: StepOutputs, group=None) -> StepOutputs:
    """The whole fleet's StepOutputs on every rank, from each rank's block."""
    return StepOutputs(**{
        f.name: (None if getattr(out_l, f.name) is None
                 else all_gather_rows(getattr(out_l, f.name), group))
        for f in dataclasses.fields(StepOutputs)})


def _dryrun_rank(rank: int, n: int, device, init_method: str):
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.parallel import halo

    torch.set_num_threads(1)
    dev = rank_device(device, rank)
    group = init_group(dev, rank, n, init_method)
    try:
        A = 2 * n
        p, planner, fleet, inp = workload.build_fleet(A, device=dev)
        step = make_sharded_step(planner, group)
        out = gather_outputs(step(*shard_step_inputs(fleet, inp, rank, n)), group)
        want = (A, p.M, p.n + 1, 3)
        assert tuple(out.desired_ctrl.shape) == want, out.desired_ctrl.shape
        # the halo exchange on the spatially sorted fleet
        perm = torch.as_tensor(halo.spatial_permutation(inp.pos.cpu().numpy()), device=dev)
        fleet_p, inp_p = halo.permute_agents(fleet, inp, perm)
        hops = halo.required_hops(inp_p.pos.cpu().numpy(), n, p.communication_range)
        hstep = halo.make_halo_step(planner, group, hops)
        out2 = gather_outputs(hstep(*shard_step_inputs(fleet_p, inp_p, rank, n)), group)
        assert out2.desired_ctrl.shape == out.desired_ctrl.shape
        assert torch.isfinite(out.desired_ctrl).all() and torch.isfinite(out2.desired_ctrl).all()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device="cuda", init_method: Optional[str] = None):
    """One all-gather step and one halo step of `build_fleet(2·n)` over an
    n-rank group (spawned processes; one rank runs here), with the shapes
    checked: the counterpart of `__graft_entry__.dryrun_multichip`.
    `init_method` defaults to a file under a fresh temporary directory."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        init_method = init_method or f"file://{tmp}/init"
        args = (n, device, init_method)
        if n == 1:
            _dryrun_rank(0, *args)
        else:
            torch.multiprocessing.spawn(_dryrun_rank, args=args, nprocs=n)
