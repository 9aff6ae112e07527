"""Multi-device scaling harness: times the agent-sharded step
(mesh.make_sharded_step) at a range of group sizes and reports
throughput and parallel efficiency (port of
lsc_dr_planner_tpu/parallel/scaling.py).

Run inside every rank of a process group (mesh.init_group). A row of d
devices runs on ranks 0..d−1 (a subgroup when d is below the group's
size); rows larger than the group are skipped. A machine with one card
gives the one-rank row only: NCCL takes one rank per device, so no
scaling number can come from it.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch
import torch.distributed as dist

from lsc_dr_planner_tpu_torch.device import DEFAULT as DEFAULT_DEVICE


def measure_scaling(device_counts: Sequence[int] = (1, 2, 4, 8), A_per_device: int = 16,
                    steps: int = 10, fixed_total: bool = False, device=DEFAULT_DEVICE,
                    group=None):
    """Time the sharded step of `workload.build_fleet(A)` on groups of
    growing size. Weak scaling by default (A = A_per_device × d); with
    `fixed_total`, strong scaling at A = A_per_device × max(device_counts).
    Returns the rows (dicts: devices, agents, step_ms, steps_per_s,
    agent_steps_per_s, efficiency) on the ranks of each row's group; a
    row's step time is its slowest rank's."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.parallel import mesh

    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    dev = mesh.rank_device(device, rank)
    rows = []
    max_dev = max(device_counts)
    for nd in device_counts:
        if nd > world:
            continue
        # every rank of the group takes part in forming a subgroup
        sub = group if nd == world else dist.new_group(list(range(nd)))
        if rank < nd:
            A = A_per_device * (max_dev if fixed_total else nd)
            _, planner, fleet, inp = workload.build_fleet(A, device=dev)
            step = mesh.make_sharded_step(planner, sub)
            fleet_l, inp_l = mesh.shard_step_inputs(fleet, inp, rank, nd)
            step(fleet_l, inp_l)  # first call: builds and caches
            _sync(dev, sub)
            t0 = time.perf_counter()
            for _ in range(steps):
                out = step(fleet_l, inp_l)
            _sync(dev, sub)
            dt = torch.tensor([(time.perf_counter() - t0) / steps], dtype=torch.float64,
                              device=dev)
            dist.all_reduce(dt, op=dist.ReduceOp.MAX, group=sub)
            dt = float(dt.item())
            assert torch.isfinite(out.desired_ctrl).all()
            rows.append({"devices": nd, "agents": A, "step_ms": dt * 1e3,
                         "steps_per_s": 1.0 / dt, "agent_steps_per_s": A / dt})
        dist.barrier(group)

    # parallel efficiency against the one-device row
    base = next((r for r in rows if r["devices"] == 1), None)
    for r in rows:
        if base is None:
            r["efficiency"] = float("nan")
        elif fixed_total:
            r["efficiency"] = base["step_ms"] / (r["step_ms"] * r["devices"])
        else:  # weak scaling: perfect = constant step time
            r["efficiency"] = base["step_ms"] / r["step_ms"]
    return rows


def _sync(dev: torch.device, group):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier(group)
