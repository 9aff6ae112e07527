"""Rank workers for the multi-device tests: each runs in a spawned
process of an n-rank gloo group on the CPU, reads its case from files
and writes rank 0's results to `out.npz` beside them. They live in the
package so that a spawned rank imports the port alone, never the test
module (whose collection imports jax).

A case directory holds `case.json` (the kind, the `Param` fields and
the planner's options) and `case.npz` (the world, fleet and step input
fields, prefixed `world_`, `fleet_`, `inp_`).

    torch.multiprocessing.spawn(testing.run_case, args=(n, case_dir), nprocs=n)
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from lsc_dr_planner_tpu_torch import convert
from lsc_dr_planner_tpu_torch.config import Param
from lsc_dr_planner_tpu_torch.parallel import halo, mesh
from lsc_dr_planner_tpu_torch.planner.pipeline import FleetPlanner


def _fields(z, prefix):
    return {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}


def _advance(inp, out):
    """The steady-state loop's next inputs: the outputs fed back."""
    return dataclasses.replace(
        inp, prev_ctrl=out.desired_ctrl, has_prev=torch.ones_like(inp.has_prev),
        current_goal=out.current_goal, sfc_lo=out.sfc_lo, sfc_hi=out.sfc_hi,
        sfc_initialized=out.sfc_initialized, planner_seq=inp.planner_seq + 1)


def _steps(case: dict, case_dir: Path, rank: int, n: int, group) -> dict:
    """'allgather' / 'halo': `case['iterations']` sharded steps of the
    case's fleet; the whole fleet's outputs of the last one."""
    z = np.load(case_dir / "case.npz")
    world = convert.grid_world_from_numpy(_fields(z, "world_"), "cpu")
    fleet = convert.fleet_from_numpy(_fields(z, "fleet_"), "cpu")
    inp = convert.inputs_from_numpy(_fields(z, "inp_"), "cpu")
    A = inp.pos.shape[0]
    planner = FleetPlanner(Param(**case["param"]), world, A, **case["planner"])
    if case["kind"] == "halo":
        step = halo.make_halo_step(planner, group, case["hops"])
    else:
        step = mesh.make_sharded_step(planner, group)
    fleet_l, inp_l = mesh.shard_step_inputs(fleet, inp, rank, n)
    out_l = step(fleet_l, inp_l)
    for _ in range(case.get("iterations", 1) - 1):
        inp_l = _advance(inp_l, out_l)
        out_l = step(fleet_l, inp_l)
    return convert.outputs_to_numpy(mesh.gather_outputs(out_l, group))


def _montecarlo(case: dict, case_dir: Path, rank: int, n: int, group) -> dict:
    """'montecarlo': the scenario split of `MonteCarloSimulator` over the
    group; every scenario's final positions and collision flag."""
    from lsc_dr_planner_tpu_torch.mission import generate_random_mission
    from lsc_dr_planner_tpu_torch.sim.montecarlo import MonteCarloSimulator

    m = generate_random_mission(**case["mission"])
    mc = MonteCarloSimulator(Param(**case["param"]), m, log_dir=str(case_dir),
                             device="cpu", group=group, host_workers=1, **case["montecarlo"])
    results = mc.run(max_iterations=case["iterations"])
    return {"pos": np.stack([sim.pos for sim in mc.sims]),
            "is_collided": np.asarray([r["is_collided"] for r in results])}


def _scaling(case: dict, case_dir: Path, rank: int, n: int, group) -> dict:
    """'scaling': `measure_scaling`'s rows (as JSON)."""
    from lsc_dr_planner_tpu_torch.parallel.scaling import measure_scaling

    rows = measure_scaling(device="cpu", group=group, **case["scaling"])
    return {"rows": np.asarray(json.dumps(rows))}


KINDS = {"allgather": _steps, "halo": _steps, "montecarlo": _montecarlo,
         "scaling": _scaling}


def run_case(rank: int, n: int, case_dir: str):
    """One rank of the case in `case_dir` (spawned; see the module doc)."""
    torch.set_num_threads(1)
    case_dir = Path(case_dir)
    case = json.loads((case_dir / "case.json").read_text())
    group = mesh.init_group("cpu", rank, n, f"file://{case_dir}/init")
    try:
        res = KINDS[case["kind"]](case, case_dir, rank, n, group)
        if rank == 0:
            np.savez(case_dir / "out.npz", **{k: v for k, v in res.items() if v is not None})
        dist.barrier(group)
    finally:
        dist.destroy_process_group()
