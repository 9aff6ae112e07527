"""Scale demonstration toward the pod-scale BASELINE configuration (port
of tools/scale_demo.py): the "scaled forest" (`workload.forest_mission`,
fleets beyond the reference's 10 agents) on `MultiSyncSimulator`:

  * 64 agents (seed 0): a full run to the goals, with per-step latency;
  * 256 agents: an N-step smoke run (latency and the safety audit, no
    full flight).

One JSON row per run (the JAX tool's fields, its `platform` now
`device`: the card's name and power limit), all written to
LOG_DIR/scale_demo.json. In the 64-agent run at seed 0 one agent stays
wedged short of its goal, in the JAX package and the port alike, so its
flight time is infinite: the row reports the run, it does not pass it.

    python -m lsc_dr_planner_tpu_torch.tools.scale_demo [--agents 64] [--smoke-agents 256]
        [--max-iter 400] [--smoke-iter 15] [--log-dir log/scale] [--skip-smoke]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.config import Param
from lsc_dr_planner_tpu_torch.device import DEFAULT as DEFAULT_DEVICE
from lsc_dr_planner_tpu_torch.device import describe
from lsc_dr_planner_tpu_torch.device import resolve as resolve_device
from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator


def run_scale(n_agents: int, max_iter: int, full: bool, log_dir: str,
              device=DEFAULT_DEVICE) -> dict:
    """`forest_mission(n_agents)` for at most `max_iter` planner steps
    (`full`: until every agent is home); the JAX tool's row."""
    dev = resolve_device(device)
    m = workload.forest_mission(n_agents)
    param = Param(
        world_dimension=2, world_use_octomap=True, communication_range=3.0,
        multisim_save_result=False, multisim_max_planner_iteration=max_iter,
        max_obstacles=16,
    )
    sim = MultiSyncSimulator(param, m, log_dir=log_dir, device=dev)
    t0 = time.time()
    step_times = []
    for it in range(max_iter):
        if full and sim.is_finished():
            break
        ts = time.time()
        if it > 0:
            sim.do_step()
        sim.decentralized_mapp()
        ok = sim.plan()
        sim.save_simulation_result()
        step_times.append(time.time() - ts)
        if not ok:
            break
    sim.total_flight_time = (
        sim.sim_time if full and sim.is_finished() else float("inf")
    )
    st = np.asarray(step_times[2:])  # skip the first steps (warm-up)
    return {
        "agents": n_agents,
        "steps": len(step_times),
        "flight_time_s": sim.total_flight_time,
        "distance_m": sim.total_distance(),
        "safety_ratio_agent": float(sim.safety_ratio_agent),
        "collided": bool(sim.is_collided),
        "qp_failed": bool(sim.qp_failed),
        "step_ms_mean": float(st.mean() * 1e3) if len(st) else None,
        "step_ms_p99": float(np.percentile(st, 99) * 1e3) if len(st) else None,
        "wall_s": time.time() - t0,
        "device": describe(dev),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--smoke-agents", type=int, default=256)
    ap.add_argument("--max-iter", type=int, default=400)
    ap.add_argument("--smoke-iter", type=int, default=15)
    ap.add_argument("--log-dir", default="log/scale")
    ap.add_argument("--skip-smoke", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    os.makedirs(args.log_dir, exist_ok=True)
    results = [run_scale(args.agents, args.max_iter, True, args.log_dir, args.device)]
    print(json.dumps(results[-1]), flush=True)
    if not args.skip_smoke:
        results.append(run_scale(args.smoke_agents, args.smoke_iter, False, args.log_dir,
                                 args.device))
        print(json.dumps(results[-1]), flush=True)
    with open(os.path.join(args.log_dir, "scale_demo.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
