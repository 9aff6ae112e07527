"""Pod-configuration Monte-Carlo throughput (port of
tools/mc_pod_bench.py): A agents × S scenarios planned as one batched
step per iteration (`sim/montecarlo.py::MonteCarloSimulator`: chunks of
32 scenarios, the host MAPF layer threaded across scenarios), one JSON
row per S with the host/device split of the step, so the cost of the
scenario axis shows. BASELINE.json's pod configuration is 1024 agents ×
256 scenarios; this measures the slice A × S on one device.

The mission is the JAX tool's: `generate_random_mission(A)` in a square
of half-width max(6, 0.7·√A) m, 2.5 m high, seed 0, no octomap,
communication range 3 m; goal noise 0.25 m. Each row (the JAX tool's
fields, its `platform` now `device`: the card's name and power limit)
also gives `chunk_peak_bytes`, the card's peak allocated bytes in each
chunk of the step, the largest over the timed steps.

    python -m lsc_dr_planner_tpu_torch.tools.mc_pod_bench [--A 1024] [--S 8,32,64]
        [--steps 5] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from lsc_dr_planner_tpu_torch.config import Param
from lsc_dr_planner_tpu_torch.device import DEFAULT as DEFAULT_DEVICE
from lsc_dr_planner_tpu_torch.device import describe
from lsc_dr_planner_tpu_torch.device import resolve as resolve_device
from lsc_dr_planner_tpu_torch.mission import Mission, generate_random_mission
from lsc_dr_planner_tpu_torch.sim.montecarlo import MonteCarloSimulator

MAX_NOISE = 0.25
LOG_DIR = "log/mc_pod"  # the simulators' log directory (nothing is written there)


def pod_mission(A: int) -> Mission:
    half = max(6.0, 0.7 * float(np.sqrt(A)))
    return generate_random_mission(A, [-half, -half, 0], [half, half, 2.5], seed=0)


def pod_param() -> Param:
    # the straggler rescue stays on: the scenario step flattens S × A into
    # one QP batch, so the compacted rescue runs once over the whole batch
    return Param(world_use_octomap=False, communication_range=3.0, profile_stages=False)


def build(S: int, mission: Mission, param: Param, device, log_dir: str = LOG_DIR):
    """(the simulator, its build seconds)."""
    t0 = time.perf_counter()
    mc = MonteCarloSimulator(param, mission, n_scenarios=S, max_noise=MAX_NOISE,
                             log_dir=log_dir, device=device)
    return mc, time.perf_counter() - t0


def measure(mc: MonteCarloSimulator, steps: int, built_s: float, label: str) -> dict:
    """One warm-up step (iteration 0), then `steps` timed steps: the JAX
    tool's row, with the chunks' peak bytes."""
    A, S = mc.sims[0].A, mc.S
    mc.step(0)
    t0 = time.perf_counter()
    phases = {"host": 0.0, "stack": 0.0, "device": 0.0, "apply": 0.0}
    conv, peaks = [], []
    for it in range(1, steps + 1):
        mc.step(it)
        for k in phases:
            phases[k] += mc.phase_times[k]
        conv.append(mc.last_qp_convergence)
        peaks = ([max(a, b) for a, b in zip(peaks, mc.chunk_peak_bytes)] if peaks
                 else list(mc.chunk_peak_bytes))
    dt = (time.perf_counter() - t0) / steps
    return {
        "A": A, "S": S, "steps": steps, "built_s": round(built_s, 1),
        "step_s": round(dt, 3),
        "agent_scenario_steps_per_s": round(A * S / dt, 1),
        "qp_convergence_min": round(min(conv), 5),
        "qp_convergence_mean": round(sum(conv) / len(conv), 5),
        "phases_s": {k: round(v / steps, 3) for k, v in phases.items()},
        "chunk_peak_bytes": peaks,
        "device": label,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--A", type=int, default=1024)
    ap.add_argument("--S", default="8")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    label = describe(dev)

    mission, param = pod_mission(args.A), pod_param()
    rows = []
    for S in [int(s) for s in args.S.split(",")]:
        mc, built_s = build(S, mission, param, dev)
        rows.append(measure(mc, args.steps, built_s, label))
        del mc
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
