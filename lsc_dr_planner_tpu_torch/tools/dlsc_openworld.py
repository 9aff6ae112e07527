"""DLSC in open worlds, within the reference's envelope (port of
tools/dlsc_openworld.py).

The DLSC paper's own experiments (arXiv:2209.09447; sub-step prediction
`Segment::subSegment`, driven once per sub-step) run in open worlds: no
octomap, no SFC, no DR waypoint layer, agents swapping positions under
sub-step replanning ts < dt. This harness flies that envelope: circle
swaps and random antipodal fleets, DLSC with ts = 0.1 s and dt = 0.2 s,
PRIOR_BASED goals (symmetric open-world swaps deadlock under plain
static goals by design; the paper resolves them with priority-based
goal yielding), communication range off (the comm-range waypoint box is
a DR-layer construct).

Success per mission = every agent home, collision-free, no QP failure,
zero dynamic-limit excess. One JSON row per mission, appended to
`--out` (missions already there are skipped), with `device`: the card's
name and power limit, where the JAX tool writes `platform`.

    python -m lsc_dr_planner_tpu_torch.tools.dlsc_openworld
        [--out log/torch_benchmark/dlsc_openworld.jsonl] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np

from lsc_dr_planner_tpu_torch.config import GoalMode, Param, PlannerMode
from lsc_dr_planner_tpu_torch.device import DEFAULT as DEFAULT_DEVICE
from lsc_dr_planner_tpu_torch.device import describe
from lsc_dr_planner_tpu_torch.device import resolve as resolve_device
from lsc_dr_planner_tpu_torch.mission import generate_random_mission
from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

LOG_DIR = "log/dlsc_open"  # the simulators' log directory (nothing is written there)


def circle_mission(A, radius, seed=0):
    """A agents on a circle of `radius` (±5 cm jitter), each flying to
    its antipode."""
    m = generate_random_mission(
        A, [-radius - 2, -radius - 2, 0.0], [radius + 2, radius + 2, 2.5],
        seed=seed, min_separation=0.0,
    )
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(A) / A
    for i, a in enumerate(m.agents):
        jit = rng.uniform(-0.05, 0.05, 2)
        a.start = np.array([radius * np.cos(ang[i]) + jit[0],
                            radius * np.sin(ang[i]) + jit[1], 0.6])
        a.goal = np.array([-a.start[0], -a.start[1], 0.6])
    return m


def random_swap_mission(A, half, seed):
    return generate_random_mission(
        A, [-half, -half, 0.0], [half, half, 2.5], seed=seed,
        min_separation=1.0,
    )


def cases():
    """(name, mission) of every mission the harness flies."""
    out = [(f"circle{A}", circle_mission(A, 0.22 * A + 1.8, seed=A)) for A in (8, 16, 24)]
    for s in range(4):
        A = 10 + 4 * s
        out.append((f"swap{A}_s{s}",
                    random_swap_mission(A, 1.1 * np.sqrt(A) + 2.0, seed=100 + s)))
    return out


def run_one(mission, name, max_iter=1000, device=DEFAULT_DEVICE, log_dir=LOG_DIR):
    p = Param(
        world_dimension=2, world_use_octomap=False,
        communication_range=-1.0, goal_mode=GoalMode.PRIOR_BASED,
        planner_mode=PlannerMode.DLSC, multisim_time_step=0.1,
        multisim_max_planner_iteration=max_iter, profile_stages=False,
    )
    sim = MultiSyncSimulator(p, mission, log_dir=log_dir, device=device)
    t0 = time.time()
    r = sim.run()
    r["mission"] = name
    r["wall_s"] = round(time.time() - t0, 1)
    r["success"] = bool(
        not r["is_collided"] and not r["qp_failed"]
        and np.isfinite(r["total_flight_time"])
        and r["vel_excess_ratio"] == 0.0 and r["acc_excess_ratio"] == 0.0
    )
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="log/torch_benchmark/dlsc_openworld.jsonl")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    label = describe(dev)

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["mission"])
                except (ValueError, KeyError):
                    pass

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__))).stdout.strip()
    except OSError:
        commit = "unknown"
    rows = []
    for name, m in cases():
        if name in done:
            continue
        r = run_one(m, name, device=dev)
        r["git_commit"] = commit
        r["device"] = label
        with open(args.out, "a") as f:
            f.write(json.dumps(r) + "\n")
        print(f"{name}: flight={r['total_flight_time']:.1f}s "
              f"safety={r['safety_ratio_agent']:.3f} "
              f"{'OK' if r['success'] else 'FAIL'}", flush=True)
        rows.append(r)
    return rows


if __name__ == "__main__":
    main()
