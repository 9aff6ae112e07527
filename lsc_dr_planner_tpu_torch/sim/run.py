"""CLI entry point: run one mission (or a mission directory) end-to-end.

Equivalent of the reference's multi_sync_simulator_node + the
test_all_* launch files (reference: src/multi_sync_simulator_node.cpp,
launch/simulation.launch, launch/test_all_forest.launch).

Port of lsc_dr_planner_tpu/sim/run.py: `--device {cpu,cuda}` replaces
`--platform`. The default is `--device cuda`, which raises without a
CUDA device; `--device cpu` runs the plain torch paths.

    python -m lsc_dr_planner_tpu_torch.sim.run --device cuda \
        --mission m.json --world w.csv
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from lsc_dr_planner_tpu_torch.config import GoalMode, MAPFMode, Param, PlannerMode
from lsc_dr_planner_tpu_torch.device import DEFAULT as DEFAULT_DEVICE
from lsc_dr_planner_tpu_torch.mission import Mission, enumerate_mission_set_natural
from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator


def build_param(args) -> Param:
    return Param(
        planner_mode=PlannerMode[args.planner.upper()],
        goal_mode=GoalMode[args.goal.upper()],
        mapf_mode=MAPFMode[args.mapf.upper()],
        world_dimension=args.dimension,
        world_use_octomap=not args.no_octomap,
        communication_range=args.comm_range,
        multisim_max_planner_iteration=args.max_iter,
        multisim_save_result=args.save_csv,
        M=args.M,
        n=args.n,
        dt=args.dt,
        multisim_time_step=args.dt,
        qp_max_iter=args.qp_iters,
        world_use_global_map=not args.no_global_map,
        sensor_range=args.sensor_range,
        multisim_observer_stddev=args.obs_noise,
    )


def run_one(mission_file, world_file, param, log_dir, seed, verbose,
            checkpoint=None, checkpoint_every=0, resume=None,
            frame_every=0, frame_dir=None, device=DEFAULT_DEVICE):
    mission = Mission.load(
        mission_file,
        world_file=world_file if param.world_use_octomap else None,
        world_dimension=param.world_dimension,
        world_z_2d=param.world_z_2d,
        max_noise=param.multisim_max_noise,
        noise_seed=seed,
    )
    sim = MultiSyncSimulator(param, mission, log_dir=log_dir, seed=seed,
                             device=device)
    if resume:
        sim.load_checkpoint(resume)
    result = sim.run(verbose=verbose, checkpoint_path=checkpoint,
                     checkpoint_every=checkpoint_every,
                     frame_every=frame_every, frame_dir=frame_dir)
    result["mission"] = os.path.basename(mission_file)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="lsc_dr_planner_tpu simulator (PyTorch/CUDA port)")
    ap.add_argument("--mission", help="mission JSON file")
    ap.add_argument("--world", help="world CSV file")
    ap.add_argument("--mission-dir", help="run every mission in a directory")
    ap.add_argument("--world-dir", help="world directory (paired by index)")
    ap.add_argument("--planner", default="lsc",
                    choices=["lsc", "dlsc", "bvc", "reciprocal_rsfc"])
    ap.add_argument("--goal", default="grid_based_planner",
                    choices=["static", "right_hand", "prior_based",
                             "grid_based_planner"])
    ap.add_argument("--mapf", default="pibt", choices=["pibt", "ecbs"])
    ap.add_argument("--dimension", type=int, default=2)
    ap.add_argument("--no-octomap", action="store_true")
    ap.add_argument("--no-global-map", action="store_true",
                    help="local-sensing mode: agents discover the world "
                         "within --sensor-range and merge maps in comm "
                         "range (reference world/use_global_map=false)")
    ap.add_argument("--sensor-range", type=float, default=3.0)
    ap.add_argument("--obs-noise", type=float, default=0.0,
                    help="dynamic-obstacle observation noise std dev [m] "
                         "seen by the planner (audit uses true states)")
    ap.add_argument("--checkpoint", help="checkpoint .npz path to write")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save the checkpoint every N planning steps")
    ap.add_argument("--resume", help="checkpoint .npz to restore before "
                                     "running (single-mission mode)")
    ap.add_argument("--debug-frames", type=int, default=0,
                    help="render an internal-artifact debug frame (SFC "
                         "boxes, LSC half-planes, waypoints/grid paths, "
                         "comm groups) every N planning steps (needs "
                         "matplotlib)")
    ap.add_argument("--frames-dir", default=None,
                    help="directory for --debug-frames output "
                         "(default: log dir)")
    ap.add_argument("--comm-range", type=float, default=3.0)
    ap.add_argument("--max-iter", type=int, default=600)
    ap.add_argument("--M", type=int, default=10)
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--dt", type=float, default=0.2)
    ap.add_argument("--qp-iters", type=int, default=200)
    ap.add_argument("--save-csv", action="store_true")
    ap.add_argument("--log-dir", default="log")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE, choices=["cpu", "cuda"],
                    help="where the planning step runs (default cuda: the "
                         "ADMM loop as the CUDA kernel, raises without a "
                         "GPU; cpu: the plain torch paths)")
    args = ap.parse_args(argv)

    param = build_param(args)
    results = []
    if args.mission_dir:
        pairs = enumerate_mission_set_natural(args.mission_dir, args.world_dir)
        for mf, wf in pairs:
            r = run_one(mf, wf, param, args.log_dir, args.seed, args.verbose,
                        device=args.device)
            print(json.dumps(r))
            results.append(r)
        ok = [r for r in results if not r["is_collided"] and not r["qp_failed"]
              and np.isfinite(r["total_flight_time"])]
        print(f"# success {len(ok)}/{len(results)}")
    else:
        r = run_one(args.mission, args.world, param, args.log_dir, args.seed,
                    args.verbose, checkpoint=args.checkpoint,
                    checkpoint_every=args.checkpoint_every,
                    resume=args.resume, frame_every=args.debug_frames,
                    frame_dir=args.frames_dir, device=args.device)
        print(json.dumps(r))
        results.append(r)
    return results


if __name__ == "__main__":
    main()
