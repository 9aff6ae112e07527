"""CLI entry point: run one mission (or a mission directory) end-to-end.

Equivalent of the reference's multi_sync_simulator_node + the
test_all_* launch files (reference: src/multi_sync_simulator_node.cpp,
launch/simulation.launch, launch/test_all_forest.launch).

Port of lsc_dr_planner_tpu/sim/run.py: `--device {cpu,cuda}` replaces
`--platform`, and `--device cuda` without a CUDA device raises.

    python -m lsc_dr_planner_tpu_torch.sim.run --device cuda \
        --mission m.json --world w.csv
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from lsc_dr_planner_tpu_torch.config import GoalMode, MAPFMode, Param, PlannerMode
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
    )


def run_one(mission_file, world_file, param, log_dir, seed, verbose,
            checkpoint=None, checkpoint_every=0, resume=None,
            frame_every=0, device="cpu"):
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
                     frame_every=frame_every)
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
    # local sensing (--sensor-range) and dynamic-obstacle observation
    # noise (--obs-noise) come with world/map_manager.py and the dynamic
    # obstacles (ROADMAP Queue 1 item 12); this flag raises until then
    ap.add_argument("--no-global-map", action="store_true",
                    help="local-sensing mode (reference "
                         "world/use_global_map=false); not ported yet, "
                         "raises NotImplementedError")
    ap.add_argument("--checkpoint", help="checkpoint .npz path to write")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save the checkpoint every N planning steps")
    ap.add_argument("--resume", help="checkpoint .npz to restore before "
                                     "running (single-mission mode)")
    ap.add_argument("--debug-frames", type=int, default=0,
                    help="render a debug frame every N planning steps; "
                         "sim/replay.py is not ported yet (ROADMAP item "
                         "16), so a non-zero value raises")
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
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"],
                    help="where the planning step runs (cuda: the ADMM "
                         "loop as the CUDA kernel; raises without a GPU)")
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
                    device=args.device)
        print(json.dumps(r))
        results.append(r)
    return results


if __name__ == "__main__":
    main()
