#!/usr/bin/env python3
"""What the JAX package does on the CPU where the port's chip run needs a
reference (not collected by pytest; it imports both packages, as the
tests do).

    JAX_PLATFORMS=cpu python tests/cpu_reference.py flights [NAME ...]
    JAX_PLATFORMS=cpu python tests/cpu_reference.py convergence NAME A [STEPS]
    JAX_PLATFORMS=cpu python tests/cpu_reference.py local A SEED MAX_ITER
    JAX_PLATFORMS=cpu python tests/cpu_reference.py montecarlo S A SEED MAX_ITER

`flights`: `workload.forest_mission(10)` flown to its goals by the JAX
simulator in the modes of chip_smoke.py phase 9 (`dlsc`: DLSC sub-step,
at most 600 planner steps; `3d`; `dyn`: a spinning and a straight
dynamic obstacle seen through 0.03 m observation noise; 300 steps), one
JSON line each: flight time, steps, audit, agents home.

`convergence`: the mean QP convergence per step of the JAX package and
of the port (CPU) on the bench layout `workload.build_fleet(A)` in one
planner mode of tests/test_torch_modes_pipeline.py (CONFIGS), both
planning from the same state, which advances along the JAX plan; and
the smallest planar distance between two agents of that state after
each step.

`local`: `workload.forest_mission(A, SEED)` flown by the JAX simulator
in local-sensing mode (sensor range 3 m; chip_smoke.py phase 11), one
JSON line: flight time, steps, audit, agents home, discovered cells, and
the host seconds per step of sensing, merging and planning.

`montecarlo`: the JAX package's MonteCarloSimulator over S scenarios of
`workload.forest_mission(A, SEED)` (max_noise 0.25; chip_smoke.py phase
12), run until every scenario finishes or MAX_ITER iterations pass, one
JSON line: per scenario the audit and arrival, per step the convergence
and wall time.
"""

import dataclasses
import json
import sys
import time
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from lsc_dr_planner_tpu.config import Param as ParamJ  # noqa: E402
from lsc_dr_planner_tpu.config import PlannerMode as PlannerModeJ  # noqa: E402
from lsc_dr_planner_tpu.mission import Mission, ObstacleSpec  # noqa: E402
from lsc_dr_planner_tpu.planner import pipeline as jpipe  # noqa: E402
from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator  # noqa: E402
from lsc_dr_planner_tpu.world.grid import build_grid_world as jbuild  # noqa: E402
from lsc_dr_planner_tpu_torch import workload  # noqa: E402

FLIGHTS = {
    "dlsc": (dict(planner_mode=PlannerModeJ.DLSC, multisim_time_step=0.1), 2, 600),
    "3d": (dict(world_dimension=3), 3, 300),
    "dyn": (dict(multisim_observer_stddev=0.03), 2, 300),
}


def flight(name, log_dir):
    kw, dim, max_iter = FLIGHTS[name]
    m = workload.forest_mission(10)
    mpath, wpath = str(log_dir / "forest10.json"), str(log_dir / "forest10.csv")
    m.save(mpath)
    np.savetxt(wpath, m.world_boxes, delimiter=",")
    mj = Mission.load(mpath, world_file=wpath, world_dimension=dim, world_z_2d=0.6)
    if name == "dyn":
        mj.obstacles += [
            ObstacleSpec(type="spin", radius=0.2, max_acc=1.0, downwash=1.0,
                         axis_position=np.array([0.0, 0.0, 0.6]),
                         axis_ori=np.array([0.0, 0.0, 1.0]),
                         start=np.array([0.8, 0.0, 0.6]), speed=0.4),
            ObstacleSpec(type="straight", radius=0.15, max_acc=1.0, downwash=1.0,
                         start=np.array([-2.0, 1.5, 0.6]), goal=np.array([2.0, 1.5, 0.6]),
                         speed=0.3)]
    p = ParamJ(multisim_save_result=False, multisim_max_planner_iteration=max_iter, **kw)
    sim = MultiSyncSimulator(p, mj, log_dir=str(log_dir))
    r = sim.run()
    home = int((np.linalg.norm(sim.pos - sim.desired_goal, axis=-1) <= p.goal_threshold).sum())
    keys = ("total_flight_time", "planner_seq", "is_collided", "qp_failed",
            "safety_ratio_agent", "safety_ratio_obs", "vel_excess_ratio", "acc_excess_ratio")
    return {"flight": name, **{k: r[k] for k in keys}, "agents_home": home}


def convergence(name, A, steps):
    import test_torch_modes_pipeline as T

    ov = T.CONFIGS[name]
    p, plan_t, fleet_t, inp_t = workload.build_fleet(A, device="cpu", **ov)
    _, _, boxes, wmin, wmax = workload.fleet_layout(A)
    pj = T._jax_param(ov)
    plan_j = jpipe.FleetPlanner(pj, jbuild(boxes, wmin, wmax, pj.world_resolution, 0.15), A,
                                agent_radius=0.15, max_vel_hint=1.0)
    fleet_j = jpipe.FleetArrays(**{f.name: jnp.asarray(getattr(fleet_t, f.name).numpy())
                                   for f in dataclasses.fields(fleet_t)})
    conv_j, conv_t, min_dist = [], [], []
    for _ in range(steps):
        fields = {f.name: getattr(inp_t, f.name) for f in dataclasses.fields(inp_t)}
        inp_j = jpipe.StepInputs(**{f: (v if v is None or isinstance(v, int)
                                        else jnp.asarray(v.numpy()))
                                    for f, v in fields.items()})
        out_j = plan_j.step(fleet_j, inp_j)
        out_t = plan_t.step(fleet_t, inp_t)
        conv_j.append(float(np.asarray(out_j.qp_converged).mean()))
        conv_t.append(float(out_t.qp_converged.float().mean()))
        jo = types.SimpleNamespace(**{f: torch.as_tensor(np.array(getattr(out_j, f)))
                                      for f in ("desired_ctrl", "current_goal", "sfc_lo",
                                                "sfc_hi", "sfc_initialized", "qp_y")})
        inp_t = workload.advance(p, inp_t, jo)
        pos = inp_t.pos[:, :2]
        min_dist.append((torch.cdist(pos, pos) + torch.eye(A) * 1e9).min().item())
    return {"mode": name, "A": A, "jax": conv_j, "port": conv_t, "min_pair_distance": min_dist}


def _audit(r):
    keys = ("total_flight_time", "planner_seq", "is_collided", "qp_failed",
            "safety_ratio_agent", "vel_excess_ratio", "acc_excess_ratio")
    return {k: r[k] for k in keys}


def local(A, seed, max_iter, log_dir):
    m = workload.forest_mission(A, seed)
    p = ParamJ(multisim_save_result=False, multisim_max_planner_iteration=max_iter,
               world_use_global_map=False, sensor_range=3.0)
    sim = MultiSyncSimulator(p, m, log_dir=str(log_dir))
    mm = sim.map_manager
    t_sense, t_merge = [], []
    sense, merge = mm.sense, mm.merge

    def timed(fn, out):
        def run(*a):
            t0 = time.perf_counter()
            fn(*a)
            out.append(time.perf_counter() - t0)
        return run

    mm.sense, mm.merge = timed(sense, t_sense), timed(merge, t_merge)
    t0 = time.perf_counter()
    r = sim.run()
    wall = time.perf_counter() - t0
    home = int((np.linalg.norm(sim.pos - sim.desired_goal, axis=-1) <= p.goal_threshold).sum())
    return {"local": A, "seed": seed, **_audit(r), "agents_home": home,
            "known_cells": int(mm.union_occ().sum()), "true_cells": int(mm.occ_true.sum()),
            "sense_s_mean": float(np.mean(t_sense)), "merge_s_mean": float(np.mean(t_merge)),
            "wall_s_per_step": wall / sim.planner_seq}


def montecarlo(S, A, seed, max_iter, log_dir):
    from lsc_dr_planner_tpu.sim.montecarlo import MonteCarloSimulator

    p = ParamJ(multisim_save_result=False, multisim_max_planner_iteration=max_iter)
    mc = MonteCarloSimulator(p, workload.forest_mission(A, seed), n_scenarios=S,
                             max_noise=0.25, log_dir=str(log_dir))
    conv, wall = [], []
    for it in range(max_iter):
        if all(sim.is_finished() for sim in mc.sims):
            break
        t0 = time.perf_counter()
        mc.step(it)
        wall.append(time.perf_counter() - t0)
        conv.append(mc.last_qp_convergence)
    out = []
    for sim in mc.sims:
        r = sim.summary()
        home = int((np.linalg.norm(sim.pos - sim.desired_goal, axis=-1)
                    <= p.goal_threshold).sum())
        out.append({**_audit(r), "agents_home": home})
    return {"montecarlo": S, "A": A, "seed": seed, "iterations": len(wall),
            "arrived": sum(bool(np.isfinite(o["total_flight_time"])) for o in out),
            "scenarios": out, "qp_convergence_min": min(conv),
            "qp_convergence_mean": float(np.mean(conv)), "wall_s_per_step": float(np.mean(wall))}


def main():
    what = sys.argv[1]
    if what == "flights":
        log_dir = ROOT / "build" / "cpu_reference"
        log_dir.mkdir(parents=True, exist_ok=True)
        for name in sys.argv[2:] or list(FLIGHTS):
            print(json.dumps(flight(name, log_dir)), flush=True)
    elif what == "convergence":
        steps = int(sys.argv[4]) if len(sys.argv) > 4 else 13
        print(json.dumps(convergence(sys.argv[2], int(sys.argv[3]), steps)))
    elif what in ("local", "montecarlo"):
        log_dir = ROOT / "build" / "cpu_reference"
        log_dir.mkdir(parents=True, exist_ok=True)
        args = [int(a) for a in sys.argv[2:]]
        print(json.dumps(local(*args, log_dir) if what == "local"
                         else montecarlo(*args, log_dir)))
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
