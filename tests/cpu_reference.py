#!/usr/bin/env python3
"""What the JAX package does on the CPU where the port's chip run needs a
reference (not collected by pytest; it imports both packages, as the
tests do).

    JAX_PLATFORMS=cpu python tests/cpu_reference.py flights [NAME ...]
    JAX_PLATFORMS=cpu python tests/cpu_reference.py convergence NAME A [STEPS]
    JAX_PLATFORMS=cpu python tests/cpu_reference.py local A SEED MAX_ITER
    JAX_PLATFORMS=cpu python tests/cpu_reference.py montecarlo S A SEED MAX_ITER
    JAX_PLATFORMS=cpu python tests/cpu_reference.py mcstep S A SEED STEP OUT.npz
    JAX_PLATFORMS=cpu python tests/cpu_reference.py flightcsv A SEED MAX_ITER
    JAX_PLATFORMS=cpu python tests/cpu_reference.py teacher flight A SEED STEPS
    JAX_PLATFORMS=cpu python tests/cpu_reference.py teacher montecarlo S A SEED STEPS
    JAX_PLATFORMS=cpu python tests/cpu_reference.py freerun flight A SEED STEPS
    JAX_PLATFORMS=cpu python tests/cpu_reference.py freerun montecarlo S A SEED STEPS
    JAX_PLATFORMS=cpu python tests/cpu_reference.py teacher circle A STEPS
    JAX_PLATFORMS=cpu python tests/cpu_reference.py freerun circle A STEPS
    JAX_PLATFORMS=cpu python tests/cpu_reference.py tools [CASE ...]
    JAX_PLATFORMS=cpu python tests/cpu_reference.py qpf32 A STRIDE [THREADS]

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
each step. NAME may also be `degree8` (Bézier degree 8, n = 8: phase
8h's configuration).

`local`: `workload.forest_mission(A, SEED)` flown by the JAX simulator
in local-sensing mode (sensor range 3 m; chip_smoke.py phase 11), one
JSON line: flight time, steps, audit, agents home, discovered cells, and
the host seconds per step of sensing, merging and planning.

`montecarlo`: the JAX package's MonteCarloSimulator over S scenarios of
`workload.forest_mission(A, SEED)` (max_noise 0.25; chip_smoke.py phase
12), run until every scenario finishes or MAX_ITER iterations pass, one
JSON line: per scenario the audit and arrival, per step the convergence
and wall time.

`mcstep`: the same Monte-Carlo run (S scenarios of
`workload.forest_mission(A, SEED)`, max_noise 0.25) stepped to planner
step STEP; the stacked StepInputs that plan that step, the fleet and the
JAX package's converged set of that step go to OUT.npz, and one JSON
line prints the convergence per step and the agents that did not
converge at STEP.

`flightcsv`: `workload.forest_mission(A, SEED)` flown by the JAX
simulator and by the port's (both on the CPU, default `Param`, at most
MAX_ITER planner steps), each writing its simulation CSV under
build/cpu_reference/flightcsv/; one JSON line: both flights' steps and
flight times, the CSVs, and the first divergence between them
(`lsc_dr_planner_tpu_torch.tools.trace_diff`, 1 mm).

`teacher`: teacher-forced steps. The JAX package flies
`workload.forest_mission(A, SEED)` (`flight`: its simulator, default
`Param`; `montecarlo`: S scenarios, max_noise 0.25, as `mcstep`) for
STEPS planner steps; at each step the port plans from exactly the
inputs JAX planned from (`convert`). One JSON line per step: whether
the SFC boxes, goals and converged sets agree, the largest
control-point gap where both converged (and its agent), each package's
`qp_iterations` for that agent and its loop exit (the largest
`qp_iterations`), how many agents left the loop at another chunk in
the two packages, and the largest gap among the agents that left at the
same chunk and among those that did not; and the same comparison of the
port with itself, its inputs' positions moved by 1e-6 m (the loop's
sensitivity to a float32 rounding of its inputs).

`tools`: the JAX tools' own runs of the cases chip_smoke.py phase 14
flies with the port's tools: `tools/dlsc_openworld.py::run_one` on
`circle8`, and `tools/fuzz_missions.py::run_case` at 8 agents on seeds
2001 (hybrid layer), 2002 (mcp) and 2003 (auto), the cases of the JAX
package's slow fuzz test; CASE may also name any other mission of
dlsc_openworld's main (circle16, circle24, swap10_s0, swap14_s1,
swap18_s2, swap22_s3). One JSON line each: flight time, planner steps,
the audit, and `success` / `clean`.

`qpf32`: the float32 solves against float64 on the state of chip_smoke.py
phase 8g's widest QP (`build_fleet(A, world_dimension=3, M=28,
communication_range=30.0, max_obstacles=160)`, dim·K 246, after 2
evolving steps of the JAX package): the QP built once by the JAX package
(`_step_impl(..., defer_qp=True)`), then in STRIDE slices of its agents
(every STRIDE-th agent, offsets 0 to STRIDE − 1; each agent's QP is its
own, and the loop's exit is global, so every solve of a slice takes the
same agents) the JAX `solve`, the port's plain `qp.solve` and its float64
reference `qp_check.solve_f64`. One JSON line a slice and one for all
agents: per float32 solve, each agent's largest control-point distance
from the float64 solve (max, p99, and the max over the agents that both
converged) and the converged share of each solve. THREADS (default 4)
sets torch's intra-op threads.

`teacher circle` and `freerun circle` fly dlsc_openworld's circle{A}
mission in its configuration (DLSC sub-step, PRIOR_BASED goals, no
octomap, comm range off) instead of the forest.

`freerun`: the same flights, each package on its own state (both on the
CPU). One JSON line per step: the largest position gap, the agents
(scenario, agent) whose MAPF waypoint or SFC boxes differ between the
two, and the agents that did not converge in each.
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


# `convergence`'s configurations beyond tests/test_torch_modes_pipeline.py's:
# Bézier degree 8 on the bench layout (chip_smoke.py phase 8h)
CONVERGENCE_CONFIGS = {"degree8": dict(n=8)}


def convergence(name, A, steps):
    import test_torch_modes_pipeline as T

    ov = {**T.CONFIGS, **CONVERGENCE_CONFIGS}[name]
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


def mcstep(S, A, seed, step, out_path, log_dir):
    from lsc_dr_planner_tpu.sim.montecarlo import MonteCarloSimulator

    p = ParamJ(multisim_save_result=False)
    mc = MonteCarloSimulator(p, workload.forest_mission(A, seed), n_scenarios=S,
                             max_noise=0.25, log_dir=str(log_dir))
    vstep, seen = mc._vstep, {}

    def capture(fleet, stacked):
        out = vstep(fleet, stacked)
        seen.update(fleet=fleet, inp=stacked, out=out)
        return out

    mc._vstep = capture
    conv = []
    for it in range(step):
        mc.step(it)
        conv.append(mc.last_qp_convergence)
    inp, out = seen["inp"], seen["out"]
    arrays = {f"inp_{k}": np.asarray(v) for k, v in inp._asdict().items() if v is not None}
    arrays.update({f"fleet_{k}": np.asarray(v) for k, v in seen["fleet"]._asdict().items()})
    converged = np.asarray(out.qp_converged)
    np.savez_compressed(out_path, converged=converged, **arrays)
    bad = [np.nonzero(~c)[0].tolist() for c in converged]
    return {"mcstep": step, "S": S, "A": A, "seed": seed, "convergence": conv,
            "not_converged": bad, "bytes": Path(out_path).stat().st_size}


def flightcsv(A, seed, max_iter, log_dir):
    from lsc_dr_planner_tpu_torch.config import Param as ParamT
    from lsc_dr_planner_tpu_torch.sim.replay import read_csv
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator as SimT
    from lsc_dr_planner_tpu_torch.tools.trace_diff import first_divergence

    m = workload.forest_mission(A, seed)
    out = {"flightcsv": A, "seed": seed}
    for name, sim_cls, param_cls, kw in (("jax", MultiSyncSimulator, ParamJ, {}),
                                         ("port", SimT, ParamT, {"device": "cpu"})):
        d = log_dir / "flightcsv" / name
        d.mkdir(parents=True, exist_ok=True)
        for f in d.glob("*.csv"):
            f.unlink()
        p = param_cls(multisim_save_result=True, multisim_max_planner_iteration=max_iter)
        sim = sim_cls(p, m, log_dir=str(d), **kw)
        r = sim.run()
        (csv,) = d.glob("simulation_*.csv")
        out[name] = {**_audit(r), "csv": str(csv)}
    la, lb = read_csv(out["jax"]["csv"]), read_csv(out["port"]["csv"])
    out["rows"] = [len(la.times), len(lb.times)]
    out["first_divergence"] = first_divergence(la, lb, 1e-3)
    return out


def _teacher_row(step, out_j, out_t):
    """One teacher-forced step: JAX's outputs `out_j` against the port's
    `out_t` (numpy mappings, agents flattened)."""
    conv = out_j["qp_converged"] & out_t["qp_converged"]
    gap = np.abs(out_j["desired_ctrl"] - out_t["desired_ctrl"]).reshape(len(conv), -1).max(-1)
    gap = np.where(conv, gap, 0.0)
    it_j, it_t = out_j["qp_iterations"], out_t["qp_iterations"]
    same = it_j == it_t
    worst = int(np.argmax(gap))
    return {
        "step": step,
        "boxes_equal": bool(np.array_equal(out_j["sfc_lo"], out_t["sfc_lo"])
                            and np.array_equal(out_j["sfc_hi"], out_t["sfc_hi"])),
        "goal_max_diff": float(np.abs(out_j["current_goal"] - out_t["current_goal"]).max()),
        "converged": [int(out_j["qp_converged"].sum()), int(out_t["qp_converged"].sum())],
        "converged_equal": bool(np.array_equal(out_j["qp_converged"], out_t["qp_converged"])),
        "ctrl_gap_max": float(gap.max()), "ctrl_gap_agent": worst,
        "agent_iterations": [int(it_j[worst]), int(it_t[worst])],
        "loop_exit": [int(it_j.max()), int(it_t.max())],
        "agents_other_chunk": int((~same).sum()), "agents": int(len(conv)),
        "ctrl_gap_max_same_chunk": float(gap[same].max(initial=0.0)),
        "ctrl_gap_max_other_chunk": float(gap[~same].max(initial=0.0)),
    }


def _jax_outputs(out, keys=("desired_ctrl", "current_goal", "sfc_lo", "sfc_hi",
                            "qp_converged", "qp_iterations")):
    """JAX StepOutputs as numpy, a leading scenario axis flattened."""
    lead = np.asarray(out.qp_converged).size
    return {k: np.asarray(getattr(out, k)).reshape((lead,) + np.shape(getattr(out, k))[
        np.ndim(out.qp_converged):]) for k in keys}


def _flight_setup(kind, args):
    """(mission, JAX Param, port Param, steps) of a `flight` (forest A,
    SEED, default Param) or a `circle` (dlsc_openworld's circle{A} in its
    configuration) comparison."""
    from lsc_dr_planner_tpu import config as config_j
    from lsc_dr_planner_tpu_torch import config as config_t

    if kind == "circle":
        A, steps = args

        def param(c):
            return c.Param(world_dimension=2, world_use_octomap=False, communication_range=-1.0,
                           goal_mode=c.GoalMode.PRIOR_BASED, planner_mode=c.PlannerMode.DLSC,
                           multisim_time_step=0.1, multisim_save_result=False)

        return _dlsc_missions()[f"circle{A}"], param(config_j), param(config_t), steps
    A, seed, steps = args
    return (workload.forest_mission(A, seed), config_j.Param(multisim_save_result=False),
            config_t.Param(multisim_save_result=False), steps)


def teacher(kind, args, log_dir):
    from lsc_dr_planner_tpu_torch import convert
    from lsc_dr_planner_tpu_torch.config import Param as ParamT
    from lsc_dr_planner_tpu_torch.planner.pipeline import FleetArrays
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator as SimT

    if kind in ("flight", "circle"):
        m, param_j, param_t, steps = _flight_setup(kind, args)
        A, S = len(m.agents), 1
    else:
        S, A, seed, steps = args
        m = workload.forest_mission(A, seed)
        param_t = ParamT(multisim_save_result=False)
    planner_t = SimT(param_t, m, device="cpu").planner
    seen = {}
    if kind != "montecarlo":
        sim = MultiSyncSimulator(param_j, m, log_dir=str(log_dir))
        jstep = sim.planner.step

        def capture(fleet, inp):
            out = jstep(fleet, inp)
            seen[int(inp.planner_seq)] = (fleet, inp, out)
            return out

        sim.planner.step = capture

        def advance(it):
            _advance_flight(sim, it)
    else:
        from lsc_dr_planner_tpu.sim.montecarlo import MonteCarloSimulator

        sim = MonteCarloSimulator(ParamJ(multisim_save_result=False), m, n_scenarios=S,
                                  max_noise=0.25, log_dir=str(log_dir))
        vstep = sim._vstep

        def capture(fleet, stacked):
            out = vstep(fleet, stacked)
            seen[len(seen)] = (fleet, stacked, out)
            return out

        sim._vstep = capture
        advance = sim.step
    rows = []
    for it in range(steps):
        advance(it)
        fleet_j, inp_j, out_j = seen[max(seen)]
        fields = {}
        for k, v in inp_j._asdict().items():
            if v is None:
                continue
            v = np.asarray(v)
            if k == "planner_seq":
                v = int(v.reshape(-1)[0])
            elif S > 1 and not k.startswith("dynobs_"):
                v = v.reshape((S * A,) + v.shape[2:])
            fields[k] = v
        inp_t = convert.inputs_from_numpy(fields, "cpu")
        fleet_t = convert.fleet_from_numpy(
            {k: np.asarray(v) for k, v in fleet_j._asdict().items()}, "cpu")
        if S > 1:
            fleet_t = FleetArrays(**{k: v.repeat(S, *([1] * (v.dim() - 1)))
                                     for k, v in vars(fleet_t).items()})

        def plan(inp):
            return convert.outputs_to_numpy(planner_t._step_impl(
                fleet_t, inp, **({"scenarios": S} if S > 1 else {})))

        out_t = plan(inp_t)
        row = _teacher_row(it + 1, _jax_outputs(out_j), out_t)
        # the port against itself with every position moved by 1e-6 m
        # (about two float32 ulps at these coordinates)
        near = _teacher_row(it + 1, out_t, plan(dataclasses.replace(inp_t, pos=inp_t.pos + 1e-6)))
        row["port_vs_port_pos_1e-6"] = {k: near[k] for k in (
            "boxes_equal", "converged_equal", "ctrl_gap_max", "agents_other_chunk")}
        print(json.dumps({"teacher": kind, **row}), flush=True)
        rows.append(row)
    return rows


def _advance_flight(sim, it):
    """One iteration of a simulator's run loop (both packages')."""
    if sim.planner_seq > 0 or it > 0:
        sim.do_step()
    sim.decentralized_mapp()
    assert sim.plan()


def _agents(mask, A, limit=12):
    """(scenario, agent) of the first `limit` agents set in `mask`."""
    return [[int(i) // A, int(i) % A] for i in np.nonzero(mask)[0][:limit]]


def freerun(kind, args, log_dir):
    from lsc_dr_planner_tpu_torch.config import Param as ParamT
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator as SimT

    if kind in ("flight", "circle"):
        m, param_j, param_t, steps = _flight_setup(kind, args)
        A = len(m.agents)
        sims_j = [MultiSyncSimulator(param_j, m, log_dir=str(log_dir))]
        sims_t = [SimT(param_t, m, device="cpu")]

        def advance(it):
            _advance_flight(sims_j[0], it)
            _advance_flight(sims_t[0], it)
    else:
        from lsc_dr_planner_tpu.sim.montecarlo import MonteCarloSimulator as MonteCarloJ
        from lsc_dr_planner_tpu_torch.sim.montecarlo import MonteCarloSimulator as MonteCarloT

        S, A, seed, steps = args
        m = workload.forest_mission(A, seed)
        mc_j = MonteCarloJ(ParamJ(multisim_save_result=False), m, n_scenarios=S,
                           max_noise=0.25, log_dir=str(log_dir))
        mc_t = MonteCarloT(ParamT(multisim_save_result=False), m, n_scenarios=S,
                           max_noise=0.25, log_dir=str(log_dir), device="cpu")
        sims_j, sims_t = mc_j.sims, mc_t.sims

        def advance(it):
            mc_j.step(it)
            mc_t.step(it)

    def state(sims, k):
        return np.concatenate([np.asarray(getattr(sim, k)) for sim in sims])

    rows = []
    for it in range(steps):
        advance(it)
        j, t = ({k: state(sims, k) for k in ("pos", "next_waypoint", "sfc_lo", "sfc_hi",
                                             "qp_converged")} for sims in (sims_j, sims_t))
        wp = np.abs(j["next_waypoint"] - t["next_waypoint"]).max(-1)
        boxes = (j["sfc_lo"] != t["sfc_lo"]).reshape(len(wp), -1).any(-1) | \
            (j["sfc_hi"] != t["sfc_hi"]).reshape(len(wp), -1).any(-1)
        row = {"freerun": kind, "step": it + 1,
               "pos_max_diff": float(np.abs(j["pos"] - t["pos"]).max()),
               "waypoints_differ": _agents(wp > 1e-3, A), "waypoint_max_diff": float(wp.max()),
               "n_waypoints_differ": int((wp > 1e-3).sum()),
               "boxes_differ": _agents(boxes, A), "n_boxes_differ": int(boxes.sum()),
               "not_converged": {"jax": _agents(~j["qp_converged"], A, 48),
                                 "port": _agents(~t["qp_converged"], A, 48)}}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


TOOL_CASES = ("circle8", "fuzz2001_hybrid", "fuzz2002_mcp", "fuzz2003_auto")


def _dlsc_missions():
    """The missions of tools/dlsc_openworld.py's main, by name."""
    from tools import dlsc_openworld

    out = {f"circle{A}": dlsc_openworld.circle_mission(A, 0.22 * A + 1.8, seed=A)
           for A in (8, 16, 24)}
    for s in range(4):
        A = 10 + 4 * s
        out[f"swap{A}_s{s}"] = dlsc_openworld.random_swap_mission(
            A, 1.1 * np.sqrt(A) + 2.0, seed=100 + s)
    return out


def _slice(qp_inp, idx):
    return type(qp_inp)(*(None if v is None else np.asarray(v)[idx] for v in qp_inp))


def _gaps(x, x64, conv, conv64):
    """Each agent's largest |x − x64| (control points): max, p99, and the
    max over the agents that both converged."""
    g = np.abs(np.asarray(x, np.float64) - x64).reshape(len(x64), -1).max(axis=1)
    both = conv & conv64
    return {"max": float(g.max()), "p99": float(np.percentile(g, 99)),
            "max_both_converged": float(g[both].max(initial=0.0)),
            "converged": float(conv.mean())}


def qpf32(A, stride):
    """See the module's note (`qpf32`)."""
    import bench
    from lsc_dr_planner_tpu import config as jconfig
    from lsc_dr_planner_tpu.ops import qp as jqp
    from lsc_dr_planner_tpu_torch.ops import qp as tqp
    from lsc_dr_planner_tpu_torch.ops import qp_check
    from test_torch_qp import port_cfg, port_inputs

    over = dict(world_dimension=3, M=28, communication_range=30.0, max_obstacles=160)
    base = jconfig.Param
    jconfig.Param = lambda **kw: base(**{**kw, **over})
    t0 = time.time()
    try:
        p, planner, fleet, inp = bench.build_fleet(A)
        step = bench.make_evolve_step(p, planner, fleet)
        for _ in range(2):
            inp, _ = step(inp)
        cfg, feas_tol = planner.qp_cfg, planner.feas_tol
        qp_inp = planner._step_impl(fleet, inp, defer_qp=True).qp_inp
    finally:
        jconfig.Param = base
    pcfg = port_cfg(cfg)
    dk = pcfg.dim * tqp.torch_statics(pcfg, torch.device("cpu"))["K"]
    print(json.dumps({"A": A, "dimK": dk, "O": planner.O, "state_s": time.time() - t0}),
          flush=True)
    rows, whole = [], {"jax": [], "port": [], "conv": {"jax": [], "port": [], "f64": []}}
    for off in range(stride):
        idx = np.arange(off, A, stride)
        sub = _slice(qp_inp, idx)
        t = time.time()
        rj = jqp.solve(cfg, jqp.QPInputs(*(None if v is None else jnp.asarray(v) for v in sub)),
                       feas_tol=feas_tol)
        tj = time.time() - t
        t = time.time()
        rt = tqp.solve(pcfg, port_inputs(sub), feas_tol=feas_tol)
        r64 = qp_check.solve_f64(pcfg, port_inputs(sub), feas_tol)
        tt = time.time() - t
        x64, c64 = r64.x.numpy(), r64.converged.numpy()
        cj, ct = np.asarray(rj.converged), rt.converged.numpy()
        row = {"offset": off, "agents": len(idx), "f64_converged": float(c64.mean()),
               "jax_f32": _gaps(np.asarray(rj.x), x64, cj, c64),
               "port_f32": _gaps(rt.x.numpy(), x64, ct, c64), "jax_s": tj, "port_s": tt}
        rows.append(row)
        print(json.dumps(row), flush=True)
        for name, x, c in (("jax", np.asarray(rj.x), cj), ("port", rt.x.numpy(), ct)):
            whole[name].append(np.abs(np.asarray(x, np.float64) - x64)
                               .reshape(len(idx), -1).max(axis=1))
            whole["conv"][name].append(c)
        whole["conv"]["f64"].append(c64)
    out = {"all_agents": sum(r["agents"] for r in rows)}
    for name in ("jax", "port"):
        g = np.concatenate(whole[name])
        out[f"{name}_f32"] = {"max": float(g.max()), "p99": float(np.percentile(g, 99)),
                              "converged": float(np.concatenate(whole["conv"][name]).mean())}
    out["f64_converged"] = float(np.concatenate(whole["conv"]["f64"]).mean())
    return out


def tool_case(name):
    if not name.startswith("fuzz"):
        from tools import dlsc_openworld

        r = dlsc_openworld.run_one(_dlsc_missions()[name], name)
        flag = "success"
    else:
        from tools import fuzz_missions

        seed, layer = name[len("fuzz"):].split("_")
        r = fuzz_missions.run_case(int(seed), layer, A=8)
        flag = "clean"
    return {"case": name, **{k: r.get(k) for k in (
        "total_flight_time", "planner_seq", "is_collided", "qp_failed", "safety_ratio_agent",
        "vel_excess_ratio", "acc_excess_ratio", "wall_s", flag)}}


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
    elif what == "flightcsv":
        log_dir = ROOT / "build" / "cpu_reference"
        A, seed, max_iter = (int(a) for a in sys.argv[2:5])
        print(json.dumps(flightcsv(A, seed, max_iter, log_dir)))
    elif what == "mcstep":
        log_dir = ROOT / "build" / "cpu_reference"
        log_dir.mkdir(parents=True, exist_ok=True)
        S, A, seed, step = (int(a) for a in sys.argv[2:6])
        print(json.dumps(mcstep(S, A, seed, step, sys.argv[6], log_dir)))
    elif what in ("teacher", "freerun"):
        log_dir = ROOT / "build" / "cpu_reference"
        log_dir.mkdir(parents=True, exist_ok=True)
        (teacher if what == "teacher" else freerun)(
            sys.argv[2], [int(a) for a in sys.argv[3:]], log_dir)
    elif what == "tools":
        for name in sys.argv[2:] or TOOL_CASES:
            print(json.dumps(tool_case(name)), flush=True)
    elif what == "qpf32":
        torch.set_num_threads(int(sys.argv[4]) if len(sys.argv) > 4 else 4)
        print(json.dumps(qpf32(int(sys.argv[2]), int(sys.argv[3]))))
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
