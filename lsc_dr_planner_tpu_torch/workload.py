"""The bench workload for the port: the counterpart of `bench.py`'s
`build_fleet` and `make_evolve_step`.

A forest-like random box world (0.3 m columns, ~0.25 trees/m², kept
clear of starts and goals) with a jittered 1.2 m agent lattice flying
to antipodal goals. `build_fleet(A, seed)` makes the same numpy RNG
calls in the same order as `bench.py`, so it gives the same lattice,
goals and forest. The evolving step advances the fleet along its own
solution and walks each waypoint one grid step toward the goal, gated
as the simulator gates it (goal-LP convergence onto the waypoint and
comm-range reachability), standing in for the host MAPF layer.

`forest_mission(A, seed)` is the simulator's workload: the repo's
"scaled forest" configuration (`tools/scale_demo.py::make_forest_mission`,
same numpy RNG calls in the same order, so the same mission).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsc_dr_planner_tpu_torch.config import GoalMode, Param
from lsc_dr_planner_tpu_torch.mission import Mission, generate_random_mission
from lsc_dr_planner_tpu_torch.ops import qp, trajectory
from lsc_dr_planner_tpu_torch.planner.pipeline import (
    FleetArrays, FleetPlanner, StepInputs,
)
from lsc_dr_planner_tpu_torch.world.grid import build_grid_world


def fleet_layout(A: int, seed: int = 0):
    """(pos2 [A, 2], goal2 [A, 2], boxes [B, 6], wmin, wmax) in numpy."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(A)))
    gx, gy = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    lattice = np.stack([gx, gy], -1).reshape(-1, 2)[:A] * 1.2
    lattice -= lattice.mean(0)
    pos2 = lattice + rng.uniform(-0.2, 0.2, (A, 2))
    goal2 = -pos2 + rng.uniform(-0.2, 0.2, (A, 2))

    half = 0.6 * side + 2.0
    wmin = np.array([-half, -half, 0.0])
    wmax = np.array([half, half, 1.0])

    n_trees = int(0.25 * (2 * half) ** 2)
    keep = np.concatenate([pos2, goal2], 0)
    trees = []
    for _ in range(n_trees * 3):
        if len(trees) >= n_trees:
            break
        c = rng.uniform(-half + 0.5, half - 0.5, 2)
        if np.min(np.linalg.norm(keep - c, axis=-1)) > 0.6:
            trees.append([c[0], c[1], 0.5, 0.3, 0.3, 1.0])
    boxes = np.asarray(trees) if trees else np.zeros((0, 6))
    return pos2, goal2, boxes, wmin, wmax


def forest_mission(n_agents: int, seed: int = 0) -> Mission:
    """Random starts and goals (1 m apart) in a square of side
    max(8, 1.55·√A·1.2) m, 2.5 m high, with 0.3 m columns at 0.12
    trees/m² kept 0.6 m clear of every start and goal."""
    side = max(8.0, 1.55 * np.sqrt(n_agents) * 1.2)
    half = side / 2
    m = generate_random_mission(
        n_agents, [-half, -half, 0.0], [half, half, 2.5], seed=seed,
        min_separation=1.0,
    )
    rng = np.random.default_rng(seed + 1)
    s = m.stacked()
    keep = np.concatenate([s["start"][:, :2], s["goal"][:, :2]], 0)
    trees = []
    target = int(0.12 * side * side)
    for _ in range(target * 4):
        if len(trees) >= target:
            break
        c = rng.uniform(-half + 0.5, half - 0.5, 2)
        if np.min(np.linalg.norm(keep - c, axis=-1)) > 0.6:
            trees.append([c[0], c[1], 0.5, 0.3, 0.3, 1.0])
    m.world_boxes = np.asarray(trees) if trees else np.zeros((0, 6))
    return m


def build_fleet(A: int, seed: int = 0, device="cpu", timing: bool = False):
    """Agent lattice + forest world + planner on `device`:
    (param, planner, fleet, inputs)."""
    device = torch.device(device)
    pos2, goal2, boxes, wmin, wmax = fleet_layout(A, seed)
    p = Param(
        goal_mode=GoalMode.GRID_BASED_PLANNER,
        world_use_octomap=True,
        world_dimension=2,
        communication_range=3.0,
        max_obstacles=16,
    )
    world = build_grid_world(boxes, wmin, wmax, p.world_resolution, 0.15, device)
    planner = FleetPlanner(p, world, A, max_dynobs=0, agent_radius=0.15,
                           max_vel_hint=1.0, timing=timing)

    f32 = torch.float32
    pos = torch.tensor(np.concatenate([pos2, np.full((A, 1), p.world_z_2d)], 1),
                       dtype=f32, device=device)
    goal = torch.tensor(np.concatenate([goal2, np.full((A, 1), p.world_z_2d)], 1),
                        dtype=f32, device=device)
    fleet = FleetArrays(
        radius=torch.full((A,), 0.15, dtype=f32, device=device),
        downwash=torch.full((A,), 2.0, dtype=f32, device=device),
        max_vel=torch.ones((A, 3), dtype=f32, device=device),
        max_acc=torch.full((A, 3), 2.0, dtype=f32, device=device),
        nominal_velocity=torch.full((A,), 1.0, dtype=f32, device=device),
    )
    zeros3 = torch.zeros((A, 3), dtype=f32, device=device)
    inp = StepInputs(
        pos=pos,
        vel=zeros3,
        acc=zeros3,
        prev_ctrl=trajectory.const_vel_ctrl(pos, zeros3, p.M, p.n, p.dt),
        has_prev=torch.zeros((A,), dtype=torch.bool, device=device),
        is_disturbed=torch.zeros((A,), dtype=torch.bool, device=device),
        desired_goal=goal,
        current_goal=pos,
        next_waypoint=pos,
        sfc_lo=torch.zeros((A, p.M, 3), dtype=torch.int32, device=device),
        sfc_hi=torch.zeros((A, p.M, 3), dtype=torch.int32, device=device),
        sfc_initialized=torch.zeros((A,), dtype=torch.bool, device=device),
        planner_seq=1,
        qp_y0=torch.zeros((A, qp.n_rows(planner.qp_cfg)), dtype=f32, device=device),
    )
    return p, planner, fleet, inp


def advance(p: Param, inp: StepInputs, out) -> StepInputs:
    """The next step's inputs from one step's outputs: ideal dynamics
    along the new plan, the gated waypoint walk, and the dual warm start."""
    pos, vel, acc = trajectory.state_at(out.desired_ctrl, p.multisim_time_step, p.dt)
    pos = pos.clone()
    pos[:, 2] = p.world_z_2d

    # waypoint walk: one grid step toward the goal, only when the goal LP
    # has converged onto the current waypoint AND the new waypoint stays
    # within half the comm range of every previous segment start
    wp = inp.next_waypoint
    cand = wp + torch.clamp(inp.desired_goal - wp, -p.grid_resolution, p.grid_resolution)
    seg_pts = torch.cat([out.desired_ctrl[:, :, 0], out.desired_ctrl[:, -1:, -1]],
                        dim=1)  # [A, M+1, 3]
    reach = ((cand[:, None] - seg_pts).abs().amax(dim=(-2, -1))
             < 0.5 * p.communication_range - 1e-5)
    conv = torch.linalg.vector_norm(out.current_goal - wp, dim=-1) < 1e-5
    wp = torch.where((reach & conv)[:, None], cand, wp)

    return dataclasses.replace(
        inp, pos=pos, vel=vel, acc=acc,
        prev_ctrl=out.desired_ctrl,
        has_prev=torch.ones_like(inp.has_prev),
        current_goal=out.current_goal,
        next_waypoint=wp,
        sfc_lo=out.sfc_lo, sfc_hi=out.sfc_hi,
        sfc_initialized=out.sfc_initialized,
        planner_seq=inp.planner_seq + 1,
        qp_y0=out.qp_y,
    )


def make_evolve_step(p: Param, planner: FleetPlanner, fleet: FleetArrays):
    """One fleet step: the full pipeline, then `advance`. Returns
    step_fn(inp) → (new_inp, qp_converged)."""

    def step_fn(inp: StepInputs):
        out = planner.step(fleet, inp)
        return advance(p, inp, out), out.qp_converged

    return step_fn
