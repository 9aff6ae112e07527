"""The per-step planning pipeline, batched over the whole fleet (port of
lsc_dr_planner_tpu/planner/pipeline.py).

One call of `FleetPlanner.step` runs six stages for every agent at once:

  1. obstacle prediction — top-k neighbour gather, the previous-solution
     shift (LSC family; a sub-segment shift in DLSC sub-step mode),
     constant velocity (RSFC) or constant position (BVC), disturbance
     reset, dynamic obstacles after the agent slots, and their size
     growth
  2. initial trajectory
  3. the corridor of the planner mode (ops/lsc.py): CLSC (LSC family
     with the DR goal mode), plain LSC, BVC or Reciprocal RSFC
  4. SFC update (ops/sfc.py) in 'hull', 'point' or 'substep' mode, or
     unbounded boxes without the octomap
  5. goal planning — the closed-form goal LP (DR goal mode), the
     right-hand-rule detour, host goals (priority modes) or the
     static goal (planner/goal.py)
  6. trajectory optimization — the batched ADMM QP (ops/qp.py), whose
     iteration loop is the CUDA kernel on a CUDA device

The neighbour slots, stages 1 and 2, and stage 5 with the QP-input
assembly of stage 6 are three entries of planner/stages.py: one launch
each of a hand-written kernel on the card (csrc/step_stages.cu), their
plain torch bodies on the CPU.

Every planner mode, goal mode and world option of the JAX package runs,
in 2-D and 3-D. In local-sensing mode (`StepInputs.occ_known`) the step
builds each agent's blocked lattice and integral image from its known
map (world/grid.py::blocked_cumsum) and the SFC update reads them.

`neighbors=` replaces the step's own neighbour gather with a
`NeighborData` built elsewhere: the multi-device steps
(parallel/mesh.py, parallel/halo.py) select each local agent's
neighbours from candidates gathered over the ranks. With `debug` set,
the step keeps its intermediates in `_dbg` (sim/replay.py draws them).

`scenarios=S` plans S independent scenarios of the same fleet as one
flattened fleet of S·A agents (Monte-Carlo, sim/montecarlo.py): the
neighbour slots stay inside each scenario, dynamic obstacles are per
scenario, and every other stage is per agent; only the QP's global exit
spans the batch, as in the JAX package's flattened Monte-Carlo QP.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from lsc_dr_planner_tpu_torch.config import GoalMode, Param, PlannerMode
from lsc_dr_planner_tpu_torch.ops import bernstein, lsc, qp, sfc, trajectory
from lsc_dr_planner_tpu_torch.planner import stages
from lsc_dr_planner_tpu_torch.planner.stages import NeighborData
from lsc_dr_planner_tpu_torch.world.grid import GridWorld, blocked_cumsum, local_grid_world


@dataclasses.dataclass
class FleetArrays:
    """Static per-agent attributes."""

    radius: torch.Tensor  # [A]
    downwash: torch.Tensor  # [A]
    max_vel: torch.Tensor  # [A, 3]
    max_acc: torch.Tensor  # [A, 3]
    nominal_velocity: torch.Tensor  # [A]


@dataclasses.dataclass
class StepInputs:
    """Per-step dynamic inputs."""

    pos: torch.Tensor  # [A, 3]
    vel: torch.Tensor  # [A, 3]
    acc: torch.Tensor  # [A, 3]
    prev_ctrl: torch.Tensor  # [A, M, N, 3] previous solutions
    has_prev: torch.Tensor  # [A] bool
    is_disturbed: torch.Tensor  # [A] bool
    desired_goal: torch.Tensor  # [A, 3]
    current_goal: torch.Tensor  # [A, 3] (from the previous step's goal planning)
    next_waypoint: torch.Tensor  # [A, 3] (from the waypoint layer)
    sfc_lo: torch.Tensor  # [A, M, 3] int32 lattice boxes
    sfc_hi: torch.Tensor  # [A, M, 3]
    sfc_initialized: torch.Tensor  # [A] bool
    planner_seq: int
    # dynamic obstacles, OD slots (None when the planner has none); with
    # scenarios=S, one set per scenario: [S, OD, ...]
    dynobs_pos: Optional[torch.Tensor] = None  # [OD, 3]
    dynobs_vel: Optional[torch.Tensor] = None  # [OD, 3]
    dynobs_radius: Optional[torch.Tensor] = None  # [OD]
    dynobs_downwash: Optional[torch.Tensor] = None  # [OD]
    dynobs_max_acc: Optional[torch.Tensor] = None  # [OD]
    dynobs_valid: Optional[torch.Tensor] = None  # [OD] bool
    # per-agent known occupancy [A, X, Y, Z] bool (local-sensing mode;
    # None with the global map)
    occ_known: Optional[torch.Tensor] = None
    # previous step's ADMM duals [A, R] (qp.n_rows rows; None = cold)
    qp_y0: Optional[torch.Tensor] = None


@dataclasses.dataclass
class DeferredQP:
    """Stage 1–5 products and the assembled QP, returned by
    `_step_impl(..., defer_qp=True)`."""

    qp_inp: qp.QPInputs
    initial_ctrl: torch.Tensor
    new_goal: torch.Tensor
    new_sfc_lo: torch.Tensor
    new_sfc_hi: torch.Tensor
    obs_pred: torch.Tensor


@dataclasses.dataclass
class StepOutputs:
    desired_ctrl: torch.Tensor  # [A, M, N, 3]
    current_goal: torch.Tensor  # [A, 3]
    sfc_lo: torch.Tensor  # [A, M, 3]
    sfc_hi: torch.Tensor  # [A, M, 3]
    sfc_initialized: torch.Tensor  # [A]
    qp_converged: torch.Tensor  # [A]
    qp_residual: torch.Tensor  # [A]
    qp_iterations: torch.Tensor  # [A]
    obs_pred_ctrl: torch.Tensor  # [A, O, M, N, 3]
    initial_ctrl: torch.Tensor  # [A, M, N, 3]
    qp_y: Optional[torch.Tensor] = None  # [A, R] duals — next warm start


class FleetPlanner:
    """The static planner configuration and the fused fleet step.

    `timing=True` records a CUDA event at every stage boundary of each
    step (on a CUDA device); `stage_times_ms()` then returns the last
    step's per-stage device times."""

    def __init__(self, param: Param, world: GridWorld, n_agents: int,
                 max_dynobs: int = 0, agent_radius: float = 0.15,
                 max_vel_hint: float = 2.0, timing: bool = False):
        p = param
        self.param = p
        self.world = world
        self.device = world.device
        self.sfc_margin = agent_radius
        # SFC expansion clamp: corridor boxes persist M shift steps, so a
        # box built now can still bound control points up to 3·M·dt·v_max
        # away from its seed; growth beyond that is physically non-binding
        self.sfc_expand_cells = int(np.ceil(
            (3.0 * p.M * p.dt * max_vel_hint + 1.0) / p.world_resolution))
        # neighbour slots: the nearest other agents, then dynamic obstacles
        self.O_agents = min(n_agents - 1, p.max_obstacles)
        self.OD = max_dynobs
        self.O = max(self.O_agents + self.OD, 1)  # keep shapes non-degenerate
        # DLSC replanning more often than once a segment
        self.substep = (p.planner_mode == PlannerMode.DLSC
                        and p.multisim_time_step != p.dt)
        self.qp_cfg = qp.QPConfig(
            dim=p.world_dimension, M=p.M, n=p.n, phi=p.phi, n_obs=self.O,
            use_comm=p.communication_range > 0,
            stop_at_horizon=p.planner_mode == PlannerMode.LSC, dt=p.dt,
            control_input_weight=p.control_input_weight,
            terminal_weight=p.terminal_weight, rho=p.qp_rho, sigma=p.qp_sigma,
            alpha=p.qp_alpha, max_iter=p.qp_max_iter, eps_abs=p.qp_eps_abs,
            rescue_iter=p.qp_rescue_iter,
        )
        # [M, N] size growth per unit max acceleration, on the device
        self._growth = torch.as_tensor(
            _uncertainty_growth_table(p.n, p.dt, p.obs_uncertainty_horizon, p.M),
            dtype=torch.float32, device=self.device)
        # the world's box on the device, copied once: a host-to-device copy
        # in the step would hold the host until the card caught up
        self._world_box = tuple(torch.as_tensor(v, dtype=torch.float32, device=self.device)
                                for v in (world.world_min, world.world_max))
        self.stage_cfg = stages.stage_config(p, self.O_agents, self.OD, self.O, self._growth,
                                             *self._world_box)
        self.timing = timing and self.device.type == "cuda"
        self._events = []
        self.debug = False  # keep the step's intermediates in self._dbg
        self._dbg = {}

    # ==================================================================
    def step(self, fleet: FleetArrays, inp: StepInputs) -> StepOutputs:
        return self._step_impl(fleet, inp)

    def _mark(self, name: str):
        if self.timing:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append((name, ev))

    def stage_times_ms(self):
        """Per-stage device milliseconds of the last timed step."""
        torch.cuda.synchronize(self.device)
        out = {}
        for (_, e0), (name, e1) in zip(self._events, self._events[1:]):
            out[name] = e0.elapsed_time(e1)
        out["total"] = self._events[0][1].elapsed_time(self._events[-1][1])
        return out

    # ==================================================================
    def _neighbor_slots(self, inp: StepInputs, scenarios: int = 1):
        """The OA nearest other agents of the same scenario within L∞
        communication range: (order [S·A, OA] into the flattened fleet,
        valid [S·A, OA]) (stages.neighbor_slots)."""
        return stages.neighbor_slots(inp.pos, scenarios, self.stage_cfg)

    def _gather_neighbors(self, fleet: FleetArrays, inp: StepInputs,
                          scenarios: int = 1) -> NeighborData:
        """The neighbour slots of `_neighbor_slots`, gathered from the
        fleet on this device."""
        return stages.gather_neighbors(fleet, inp, *self._neighbor_slots(inp, scenarios))

    # ==================================================================
    def _step_impl(self, fleet: FleetArrays, inp: StepInputs,
                   defer_qp: bool = False, scenarios: int = 1,
                   neighbors: Optional[NeighborData] = None):
        """One planning step of the fleet. With `scenarios` = S, the
        agent axis of `fleet` and `inp` is S scenarios of A agents each,
        scenario-major, and the dynamic obstacles are [S, OD, ...].
        `neighbors` replaces the gather of each agent's neighbour slots
        (one scenario only)."""
        p = self.param
        A, M = inp.pos.shape[0], p.M
        f32 = torch.float32
        dev = inp.pos.device
        mode = p.planner_mode
        lsc_family = mode in (PlannerMode.DLSC, PlannerMode.LSC)
        self._events = []
        self._mark("start")

        if neighbors is not None and scenarios > 1:
            raise ValueError("neighbors= plans one scenario; the scenarios= path "
                             "gathers its own neighbour slots")
        # ---------- the neighbour slots and stages 1 and 2: obstacle
        # prediction, initial trajectory (one launch on the card, the
        # selection inside it: the neighbors and initial_traj marks read ~0)
        self._mark("neighbors")
        order = valid = None
        if neighbors is None:
            order, valid, fr = stages.front_with_neighbors(self.stage_cfg, fleet, inp, scenarios)
        else:
            fr = stages.step_front(self.stage_cfg, fleet, inp, None, None, neighbors, scenarios)
        obs_pred, obs_valid, obs_is_agent = fr.obs_pred, fr.obs_valid, fr.obs_is_agent
        obs_radius, obs_downwash, obs_goal = fr.obs_radius, fr.obs_downwash, fr.obs_goal
        initial_ctrl = fr.initial_ctrl
        grid_goals = p.goal_mode == GoalMode.GRID_BASED_PLANNER
        self._mark("prediction")
        self._mark("initial_traj")

        # ---------- stage 3: corridor construction ------------------------
        if lsc_family and grid_goals:
            # CLSC whenever the DR waypoint layer drives the goals, DLSC
            # included: the layer's deadlock-freedom argument rests on
            # the goal-aware margins
            ls = lsc.build_clsc(initial_ctrl, obs_pred, obs_goal, fleet.radius,
                                fleet.downwash, obs_radius, obs_downwash, obs_is_agent,
                                inp.current_goal, obs_valid, p.world_dimension)
        elif lsc_family:
            ls = lsc.build_lsc(initial_ctrl, obs_pred, fr.obs_pred_sizes, fleet.radius,
                               fleet.downwash, obs_radius, obs_downwash, obs_is_agent,
                               fr.obs_pos_now, inp.current_goal, obs_valid)
        elif mode == PlannerMode.BVC:
            ls = lsc.build_bvc(initial_ctrl, obs_pred, fleet.radius, fleet.downwash,
                               obs_radius, obs_downwash, obs_is_agent, obs_valid)
        else:
            ls = lsc.build_reciprocal_rsfc(initial_ctrl, obs_pred, fr.obs_pred_sizes,
                                           fleet.radius, fleet.downwash, obs_radius,
                                           obs_downwash, obs_is_agent, obs_valid)
        self._mark("lsc")

        # ---------- stage 4: SFC update -----------------------------------
        gw = self.world
        if p.world_use_octomap:
            gw_a = gw
            if inp.occ_known is not None:
                # local sensing: each agent's blocked lattice and integral
                # image, rebuilt from its known map every step
                gw_a = local_grid_world(
                    gw, blocked_cumsum(inp.occ_known, gw.resolution, gw.radius)[1])
                self._mark("local_map")
            sfc_mode = "substep" if self.substep else "hull" if grid_goals else "point"
            # the boxes and their world boxes ('hull' mode on the card: one
            # kernel launch; gw_a's lattice geometry is gw's)
            new_sfc_lo, new_sfc_hi, sfc_lo_w, sfc_hi_w = sfc.update_sfc(
                gw_a, sfc_mode, inp.sfc_lo, inp.sfc_hi,
                inp.sfc_initialized & ~inp.is_disturbed,
                trajectory.last_point(initial_ctrl), inp.current_goal,
                inp.next_waypoint, inp.pos, initial_ctrl, self.sfc_margin,
                max_radius_cells=self.sfc_expand_cells)
        else:
            new_sfc_lo, new_sfc_hi = inp.sfc_lo, inp.sfc_hi
            sfc_lo_w = torch.full((A, M, 3), -1e9, dtype=f32, device=dev)
            sfc_hi_w = torch.full((A, M, 3), 1e9, dtype=f32, device=dev)
        self._mark("sfc")

        # ---------- stage 5 and the QP-input assembly of stage 6 ----------
        # (one launch on the card; stages.py says what it computes)
        gq = stages.goal_qp_inputs(self.stage_cfg, fleet, inp, ls.normals, ls.anchors,
                                   ls.margins, obs_valid, sfc_lo_w, sfc_hi_w,
                                   inp.planner_seq)
        new_goal = gq.new_goal
        self._mark("goal")

        # ---------- stage 6: trajectory optimization ----------------------
        dim = p.world_dimension
        if self.debug:
            nd = neighbors if neighbors is not None else stages.gather_neighbors(
                fleet, inp, order, valid)
            self._dbg = dict(
                ls=ls, obs_valid=obs_valid, obs_pred=obs_pred, sfc_lo_w=sfc_lo_w,
                sfc_hi_w=sfc_hi_w, new_goal=new_goal, initial_ctrl=initial_ctrl, nd=nd,
                lb=gq.lb, ub=gq.ub, terminal_mask=gq.terminal_mask, rhs=gq.lsc_rhs,
                active=gq.lsc_active)

        qp_inp = qp.QPInputs(
            p0=inp.pos[:, :dim], v0=inp.vel[:, :dim], a0=inp.acc[:, :dim],
            goal=new_goal[:, :dim], terminal_mask=gq.terminal_mask,
            lsc_normals=ls.normals[..., :dim], lsc_rhs=gq.lsc_rhs, lsc_active=gq.lsc_active,
            vmax=fleet.max_vel[:, :dim], amax=fleet.max_acc[:, :dim],
            lb=gq.lb, ub=gq.ub, comm_halfrange=gq.comm_halfrange,
            x0=initial_ctrl[..., :dim].permute(0, 3, 1, 2), y0=gq.y0,
        )
        deferred = DeferredQP(qp_inp=qp_inp, initial_ctrl=initial_ctrl,
                              new_goal=new_goal, new_sfc_lo=new_sfc_lo,
                              new_sfc_hi=new_sfc_hi, obs_pred=obs_pred)
        if defer_qp:
            return deferred
        out = qp.solve(self.qp_cfg, qp_inp, feas_tol=self.feas_tol)
        self._mark("qp")
        return self.finish_step(out, deferred)

    # ==================================================================
    @property
    def feas_tol(self) -> float:
        """QP feasibility gate: loosened to 8e-3 in DLSC sub-step mode,
        where crowded CLSC instances stall at an ADMM floor near 7e-3 (the
        1e-2 qp_margin still certifies true separation)."""
        return 8e-3 if self.substep else 5e-3

    # ==================================================================
    def finish_step(self, out: qp.QPResult, d: DeferredQP) -> StepOutputs:
        """Post-QP assembly: 3-D control points (z at world_z_2d in 2-D)
        and the failsafe (keep the initial trajectory where the QP did not
        converge)."""
        p = self.param
        A, M, N = d.initial_ctrl.shape[0], p.M, p.n + 1
        desired = out.x.permute(0, 2, 3, 1)  # [A, M, N, dim]
        if p.world_dimension == 2:
            z = torch.full((A, M, N, 1), p.world_z_2d, dtype=torch.float32,
                           device=desired.device)
            desired = torch.cat([desired, z], dim=-1)
        desired = torch.where(out.converged[..., None, None, None], desired,
                              d.initial_ctrl)
        return StepOutputs(
            desired_ctrl=desired, current_goal=d.new_goal, sfc_lo=d.new_sfc_lo,
            sfc_hi=d.new_sfc_hi,
            sfc_initialized=torch.ones((A,), dtype=torch.bool, device=desired.device),
            qp_converged=out.converged, qp_residual=out.primal_residual,
            qp_iterations=out.iterations, obs_pred_ctrl=d.obs_pred,
            initial_ctrl=d.initial_ctrl, qp_y=out.y,
        )


@functools.lru_cache(maxsize=None)
def _uncertainty_growth_table(n: int, dt: float, horizon: float, M: int):
    """Per-segment Bernstein control points of ½·t² size growth (unit max
    acceleration): [M, n+1]. Feeds the dynamic-obstacle size prediction
    (stage 1)."""
    M_unc = int((horizon + 1e-9) / dt)
    out = np.zeros((M, n + 1))
    for m in range(M):
        if m < M_unc:
            out[m] = bernstein.uncertainty_growth_ctrl(n, dt, 1.0, m)
        else:
            out[m] = 0.5 * (M_unc * dt) ** 2
    return out
