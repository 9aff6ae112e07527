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
from lsc_dr_planner_tpu_torch.planner import goal as goalmod
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
class NeighborData:
    """Each agent's OA neighbour slots, [A, OA, ...]: the fields of the
    reference's broadcast obstacle message. `FleetPlanner._gather_neighbors`
    builds it from the whole fleet; the multi-device steps build it from
    the candidates the ranks exchange."""

    prev_ctrl: torch.Tensor  # [A, OA, M, N, 3]
    has_prev: torch.Tensor  # [A, OA]
    pos: torch.Tensor  # [A, OA, 3]
    vel: torch.Tensor  # [A, OA, 3]
    radius: torch.Tensor  # [A, OA]
    downwash: torch.Tensor  # [A, OA]
    goal: torch.Tensor  # [A, OA, 3]
    valid: torch.Tensor  # [A, OA] bool


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
        valid [S·A, OA])."""
        p = self.param
        S = scenarios
        A = inp.pos.shape[0] // S
        pos = inp.pos.reshape(S, A, -1)
        dist = (pos[:, :, None] - pos[:, None, :]).abs().amax(dim=-1)  # [S, A, A]
        dist = dist + torch.eye(A, dtype=dist.dtype, device=dist.device) * 1e9
        if p.communication_range > 0:
            dist = torch.where(dist < p.communication_range, dist, 1e9)
        # top-k nearest; a stable sort keeps the lower index first among
        # ties, as lax.top_k does
        srt = torch.sort(-dist, dim=-1, descending=True, stable=True)
        neg_top = srt.values[..., : self.O_agents]
        order = srt.indices[..., : self.O_agents]
        order = order + A * torch.arange(S, device=order.device)[:, None, None]
        return order.reshape(S * A, -1), (-neg_top < 1e8).reshape(S * A, -1)

    def _gather_neighbors(self, fleet: FleetArrays, inp: StepInputs,
                          scenarios: int = 1) -> NeighborData:
        """The neighbour slots of `_neighbor_slots`, gathered from the
        fleet on this device."""
        order, valid = self._neighbor_slots(inp, scenarios)
        return NeighborData(
            prev_ctrl=inp.prev_ctrl[order], has_prev=inp.has_prev[order],
            pos=inp.pos[order], vel=inp.vel[order], radius=fleet.radius[order],
            downwash=fleet.downwash[order], goal=inp.current_goal[order], valid=valid)

    def _shift(self, ctrl):
        """The previous solution moved on by one replanning period: a whole
        segment, or the sub-segment ts/dt in DLSC sub-step mode."""
        p = self.param
        if p.multisim_time_step == p.dt:
            return trajectory.shift_one_segment(ctrl)
        return trajectory.subsegment_first(ctrl, p.multisim_time_step / p.dt)

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
        A, O, OA, OD = inp.pos.shape[0], self.O, self.O_agents, self.OD
        M, n, N, phi = p.M, p.n, p.n + 1, p.phi
        dt = p.dt
        f32 = torch.float32
        dev = inp.pos.device
        mode = p.planner_mode
        lsc_family = mode in (PlannerMode.DLSC, PlannerMode.LSC)
        self._events = []
        self._mark("start")

        if neighbors is not None and scenarios > 1:
            raise ValueError("neighbors= plans one scenario; the scenarios= path "
                             "gathers its own neighbour slots")
        nd = neighbors if neighbors is not None else self._gather_neighbors(
            fleet, inp, scenarios)
        agent_valid = nd.valid
        self._mark("neighbors")

        # ---------- stage 1: obstacle prediction --------------------------
        nbr_pos = nd.pos
        nbr_vel = nd.vel
        if lsc_family:
            agent_pred = torch.where(nd.has_prev[..., None, None, None],
                                     self._shift(nd.prev_ctrl),
                                     trajectory.const_vel_ctrl(nbr_pos, nbr_vel, M, n, dt))
        elif mode == PlannerMode.BVC:
            agent_pred = trajectory.const_vel_ctrl(nbr_pos, torch.zeros_like(nbr_vel),
                                                   M, n, dt)
        else:  # RSFC (and the circle test): constant velocity
            agent_pred = trajectory.const_vel_ctrl(nbr_pos, nbr_vel, M, n, dt)
        # disturbance reset: the prediction must start at the observed position
        pred_err = torch.linalg.vector_norm(agent_pred[..., 0, 0, :] - nbr_pos, dim=-1)
        hold = trajectory.const_vel_ctrl(nbr_pos, torch.zeros_like(nbr_vel), M, n, dt)
        obs_pred = torch.where((pred_err > p.reset_threshold)[..., None, None, None],
                               hold, agent_pred)
        obs_valid = agent_valid
        obs_is_agent = torch.ones((A, OA), dtype=torch.bool, device=dev)
        obs_radius = nd.radius
        obs_downwash = nd.downwash
        obs_max_acc = torch.zeros((A, OA), dtype=f32, device=dev)
        obs_pos_now = nbr_pos
        obs_goal = nd.goal
        if OD > 0:
            # dynamic obstacles: constant velocity, seen by every agent of
            # their scenario
            S = scenarios

            def with_dyn(x, d):
                tail = x.shape[2:]
                d = d.reshape(S, 1, OD, *tail).expand(S, A // S, OD, *tail)
                return torch.cat([x, d.reshape(A, OD, *tail)], dim=1)

            obs_pred = with_dyn(obs_pred, trajectory.const_vel_ctrl(
                inp.dynobs_pos, inp.dynobs_vel, M, n, dt))
            obs_valid = with_dyn(obs_valid, inp.dynobs_valid)
            obs_is_agent = with_dyn(obs_is_agent, torch.zeros_like(inp.dynobs_valid))
            obs_radius = with_dyn(obs_radius, inp.dynobs_radius)
            obs_downwash = with_dyn(obs_downwash, inp.dynobs_downwash)
            obs_max_acc = with_dyn(obs_max_acc, inp.dynobs_max_acc)
            obs_pos_now = with_dyn(obs_pos_now, inp.dynobs_pos)
            obs_goal = with_dyn(obs_goal, inp.dynobs_pos)
        elif O > OA:  # degenerate padding slot (single agent)
            pad = O - OA

            def padcat(x, fill=0.0):
                return torch.cat(
                    [x, torch.full((A, pad) + x.shape[2:], fill, dtype=x.dtype,
                                   device=dev)], dim=1)

            obs_pred = padcat(obs_pred)
            obs_valid = padcat(obs_valid, False)
            obs_is_agent = padcat(obs_is_agent, False)
            obs_radius = padcat(obs_radius, 0.1)
            obs_downwash = padcat(obs_downwash, 1.0)
            obs_max_acc = padcat(obs_max_acc)
            obs_pos_now = padcat(obs_pos_now)
            obs_goal = padcat(obs_goal)

        # size prediction: constant-acceleration uncertainty growth and the
        # velocity guard, for dynamic obstacles (every slot in RSFC); read
        # by plain LSC and RSFC only
        grid_goals = p.goal_mode == GoalMode.GRID_BASED_PLANNER
        obs_pred_sizes = None
        if not (lsc_family and grid_goals) and mode != PlannerMode.BVC:
            size_base = obs_radius[..., None, None].expand(A, O, M, N)
            obs_pred_sizes = size_base
            if p.obs_size_prediction:
                if p.use_velocity_guard:
                    vel_guard = (p.velocity_guard_ratio * torch.sum(inp.vel ** 2, dim=-1)
                                 / fleet.max_acc[:, 0])
                else:
                    vel_guard = torch.zeros((A,), dtype=f32, device=dev)
                grown = (size_base + vel_guard[:, None, None, None]
                         + obs_max_acc[..., None, None] * self._growth[None, None])
                use_growth = ~obs_is_agent | (mode == PlannerMode.RECIPROCAL_RSFC)
                obs_pred_sizes = torch.where(use_growth[..., None, None], grown, size_base)
        self._mark("prediction")

        # ---------- stage 2: initial trajectory ---------------------------
        if lsc_family:
            initial_ctrl = torch.where(inp.has_prev[..., None, None, None],
                                       self._shift(inp.prev_ctrl),
                                       trajectory.const_vel_ctrl(inp.pos, inp.vel, M, n, dt))
        elif mode == PlannerMode.BVC:
            initial_ctrl = trajectory.const_vel_ctrl(inp.pos, torch.zeros_like(inp.vel),
                                                     M, n, dt)
        else:
            initial_ctrl = trajectory.const_vel_ctrl(inp.pos, inp.vel, M, n, dt)
        hold_self = trajectory.const_vel_ctrl(inp.pos, torch.zeros_like(inp.vel), M, n, dt)
        initial_ctrl = torch.where(inp.is_disturbed[..., None, None, None],
                                   hold_self, initial_ctrl)
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
            ls = lsc.build_lsc(initial_ctrl, obs_pred, obs_pred_sizes, fleet.radius,
                               fleet.downwash, obs_radius, obs_downwash, obs_is_agent,
                               obs_pos_now, inp.current_goal, obs_valid)
        elif mode == PlannerMode.BVC:
            ls = lsc.build_bvc(initial_ctrl, obs_pred, fleet.radius, fleet.downwash,
                               obs_radius, obs_downwash, obs_is_agent, obs_valid)
        else:
            ls = lsc.build_reciprocal_rsfc(initial_ctrl, obs_pred, obs_pred_sizes,
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

        # ---------- stage 5: goal planning --------------------------------
        dim = p.world_dimension
        if grid_goals:
            new_goal, _ = goalmod.goal_lp(
                inp.current_goal, inp.next_waypoint,
                ls.normals[:, :, M - 1, :], ls.anchors[:, :, M - 1, N - 1, :],
                ls.margins[:, :, M - 1, N - 1], obs_valid,
                sfc_lo_w[:, M - 1], sfc_hi_w[:, M - 1], dim,
                use_sfc=p.world_use_octomap)
        elif p.goal_mode == GoalMode.RIGHT_HAND:
            dl = goalmod.is_deadlock(inp.planner_seq, inp.vel, inp.pos, inp.desired_goal,
                                     p.deadlock_velocity_threshold,
                                     p.deadlock_seq_threshold)
            new_goal = goalmod.right_hand_goal(inp.pos, inp.desired_goal, dl)
        elif p.goal_mode in (GoalMode.PRIOR_BASED, GoalMode.DYNAMIC_PRIORITY):
            # the host computes these goals (planner/priority.py)
            new_goal = inp.current_goal
        else:  # STATIC
            new_goal = inp.desired_goal
        # disturbed agents hold position as goal
        new_goal = torch.where(inp.is_disturbed[..., None], inp.pos, new_goal)
        self._mark("goal")

        # ---------- stage 6: trajectory optimization ----------------------
        # terminal segments from the nominal-velocity flight-time heuristic
        dist_goal = torch.linalg.vector_norm(new_goal - inp.pos, dim=-1)
        ift = dist_goal / fleet.nominal_velocity
        tseg = torch.clamp(torch.floor((M * dt - ift + 1e-9) / dt).to(torch.int32), min=1)
        seg_idx = torch.arange(M, device=dev)[None, :]
        terminal_mask = (seg_idx >= (M - tseg[:, None])).to(f32)

        nrm = ls.normals[..., :dim]
        # tiny margin inflation: solutions within the ADMM feasibility
        # tolerance still certify true separation. In sub-step mode it is
        # sized above the loosened gate (feas_tol), and covers the shift of
        # the pairwise point correspondence inside the first segment.
        qp_margin = 1e-2 if self.substep else 1e-3
        rhs = (torch.einsum("aomd,aomnd->aomn", nrm, ls.anchors[..., :dim])
               + ls.margins + qp_margin)
        nnorm = torch.linalg.vector_norm(ls.normals, dim=-1)
        active = (obs_valid[..., None, None] & (nnorm > 1e-6)[..., None]).expand(
            A, O, M, N).clone()
        active[:, :, 0, :phi] = False

        # variable bounds: the world (∩ SFC with the octomap), plus the
        # waypoint comm box on the segment ends
        lb = self._world_box[0][None, :dim, None, None].expand(A, dim, M, N)
        ub = self._world_box[1][None, :dim, None, None].expand(A, dim, M, N)
        if p.world_use_octomap:
            lb = torch.maximum(lb, sfc_lo_w[..., :dim].transpose(1, 2)[..., None])
            ub = torch.minimum(ub, sfc_hi_w[..., :dim].transpose(1, 2)[..., None])
        lb, ub = lb.clone(), ub.clone()
        if p.communication_range > 0:
            wp = inp.next_waypoint[..., :dim]
            half = 0.5 * p.communication_range - 1e-6
            lb[..., N - 1] = torch.maximum(lb[..., N - 1], (wp - half)[:, :, None])
            ub[..., N - 1] = torch.minimum(ub[..., N - 1], (wp + half)[:, :, None])
            comm_half = torch.full((A,), 0.5 * p.communication_range, dtype=f32,
                                   device=dev) - fleet.radius
        else:
            comm_half = torch.full((A,), 1e19, dtype=f32, device=dev)

        if self.debug:
            self._dbg = dict(
                ls=ls, obs_valid=obs_valid, obs_pred=obs_pred, sfc_lo_w=sfc_lo_w,
                sfc_hi_w=sfc_hi_w, new_goal=new_goal, initial_ctrl=initial_ctrl, nd=nd,
                lb=lb, ub=ub, terminal_mask=terminal_mask, rhs=rhs, active=active)

        y0 = None
        if inp.qp_y0 is not None and p.qp_warm_start_duals:
            # duals carry over only when the problem is a shifted
            # continuation of last step's (fresh or disturbed agents cold-start)
            y0 = inp.qp_y0 * (inp.has_prev & ~inp.is_disturbed)[:, None].to(f32)
        qp_inp = qp.QPInputs(
            p0=inp.pos[:, :dim], v0=inp.vel[:, :dim], a0=inp.acc[:, :dim],
            goal=new_goal[:, :dim], terminal_mask=terminal_mask,
            lsc_normals=nrm, lsc_rhs=rhs, lsc_active=active,
            vmax=fleet.max_vel[:, :dim], amax=fleet.max_acc[:, :dim],
            lb=lb, ub=ub, comm_halfrange=comm_half,
            x0=initial_ctrl[..., :dim].permute(0, 3, 1, 2), y0=y0,
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
