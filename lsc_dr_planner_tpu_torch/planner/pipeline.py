"""The per-step planning pipeline, batched over the whole fleet (port of
lsc_dr_planner_tpu/planner/pipeline.py).

One call of `FleetPlanner.step` runs six stages for every agent at once:

  1. obstacle prediction — top-k neighbour gather, previous-solution
     shift (constant velocity before the first plan), disturbance reset
  2. initial trajectory
  3. CLSC construction (ops/lsc.py)
  4. SFC update in 'hull' mode (ops/sfc.py)
  5. goal planning — the closed-form goal LP (planner/goal.py)
  6. trajectory optimization — the batched ADMM QP (ops/qp.py), whose
     iteration loop is the CUDA kernel on a CUDA device

This slice ports the default configuration: LSC planner, grid-based DR
goal mode, 2-D, global map with the octomap SFC, no dynamic obstacles.
Every other branch raises NotImplementedError naming its ROADMAP item.
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
from lsc_dr_planner_tpu_torch.world.grid import GridWorld


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


def _unsupported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


class FleetPlanner:
    """The static planner configuration and the fused fleet step.

    `timing=True` records a CUDA event at every stage boundary of each
    step (on a CUDA device); `stage_times_ms()` then returns the last
    step's per-stage device times."""

    def __init__(self, param: Param, world: GridWorld, n_agents: int,
                 max_dynobs: int = 0, agent_radius: float = 0.15,
                 max_vel_hint: float = 2.0, timing: bool = False):
        p = param
        if p.planner_mode != PlannerMode.LSC or p.multisim_time_step != p.dt:
            _unsupported(f"planner mode {p.planner_mode.name}", "12")
        if p.goal_mode != GoalMode.GRID_BASED_PLANNER:
            _unsupported(f"goal mode {p.goal_mode.name}", "12")
        if p.world_dimension != 2:
            _unsupported("world_dimension 3", "12")
        if not p.world_use_octomap:
            _unsupported("world_use_octomap=False", "12")
        if not p.world_use_global_map:
            _unsupported("local sensing (occ_known)", "12")
        if max_dynobs > 0:
            _unsupported("dynamic obstacles", "12")
        self.param = p
        self.world = world
        self.device = world.device
        self.sfc_margin = agent_radius
        # SFC expansion clamp: corridor boxes persist M shift steps, so a
        # box built now can still bound control points up to 3·M·dt·v_max
        # away from its seed; growth beyond that is physically non-binding
        self.sfc_expand_cells = int(np.ceil(
            (3.0 * p.M * p.dt * max_vel_hint + 1.0) / p.world_resolution))
        self.O_agents = min(n_agents - 1, p.max_obstacles)
        self.O = max(self.O_agents, 1)  # keep shapes non-degenerate
        self.qp_cfg = qp.QPConfig(
            dim=p.world_dimension, M=p.M, n=p.n, phi=p.phi, n_obs=self.O,
            use_comm=p.communication_range > 0, stop_at_horizon=True, dt=p.dt,
            control_input_weight=p.control_input_weight,
            terminal_weight=p.terminal_weight, rho=p.qp_rho, sigma=p.qp_sigma,
            alpha=p.qp_alpha, max_iter=p.qp_max_iter, eps_abs=p.qp_eps_abs,
            rescue_iter=p.qp_rescue_iter,
        )
        self.timing = timing and self.device.type == "cuda"
        self._events = []

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
    def _neighbor_slots(self, inp: StepInputs):
        """The OA nearest other agents within L∞ communication range:
        (order [A, OA], valid [A, OA])."""
        p = self.param
        pos = inp.pos
        A = pos.shape[0]
        dist = (pos[:, None] - pos[None, :]).abs().amax(dim=-1)
        dist = dist + torch.eye(A, dtype=dist.dtype, device=dist.device) * 1e9
        if p.communication_range > 0:
            dist = torch.where(dist < p.communication_range, dist, 1e9)
        # top-k nearest; a stable sort keeps the lower index first among
        # ties, as lax.top_k does
        srt = torch.sort(-dist, dim=-1, descending=True, stable=True)
        neg_top = srt.values[:, : self.O_agents]
        order = srt.indices[:, : self.O_agents]
        return order, -neg_top < 1e8

    # ==================================================================
    def _step_impl(self, fleet: FleetArrays, inp: StepInputs,
                   defer_qp: bool = False):
        p = self.param
        A, O, OA = inp.pos.shape[0], self.O, self.O_agents
        M, n, N, phi = p.M, p.n, p.n + 1, p.phi
        dt = p.dt
        f32 = torch.float32
        dev = inp.pos.device
        self._events = []
        self._mark("start")

        order, obs_valid = self._neighbor_slots(inp)
        self._mark("neighbors")

        # ---------- stage 1: obstacle prediction --------------------------
        nbr_pos = inp.pos[order]
        nbr_vel = inp.vel[order]
        shifted = trajectory.shift_one_segment(inp.prev_ctrl[order])
        const_vel = trajectory.const_vel_ctrl(nbr_pos, nbr_vel, M, n, dt)
        obs_pred = torch.where(inp.has_prev[order][..., None, None, None],
                               shifted, const_vel)
        # disturbance reset: the prediction must start at the observed position
        pred_err = torch.linalg.vector_norm(obs_pred[..., 0, 0, :] - nbr_pos, dim=-1)
        hold = trajectory.const_vel_ctrl(nbr_pos, torch.zeros_like(nbr_vel), M, n, dt)
        obs_pred = torch.where((pred_err > p.reset_threshold)[..., None, None, None],
                               hold, obs_pred)
        obs_is_agent = torch.ones((A, OA), dtype=torch.bool, device=dev)
        obs_radius = fleet.radius[order]
        obs_downwash = fleet.downwash[order]
        obs_goal = inp.current_goal[order]
        if O > OA:  # degenerate padding slot (single agent)
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
            obs_goal = padcat(obs_goal)
        self._mark("prediction")

        # ---------- stage 2: initial trajectory ---------------------------
        own_shift = trajectory.shift_one_segment(inp.prev_ctrl)
        own_cv = trajectory.const_vel_ctrl(inp.pos, inp.vel, M, n, dt)
        initial_ctrl = torch.where(inp.has_prev[..., None, None, None], own_shift, own_cv)
        hold_self = trajectory.const_vel_ctrl(inp.pos, torch.zeros_like(inp.vel), M, n, dt)
        initial_ctrl = torch.where(inp.is_disturbed[..., None, None, None],
                                   hold_self, initial_ctrl)
        self._mark("initial_traj")

        # ---------- stage 3: CLSC construction ----------------------------
        ls = lsc.build_clsc(initial_ctrl, obs_pred, obs_goal, fleet.radius,
                            fleet.downwash, obs_radius, obs_downwash, obs_is_agent,
                            inp.current_goal, obs_valid, p.world_dimension)
        self._mark("lsc")

        # ---------- stage 4: SFC update ('hull' mode) ---------------------
        gw = self.world
        new_sfc_lo, new_sfc_hi = sfc.update_sfc_fused(
            gw, inp.sfc_lo, inp.sfc_hi, inp.sfc_initialized & ~inp.is_disturbed,
            trajectory.last_point(initial_ctrl), inp.current_goal,
            inp.next_waypoint, inp.pos, max_radius_cells=self.sfc_expand_cells)
        sfc_lo_w, sfc_hi_w = sfc.sfc_to_world(gw, new_sfc_lo, new_sfc_hi,
                                              self.sfc_margin)
        self._mark("sfc")

        # ---------- stage 5: goal planning --------------------------------
        dim = p.world_dimension
        new_goal, _ = goalmod.goal_lp(
            inp.current_goal, inp.next_waypoint,
            ls.normals[:, :, M - 1, :], ls.anchors[:, :, M - 1, N - 1, :],
            ls.margins[:, :, M - 1, N - 1], obs_valid,
            sfc_lo_w[:, M - 1], sfc_hi_w[:, M - 1], dim, use_sfc=True)
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
        # tolerance still certify true separation
        qp_margin = 1e-3
        rhs = (torch.einsum("aomd,aomnd->aomn", nrm, ls.anchors[..., :dim])
               + ls.margins + qp_margin)
        nnorm = torch.linalg.vector_norm(ls.normals, dim=-1)
        active = (obs_valid[..., None, None] & (nnorm > 1e-6)[..., None]).expand(
            A, O, M, N).clone()
        active[:, :, 0, :phi] = False

        # variable bounds: world ∩ SFC, plus the waypoint comm box on
        # the segment ends
        wmin = torch.tensor(gw.world_min[:dim], dtype=f32, device=dev)
        wmax = torch.tensor(gw.world_max[:dim], dtype=f32, device=dev)
        lb = torch.maximum(wmin[None, :, None, None],
                           sfc_lo_w[..., :dim].transpose(1, 2)[..., None]).expand(
            A, dim, M, N).clone()
        ub = torch.minimum(wmax[None, :, None, None],
                           sfc_hi_w[..., :dim].transpose(1, 2)[..., None]).expand(
            A, dim, M, N).clone()
        if p.communication_range > 0:
            wp = inp.next_waypoint[..., :dim]
            half = 0.5 * p.communication_range - 1e-6
            lb[..., N - 1] = torch.maximum(lb[..., N - 1], (wp - half)[:, :, None])
            ub[..., N - 1] = torch.minimum(ub[..., N - 1], (wp + half)[:, :, None])
            comm_half = torch.full((A,), 0.5 * p.communication_range, dtype=f32,
                                   device=dev) - fleet.radius
        else:
            comm_half = torch.full((A,), 1e19, dtype=f32, device=dev)

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
        """QP feasibility gate (8e-3 in DLSC sub-step mode, not ported)."""
        return 5e-3

    # ==================================================================
    def finish_step(self, out: qp.QPResult, d: DeferredQP) -> StepOutputs:
        """Post-QP assembly: 3-D control points and the failsafe (keep the
        initial trajectory where the QP did not converge)."""
        p = self.param
        A, M, N = d.initial_ctrl.shape[0], p.M, p.n + 1
        desired = out.x.permute(0, 2, 3, 1)  # [A, M, N, dim]
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
    of the plain LSC and RSFC modes (ROADMAP Queue 1 item 12)."""
    M_unc = int((horizon + 1e-9) / dt)
    out = np.zeros((M, n + 1))
    for m in range(M):
        if m < M_unc:
            out[m] = bernstein.uncertainty_growth_ctrl(n, dt, 1.0, m)
        else:
            out[m] = 0.5 * (M_unc * dt) ** 2
    return out
