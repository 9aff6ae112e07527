"""The fleet step's neighbour, prediction, goal and QP-input stages
(planner/pipeline.py), each one entry that runs on CUDA tensors as one
launch of a hand-written kernel (`csrc/step_stages.cu` through
`ops/step_cuda.py`) and on CPU tensors as its plain torch body:

- `neighbor_slots`: each agent's OA nearest other agents of its scenario
  by L∞ distance (the JAX package's planner/pipeline.py:226-252,
  `lax.top_k`);
- `step_front`: stage 1, the obstacle prediction (the neighbour gather,
  the previous-solution shift or constant velocity, the disturbance
  reset, dynamic obstacles, the padding slot, the size prediction), and
  stage 2, the initial trajectory (pipeline.py:292-445,
  ops/trajectory.py:22, 83, 99);
- `front_with_neighbors`: the two above in one launch on the card (each
  block selects its agent's neighbours, then predicts from them), the
  step's own (`step_front` alone serves the multi-device steps' gathered
  slots);
- `goal_qp_inputs`: stage 5, the goal of every goal mode
  (planner/goal.py:26-122), and the QP-input assembly of stage 6
  (pipeline.py:566-690): terminal segments, LSC rows and their
  activity, variable bounds, the comm box and the masked warm start.

None of them was a Pallas kernel: the JAX package ran them as XLA
fusions inside its jitted step. The plain bodies pin the rounding torch
leaves open (each sum over coordinates or Bézier points left to right,
each product and sum rounded on its own; square roots in float64; the
Python scalars rounded to float32 where they meet a tensor, which torch
does), so that the kernels repeat them bit for bit on the card and a
Python twin on the CPU. `plain=True` forces the plain body on any
device, for comparisons; `*_plain_on_cuda` count the plain bodies run
on CUDA tensors since `reset_counts()`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lsc_dr_planner_tpu_torch.config import GoalMode, Param, PlannerMode
from lsc_dr_planner_tpu_torch.ops import bernstein, geometry, step_cuda, trajectory
from lsc_dr_planner_tpu_torch.planner import goal as goalmod

neighbor_plain_on_cuda = 0  # plain neighbour selections run on CUDA tensors since the last reset
front_plain_on_cuda = 0  # plain prediction and initial-trajectory bodies on CUDA tensors
fused_plain_on_cuda = 0  # plain selection-and-prediction bodies on CUDA tensors
goal_plain_on_cuda = 0  # plain goal and QP-input bodies on CUDA tensors

# the kernels' codes of the planner's and goal's modes
MODE_LSC, MODE_BVC, MODE_RSFC = 0, 1, 2  # LSC family (LSC, DLSC); BVC; RSFC
GOAL_LP, GOAL_RIGHT_HAND, GOAL_HOST, GOAL_STATIC = 0, 1, 2, 3


def reset_counts():
    global neighbor_plain_on_cuda, front_plain_on_cuda, fused_plain_on_cuda, goal_plain_on_cuda
    neighbor_plain_on_cuda = front_plain_on_cuda = fused_plain_on_cuda = goal_plain_on_cuda = 0


@dataclasses.dataclass
class StageConfig:
    """The static settings of the three stages, and their small tables
    on the planner's device."""

    M: int
    n: int
    dt: float
    dim: int
    phi: int
    OA: int  # agent slots
    OD: int  # dynamic-obstacle slots
    O: int  # all slots (OA + OD, or one padding slot)
    mode: int  # MODE_*
    shift_frac: float  # 1.0: shift one segment; else the sub-step's ts/dt
    reset_threshold: float
    comm_range: float
    sizes: bool  # write obs_pred_sizes (plain LSC and RSFC read them)
    size_growth: bool  # p.obs_size_prediction
    velocity_guard: Optional[float]  # the guard's ratio, None without it
    goal: int  # GOAL_*
    use_sfc: bool  # the world map bounds the goal and the variables
    qp_margin: float
    deadlock_velocity: float
    deadlock_seq: int
    warm_duals: bool
    growth: torch.Tensor  # [M, N] size growth per unit max acceleration
    sub: Optional[torch.Tensor]  # [N, N] the sub-step's re-parameterisation (None: a segment)
    world_lo: torch.Tensor  # [3]
    world_hi: torch.Tensor  # [3]
    dt_t: torch.Tensor  # dt as a float32 tensor: a true division on every device
    # stage_scalars, and the kernels' wrappers' checked configurations and
    # packed arguments
    cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)


def stage_config(p: Param, OA: int, OD: int, O: int, growth, world_lo, world_hi) -> StageConfig:
    lsc_family = p.planner_mode in (PlannerMode.DLSC, PlannerMode.LSC)
    grid_goals = p.goal_mode == GoalMode.GRID_BASED_PLANNER
    mode = (MODE_LSC if lsc_family else MODE_BVC if p.planner_mode == PlannerMode.BVC
            else MODE_RSFC)
    goal = {GoalMode.GRID_BASED_PLANNER: GOAL_LP, GoalMode.RIGHT_HAND: GOAL_RIGHT_HAND,
            GoalMode.PRIOR_BASED: GOAL_HOST, GoalMode.DYNAMIC_PRIORITY: GOAL_HOST}.get(
        p.goal_mode, GOAL_STATIC)
    substep = p.planner_mode == PlannerMode.DLSC and p.multisim_time_step != p.dt
    frac = 1.0 if p.multisim_time_step == p.dt else p.multisim_time_step / p.dt
    sub = None
    if frac != 1.0:
        sub = torch.as_tensor(bernstein.subsegment_matrix(p.n, frac, 1.0), dtype=torch.float32,
                              device=growth.device)
    return StageConfig(
        M=p.M, n=p.n, dt=p.dt, dim=p.world_dimension, phi=p.phi, OA=OA, OD=OD, O=O, mode=mode,
        shift_frac=frac, reset_threshold=p.reset_threshold, comm_range=p.communication_range,
        sizes=not (lsc_family and grid_goals) and mode != MODE_BVC,
        size_growth=p.obs_size_prediction,
        velocity_guard=p.velocity_guard_ratio if p.use_velocity_guard else None,
        goal=goal, use_sfc=p.world_use_octomap, qp_margin=1e-2 if substep else 1e-3,
        deadlock_velocity=p.deadlock_velocity_threshold,
        deadlock_seq=p.deadlock_seq_threshold, warm_duals=p.qp_warm_start_duals,
        growth=growth, sub=sub, world_lo=world_lo, world_hi=world_hi,
        dt_t=torch.tensor(p.dt, dtype=torch.float32, device=growth.device))


def stage_scalars(cfg: StageConfig) -> dict:
    """The Python scalars of the stages' arithmetic, each as the float32
    that torch rounds it to where it meets a float32 tensor (one
    operation each), in the plain bodies and the kernels alike (made
    once, kept in cfg.cache)."""
    if "scalars" not in cfg.cache:
        f = lambda x: float(np.float32(x))  # noqa: E731
        cfg.cache["scalars"] = {
            "dt": f(cfg.dt), "reset": f(cfg.reset_threshold), "range": f(cfg.comm_range),
            "Mdt": f(cfg.M * cfg.dt), "tiny": f(1e-9), "qp_margin": f(cfg.qp_margin),
            "comm_box": f(0.5 * cfg.comm_range - 1e-6), "comm_half": f(0.5 * cfg.comm_range),
            "guard": f(cfg.velocity_guard or 0.0), "dl_vel": f(cfg.deadlock_velocity)}
    return cfg.cache["scalars"]


# ----------------------------------------------------------------------
# predictions
# ----------------------------------------------------------------------


def predict(cfg: StageConfig, prev_ctrl, has_prev, pos, vel):
    """The planner mode's trajectory prediction from the previous
    solution (the LSC family; constant velocity where there is none),
    the position (BVC) or constant velocity (RSFC): [..., M, N, 3]."""
    M, n, dt = cfg.M, cfg.n, cfg.dt
    if cfg.mode == MODE_BVC:
        return trajectory.const_vel_ctrl(pos, torch.zeros_like(vel), M, n, dt)
    cv = trajectory.const_vel_ctrl(pos, vel, M, n, dt)
    if cfg.mode == MODE_RSFC:
        return cv
    if cfg.shift_frac == 1.0:
        shifted = trajectory.shift_one_segment(prev_ctrl)
    else:
        shifted = trajectory.subsegment_first(prev_ctrl, cfg.shift_frac)
    return torch.where(has_prev[..., None, None, None], shifted, cv)


# ----------------------------------------------------------------------
# neighbour slots
# ----------------------------------------------------------------------


def neighbor_slots(pos, scenarios: int, cfg: StageConfig, plain: bool = False):
    """The OA nearest other agents of the same scenario within L∞
    communication range, nearest first and the lower index first among
    ties, as lax.top_k and a stable sort give them: (order int64 [S·A,
    OA] into the flattened fleet, valid bool [S·A, OA]); pos is [S·A, 3],
    scenario-major. CUDA tensors go to the kernel (one launch), CPU
    tensors to the plain body; `plain` forces the plain body."""
    global neighbor_plain_on_cuda
    dev = pos.device
    if dev.type == "cuda" and not plain:
        return step_cuda.neighbor_slots_cuda(cfg, stage_scalars(cfg), pos, scenarios)
    if dev.type == "cuda":
        neighbor_plain_on_cuda += 1
    elif dev.type != "cpu":
        raise ValueError(f"no neighbour selection for device {dev}")
    return _neighbor_slots_plain(pos, scenarios, cfg.OA, cfg.comm_range)


def _neighbor_slots_plain(pos, S: int, OA: int, comm_range: float):
    """neighbor_slots' plain version (the torch body): the [S, A, A] L∞
    matrix and a stable sort."""
    A = pos.shape[0] // S
    pos = pos.reshape(S, A, -1)
    dist = (pos[:, :, None] - pos[:, None, :]).abs().amax(dim=-1)  # [S, A, A]
    dist = dist + torch.eye(A, dtype=dist.dtype, device=dist.device) * 1e9
    if comm_range > 0:
        dist = torch.where(dist < comm_range, dist, 1e9)
    srt = torch.sort(-dist, dim=-1, descending=True, stable=True)
    neg_top = srt.values[..., :OA]
    order = srt.indices[..., :OA]
    order = order + A * torch.arange(S, device=order.device)[:, None, None]
    return order.reshape(S * A, -1), (-neg_top < 1e8).reshape(S * A, -1)


@dataclasses.dataclass
class NeighborData:
    """Each agent's OA neighbour slots, [A, OA, ...]: the fields of the
    reference's broadcast obstacle message. `gather_neighbors` builds it
    from the whole fleet (the debug stash's); the multi-device steps
    build it from the candidates the ranks exchange."""

    prev_ctrl: torch.Tensor  # [A, OA, M, N, 3]
    has_prev: torch.Tensor  # [A, OA]
    pos: torch.Tensor  # [A, OA, 3]
    vel: torch.Tensor  # [A, OA, 3]
    radius: torch.Tensor  # [A, OA]
    downwash: torch.Tensor  # [A, OA]
    goal: torch.Tensor  # [A, OA, 3]
    valid: torch.Tensor  # [A, OA] bool


def gather_neighbors(fleet, inp, order, valid) -> NeighborData:
    """The neighbour slots `order` [A, OA] gathered from the fleet (the
    kernel reads the slots through `order` itself)."""
    return NeighborData(
        prev_ctrl=inp.prev_ctrl[order], has_prev=inp.has_prev[order], pos=inp.pos[order],
        vel=inp.vel[order], radius=fleet.radius[order], downwash=fleet.downwash[order],
        goal=inp.current_goal[order], valid=valid)


# ----------------------------------------------------------------------
# stages 1 and 2: obstacle prediction and the initial trajectory
# ----------------------------------------------------------------------


@dataclasses.dataclass
class Front:
    """Stage 1 and 2 products: the O obstacle slots [A, O, ...] and the
    initial trajectory."""

    obs_pred: torch.Tensor  # [A, O, M, N, 3]
    obs_valid: torch.Tensor  # [A, O] bool
    obs_is_agent: torch.Tensor  # [A, O] bool
    obs_radius: torch.Tensor  # [A, O]
    obs_downwash: torch.Tensor  # [A, O]
    obs_max_acc: torch.Tensor  # [A, O]
    obs_pos_now: torch.Tensor  # [A, O, 3]
    obs_goal: torch.Tensor  # [A, O, 3]
    initial_ctrl: torch.Tensor  # [A, M, N, 3]
    obs_pred_sizes: Optional[torch.Tensor]  # [A, O, M, N] (cfg.sizes)


def step_front(cfg: StageConfig, fleet, inp, order=None, valid=None, neighbors=None,
               scenarios: int = 1, plain: bool = False) -> Front:
    """Stages 1 and 2 of the step for every agent: each slot's predicted
    trajectory and attributes, and the agent's initial trajectory. The
    agent slots are read through `order`/`valid` (`neighbor_slots`) from
    the fleet, or from `neighbors` (a NeighborData gathered
    elsewhere, one scenario). CUDA tensors go to the kernel (one launch),
    CPU tensors to the plain body; `plain` forces the plain body."""
    global front_plain_on_cuda
    dev = inp.pos.device
    if dev.type == "cuda" and not plain:
        return Front(**step_cuda.step_front_cuda(cfg, stage_scalars(cfg), fleet, inp, order,
                                                 valid, neighbors, scenarios))
    if dev.type == "cuda":
        front_plain_on_cuda += 1
    elif dev.type != "cpu":
        raise ValueError(f"no prediction stage for device {dev}")
    nd = neighbors if neighbors is not None else gather_neighbors(fleet, inp, order, valid)
    return _front_plain(cfg, fleet, inp, nd, scenarios)


def front_with_neighbors(cfg: StageConfig, fleet, inp, scenarios: int = 1, plain: bool = False):
    """`neighbor_slots` of inp.pos and `step_front` on its slots, in one:
    (order [S·A, OA], valid [S·A, OA], Front). CUDA tensors go to the
    kernel (one launch: each block selects its agent's slots, then
    predicts from them), CPU tensors to the plain bodies; `plain` forces
    the plain bodies."""
    global fused_plain_on_cuda
    dev = inp.pos.device
    if dev.type == "cuda" and not plain:
        out = step_cuda.front_with_neighbors_cuda(cfg, stage_scalars(cfg), fleet, inp, scenarios)
        return out.pop("order"), out.pop("valid"), Front(**out)
    if dev.type == "cuda":
        fused_plain_on_cuda += 1
    elif dev.type != "cpu":
        raise ValueError(f"no prediction stage for device {dev}")
    order, valid = _neighbor_slots_plain(inp.pos, scenarios, cfg.OA, cfg.comm_range)
    return order, valid, _front_plain(cfg, fleet, inp, gather_neighbors(fleet, inp, order, valid),
                                      scenarios)


def _front_plain(cfg: StageConfig, fleet, inp, nd, S: int) -> Front:
    """step_front's plain version (the torch body)."""
    A, O, OA, OD = inp.pos.shape[0], cfg.O, cfg.OA, cfg.OD
    M, n, N, dt = cfg.M, cfg.n, cfg.n + 1, cfg.dt
    f32, dev = torch.float32, inp.pos.device
    agent_pred = predict(cfg, nd.prev_ctrl, nd.has_prev, nd.pos, nd.vel)
    # disturbance reset: the prediction must start at the observed position
    pred_err = geometry._norm(agent_pred[..., 0, 0, :] - nd.pos)
    hold = trajectory.const_vel_ctrl(nd.pos, torch.zeros_like(nd.vel), M, n, dt)
    obs_pred = torch.where((pred_err > cfg.reset_threshold)[..., None, None, None], hold,
                           agent_pred)
    obs_valid = nd.valid
    obs_is_agent = torch.ones((A, OA), dtype=torch.bool, device=dev)
    obs_radius, obs_downwash = nd.radius, nd.downwash
    obs_max_acc = torch.zeros((A, OA), dtype=f32, device=dev)
    obs_pos_now, obs_goal = nd.pos, nd.goal
    if OD > 0:
        # dynamic obstacles: constant velocity, seen by every agent of
        # their scenario
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
                [x, torch.full((A, pad) + x.shape[2:], fill, dtype=x.dtype, device=dev)],
                dim=1)

        obs_pred = padcat(obs_pred)
        obs_valid = padcat(obs_valid, False)
        obs_is_agent = padcat(obs_is_agent, False)
        obs_radius = padcat(obs_radius, 0.1)
        obs_downwash = padcat(obs_downwash, 1.0)
        obs_max_acc = padcat(obs_max_acc)
        obs_pos_now = padcat(obs_pos_now)
        obs_goal = padcat(obs_goal)

    # size prediction: constant-acceleration uncertainty growth and the
    # velocity guard, for dynamic obstacles (every slot in RSFC)
    obs_pred_sizes = None
    if cfg.sizes:
        size_base = obs_radius[..., None, None].expand(A, O, M, N)
        obs_pred_sizes = size_base
        if cfg.size_growth:
            if cfg.velocity_guard is not None:
                vel_guard = (cfg.velocity_guard * geometry._dotn(inp.vel, inp.vel)
                             / fleet.max_acc[:, 0])
            else:
                vel_guard = torch.zeros((A,), dtype=f32, device=dev)
            grown = (size_base + vel_guard[:, None, None, None]
                     + obs_max_acc[..., None, None] * cfg.growth[None, None])
            use_growth = ~obs_is_agent | (cfg.mode == MODE_RSFC)
            obs_pred_sizes = torch.where(use_growth[..., None, None], grown, size_base)

    initial_ctrl = predict(cfg, inp.prev_ctrl, inp.has_prev, inp.pos, inp.vel)
    hold_self = trajectory.const_vel_ctrl(inp.pos, torch.zeros_like(inp.vel), M, n, dt)
    initial_ctrl = torch.where(inp.is_disturbed[..., None, None, None], hold_self, initial_ctrl)
    return Front(obs_pred=obs_pred, obs_valid=obs_valid, obs_is_agent=obs_is_agent,
                 obs_radius=obs_radius, obs_downwash=obs_downwash, obs_max_acc=obs_max_acc,
                 obs_pos_now=obs_pos_now, obs_goal=obs_goal, initial_ctrl=initial_ctrl,
                 obs_pred_sizes=obs_pred_sizes)


# ----------------------------------------------------------------------
# stage 5 and the QP-input assembly of stage 6
# ----------------------------------------------------------------------


@dataclasses.dataclass
class GoalQP:
    """The goal and the QP's per-agent inputs that the step assembles
    (qp.QPInputs' terminal_mask, lsc_rhs, lsc_active, lb, ub,
    comm_halfrange and y0)."""

    new_goal: torch.Tensor  # [A, 3]
    terminal_mask: torch.Tensor  # [A, M]
    lsc_rhs: torch.Tensor  # [A, O, M, N]
    lsc_active: torch.Tensor  # [A, O, M, N] bool
    lb: torch.Tensor  # [A, dim, M, N]
    ub: torch.Tensor  # [A, dim, M, N]
    comm_halfrange: torch.Tensor  # [A]
    y0: Optional[torch.Tensor]  # [A, R] (None: a cold start)


def goal_qp_inputs(cfg: StageConfig, fleet, inp, normals, anchors, margins, obs_valid,
                   sfc_lo_w, sfc_hi_w, planner_seq: int, plain: bool = False) -> GoalQP:
    """Stage 5 (the goal of cfg.goal's mode, the disturbed agents' hold)
    and the assembly of the QP's inputs from the corridor (normals [A, O,
    M, 3], anchors [A, O, M, N, 3], margins [A, O, M, N]), the slots'
    validity and the SFC's world boxes [A, M, 3] (read with cfg.use_sfc).
    CUDA tensors go to the kernel (one launch), CPU tensors to the plain
    body; `plain` forces the plain body."""
    global goal_plain_on_cuda
    dev = inp.pos.device
    if dev.type == "cuda" and not plain:
        return GoalQP(**step_cuda.goal_qp_inputs_cuda(
            cfg, stage_scalars(cfg), fleet, inp, normals, anchors, margins, obs_valid,
            sfc_lo_w, sfc_hi_w, planner_seq))
    if dev.type == "cuda":
        goal_plain_on_cuda += 1
    elif dev.type != "cpu":
        raise ValueError(f"no goal stage for device {dev}")
    return _goal_qp_plain(cfg, fleet, inp, normals, anchors, margins, obs_valid, sfc_lo_w,
                          sfc_hi_w, planner_seq)


def _goal_qp_plain(cfg: StageConfig, fleet, inp, normals, anchors, margins, obs_valid,
                   sfc_lo_w, sfc_hi_w, planner_seq: int) -> GoalQP:
    """goal_qp_inputs' plain version (the torch body)."""
    A, O, M, N, dim, phi = inp.pos.shape[0], cfg.O, cfg.M, cfg.n + 1, cfg.dim, cfg.phi
    f32, dev = torch.float32, inp.pos.device
    sc = stage_scalars(cfg)
    # ---- stage 5: goal planning
    if cfg.goal == GOAL_LP:
        new_goal, _ = goalmod.goal_lp(
            inp.current_goal, inp.next_waypoint, normals[:, :, M - 1, :],
            anchors[:, :, M - 1, N - 1, :], margins[:, :, M - 1, N - 1], obs_valid,
            sfc_lo_w[:, M - 1] if cfg.use_sfc else None,
            sfc_hi_w[:, M - 1] if cfg.use_sfc else None, dim, use_sfc=cfg.use_sfc)
    elif cfg.goal == GOAL_RIGHT_HAND:
        dl = goalmod.is_deadlock(planner_seq, inp.vel, inp.pos, inp.desired_goal,
                                 cfg.deadlock_velocity, cfg.deadlock_seq)
        new_goal = goalmod.right_hand_goal(inp.pos, inp.desired_goal, dl)
    elif cfg.goal == GOAL_HOST:  # the host computes these goals (planner/priority.py)
        new_goal = inp.current_goal
    else:  # STATIC
        new_goal = inp.desired_goal
    # disturbed agents hold position as goal
    new_goal = torch.where(inp.is_disturbed[..., None], inp.pos, new_goal)

    # ---- stage 6: the QP's inputs
    # terminal segments from the nominal-velocity flight-time heuristic
    ift = geometry._norm(new_goal - inp.pos) / fleet.nominal_velocity
    tseg = torch.clamp(torch.floor((sc["Mdt"] - ift + sc["tiny"]) / cfg.dt_t).to(torch.int32),
                       min=1)
    seg_idx = torch.arange(M, device=dev)[None, :]
    terminal_mask = (seg_idx >= (M - tseg[:, None])).to(f32)
    # LSC rows, with a tiny margin inflation: solutions within the ADMM
    # feasibility tolerance still certify true separation. In sub-step
    # mode it is sized above the loosened gate (feas_tol), and covers the
    # shift of the pairwise point correspondence inside the first segment.
    rhs = ((geometry._dotn(normals[..., None, :dim], anchors[..., :dim]) + margins)
           + sc["qp_margin"])
    live = geometry._norm(normals) > 1e-6
    active = (obs_valid[..., None, None] & live[..., None]).expand(A, O, M, N).clone()
    active[:, :, 0, :phi] = False
    # variable bounds: the world (∩ SFC with the map), plus the waypoint
    # comm box on the segment ends
    lb = cfg.world_lo[None, :dim, None, None].expand(A, dim, M, N)
    ub = cfg.world_hi[None, :dim, None, None].expand(A, dim, M, N)
    if cfg.use_sfc:
        lb = torch.maximum(lb, sfc_lo_w[..., :dim].transpose(1, 2)[..., None])
        ub = torch.minimum(ub, sfc_hi_w[..., :dim].transpose(1, 2)[..., None])
    lb, ub = lb.clone(), ub.clone()
    if cfg.comm_range > 0:
        wp = inp.next_waypoint[..., :dim]
        lb[..., N - 1] = torch.maximum(lb[..., N - 1], (wp - sc["comm_box"])[:, :, None])
        ub[..., N - 1] = torch.minimum(ub[..., N - 1], (wp + sc["comm_box"])[:, :, None])
        comm_half = sc["comm_half"] - fleet.radius
    else:
        comm_half = torch.full((A,), 1e19, dtype=f32, device=dev)
    y0 = None
    if inp.qp_y0 is not None and cfg.warm_duals:
        # duals carry over only when the problem is a shifted
        # continuation of last step's (fresh or disturbed agents cold-start)
        y0 = inp.qp_y0 * (inp.has_prev & ~inp.is_disturbed)[:, None].to(f32)
    return GoalQP(new_goal=new_goal, terminal_mask=terminal_mask, lsc_rhs=rhs,
                  lsc_active=active, lb=lb, ub=ub, comm_halfrange=comm_half, y0=y0)
