"""Planner configuration.

Typed equivalent of the reference's ROS-param struct (reference:
include/param.hpp:10-109, src/param.cpp:5-173) plus the planner-mode
consistency rules the reference applies at runtime
(src/param.cpp:127-170, src/traj_planner.cpp:141-222).

Defaults follow launch/simulation.launch (the benchmark configuration)
where it sets a value, falling back to param.cpp defaults otherwise.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class PlannerMode(enum.IntEnum):
    DLSC = 0
    LSC = 1
    BVC = 2
    ORCA = 3
    RECIPROCAL_RSFC = 4
    CIRCLE_TEST = 5


class PredictionMode(enum.IntEnum):
    POSITION = 0
    VELOCITY = 1
    ORCA = 2
    PREVIOUS_SOLUTION = 3


class InitialTrajMode(enum.IntEnum):
    POSITION = 0
    VELOCITY = 1
    ORCA = 2
    PREVIOUS_SOLUTION = 3
    SKIP = 4


class SlackMode(enum.IntEnum):
    NONE = 0
    CONTINUITY = 1
    COLLISION_CONSTRAINT = 2


class GoalMode(enum.IntEnum):
    STATIC = 0
    ORCA = 1
    RIGHT_HAND = 2
    PRIOR_BASED = 3
    DYNAMIC_PRIORITY = 4
    ENTROPY = 5
    GRID_BASED_PLANNER = 6


class MAPFMode(enum.IntEnum):
    PIBT = 0
    ECBS = 1


_PLANNER_MODE_STRS = {
    PlannerMode.DLSC: "DLSC",
    PlannerMode.LSC: "LSC",
    PlannerMode.BVC: "BVC",
    PlannerMode.ORCA: "ORCA",
    PlannerMode.RECIPROCAL_RSFC: "ReciprocalRSFC",
    PlannerMode.CIRCLE_TEST: "CircleTest",
}

_GOAL_MODE_STRS = {
    GoalMode.STATIC: "static",
    GoalMode.ORCA: "orca",
    GoalMode.RIGHT_HAND: "right_hand",
    GoalMode.PRIOR_BASED: "prior_based",
    GoalMode.DYNAMIC_PRIORITY: "dynamic_priority",
    GoalMode.ENTROPY: "entropy",
    GoalMode.GRID_BASED_PLANNER: "grid_based_planner",
}


@dataclasses.dataclass
class Param:
    # Logging
    log_solver: bool = False
    log_vis: bool = True
    package_path: str = "."

    # World
    world_frame_id: str = "world"
    world_dimension: int = 2
    world_use_octomap: bool = True
    world_resolution: float = 0.1
    world_z_2d: float = 0.6
    world_use_global_map: bool = True
    world_max_dist: float = 1.0

    # Multisim
    multisim_patrol: bool = False
    multisim_time_step: float = 0.2
    multisim_planning_rate: int = -1
    multisim_max_noise: float = 0.0
    # dynamic-obstacle observation noise (std dev, meters) applied to the
    # obstacle positions the PLANNER observes; the safety audit uses true
    # positions (reference hook: obstacle_generator.hpp:95-108)
    multisim_observer_stddev: float = 0.0
    multisim_max_planner_iteration: int = 600
    multisim_save_result: bool = False
    multisim_save_mission: bool = False
    multisim_save_time_step: float = 0.1

    # Planner modes
    planner_mode: PlannerMode = PlannerMode.LSC
    prediction_mode: PredictionMode = PredictionMode.PREVIOUS_SOLUTION
    initial_traj_mode: InitialTrajMode = InitialTrajMode.PREVIOUS_SOLUTION
    slack_mode: SlackMode = SlackMode.NONE
    goal_mode: GoalMode = GoalMode.GRID_BASED_PLANNER
    mapf_mode: MAPFMode = MAPFMode.PIBT
    # Committed-plan layer (TPU redesign, sim/simulator.py): solve the
    # joint plan with bounded ECBS first — conflict-optimal paths execute
    # cleanly under order-preserving MCP, where PIBT's
    # priority-inheritance dithering (agents shuttled back and forth)
    # would be walked verbatim. Falls back to `mapf_mode`'s solver when
    # ECBS fails/exceeds budget or the group is larger than the cap.
    mapf_commit_ecbs: bool = True
    mapf_ecbs_max_agents: int = 16
    # Waypoint-layer execution mode (sim/simulator.py):
    #   "auto"    — choose per map at init: corridor-dominated grids
    #               (1-cell-wide passages, e.g. the 0.5 m dense mazes)
    #               run committed-MCP from the start — wedges never
    #               form; open grids run the hybrid flow layer.
    #   "hybrid"  — per-step re-solve (reference semantics, fast flow on
    #               open maps) with automatic committed-MCP escalation
    #               for no-progress knots (deadlock-free);
    #   "mcp"     — committed-MCP for every group from the start;
    #   "perstep" — per-step only (reference parity; can deadlock in
    #               dense corridor crossings — diagnostic use).
    mapf_layer: str = "auto"
    # Native-ECBS budgets for the committed-plan solves. The node cap is
    # the deterministic limiter (~0.02-0.5 ms per HL node on the coarse
    # grids); the wall-clock limit is only a backstop far above any
    # observed solve so host load cannot flip the PIBT fallback.
    # Default 100: bounds the worst committed-plan solve to ~90-190 ms
    # (measured across the 90-mission suite, commit 17c25c3) so the MAPF
    # layer respects the 0.2 s replanning budget; flight times match the
    # unbounded setting. NOTE (breaking default change in r4, was 5000):
    # outside the measured suite a 100-node budget can fall back to
    # PIBT where the old default found bounded-suboptimal ECBS plans —
    # a deliberate latency-over-quality trade for the real-time budget.
    # Raise to ≥5000 for offline/quality-first runs.
    mapf_hl_nodes: int = 100
    mapf_time_limit_s: float = 60.0

    # Obstacle prediction
    obs_size_prediction: bool = True
    obs_uncertainty_horizon: float = 1.0
    obs_agent_clustering: bool = False
    use_velocity_guard: bool = True
    velocity_guard_ratio: float = 0.75

    # Trajectory representation
    dt: float = 0.2
    M: int = 10
    n: int = 5
    phi: int = 3
    phi_n: int = 1

    # Trajectory optimization
    control_input_weight: float = 0.01
    terminal_weight: float = 1.0
    slack_collision_weight: float = 1.0
    slack_dynamic_weight: float = 1.0

    # QP solver (TPU ADMM; replaces the reference's CPLEX settings)
    qp_max_iter: int = 200
    qp_rho: float = 0.1
    qp_rho_eq: float = 1000.0
    qp_sigma: float = 1e-6
    qp_alpha: float = 1.6
    qp_eps_abs: float = 1e-4
    qp_polish: bool = True
    # Masked-compaction rescue budget for ADMM stragglers (extra
    # iterations on a compacted batch of the worst agents; 0 disables).
    # PERF_NOTES_r3 §2: stragglers converge by ~1000 iterations.
    # Monte-Carlo scenario batching keeps this enabled safely: the
    # scenario step flattens S × A into ONE QP batch so a single rescue
    # compaction serves every replica (montecarlo.py; the r4 per-lane
    # rescue OOMed single-chip HBM at S=8 × A=1024).
    qp_rescue_iter: int = 800
    # Dual warm start: carry each agent's ADMM duals across replanning
    # steps (the constraint families keep their row structure step to
    # step, so last step's duals are a near-optimal basin for the next).
    qp_warm_start_duals: bool = True

    # Deadlock
    deadlock_velocity_threshold: float = 0.1
    deadlock_seq_threshold: int = 5

    # Filter (KF; real-experiment path)
    filter_sigma_y_sq: float = 0.0036
    filter_sigma_v_sq: float = 0.01
    filter_sigma_a_sq: float = 1.0

    # ORCA
    orca_horizon: float = 2.0
    orca_inflation_ratio: float = 1.5
    orca_pref_velocity_ratio: float = 1.0

    # Grid-based planner. The reference thresholds occupancy at exactly
    # agent_radius (grid_based_planner.cpp:128-135; the launch file sets
    # grid/margin = 0.0 and the param is dead code there). Here a
    # positive margin keeps MAPF waypoints off near-wall cells — where
    # the goal LP advances slowly — and the MAPF layer automatically
    # falls back to the margin-free grid whenever the margined grid
    # disconnects an agent from its goal (e.g. the 0.5 m dense-maze
    # corridors, which a 0.1 margin would block entirely).
    grid_resolution: float = 0.5
    grid_margin: float = 0.1

    # Goal
    goal_threshold: float = 0.1
    goal_radius: float = 100.0
    priority_agent_distance: float = 0.4
    priority_obs_distance: float = 1.0
    priority_goal_threshold: float = 0.6
    reset_threshold: float = 0.5
    slack_threshold: float = 0.001
    obs_downwash_threshold: float = 3.0
    collision_alert_threshold: float = 1.0
    density_alert_threshold: float = 0.001
    closest_agent_threshold: float = 0.1

    # SFC
    numerical_error_threshold: float = 0.01

    # Communication
    communication_range: float = 3.0

    # Exploration
    sensor_range: float = 3.0

    # Per-stage timing samples (compiled-prefix differences) — each
    # distinct world pays ~6 extra XLA prefix compiles for the first
    # sample; batch benchmark runs disable it (the fused step has no
    # internal timers, so stage times are diagnostic-only)
    profile_stages: bool = True

    # Batching: maximum number of neighbor obstacles an agent considers in
    # one planning step (constraint tensors are padded to this; extra rows
    # are masked out). The reference uses dynamic std::vector sizes; TPU
    # kernels need static shapes.
    max_obstacles: int = 16

    def __post_init__(self):
        self.apply_mode_rules()

    # ------------------------------------------------------------------
    def apply_mode_rules(self) -> None:
        """Planner-mode-implied settings and consistency checks.

        Mirrors src/param.cpp:127-170 (mode-implied prediction / initial
        traj / slack modes) and traj_planner.cpp:141-222 (auto-fixes).
        """
        pm = self.planner_mode
        if pm == PlannerMode.DLSC:
            self.prediction_mode = PredictionMode.PREVIOUS_SOLUTION
            self.initial_traj_mode = InitialTrajMode.PREVIOUS_SOLUTION
            if self.multisim_time_step > self.dt:
                raise ValueError("DLSC requires multisim_time_step <= traj dt")
            self.slack_mode = (
                SlackMode.NONE
                if self.multisim_time_step == self.dt
                else SlackMode.CONTINUITY
            )
        elif pm == PlannerMode.LSC:
            if self.multisim_time_step != self.dt:
                raise ValueError("LSC requires multisim_time_step == traj dt")
            self.prediction_mode = PredictionMode.PREVIOUS_SOLUTION
            self.initial_traj_mode = InitialTrajMode.PREVIOUS_SOLUTION
            self.slack_mode = SlackMode.NONE
        elif pm == PlannerMode.BVC:
            self.prediction_mode = PredictionMode.POSITION
            self.initial_traj_mode = InitialTrajMode.POSITION
            self.slack_mode = SlackMode.NONE
        elif pm == PlannerMode.RECIPROCAL_RSFC:
            self.prediction_mode = PredictionMode.VELOCITY
            self.initial_traj_mode = InitialTrajMode.ORCA
            self.slack_mode = SlackMode.COLLISION_CONSTRAINT
        elif pm == PlannerMode.CIRCLE_TEST:
            self.prediction_mode = PredictionMode.VELOCITY
            self.initial_traj_mode = InitialTrajMode.VELOCITY
            self.slack_mode = SlackMode.NONE

    # ------------------------------------------------------------------
    @property
    def n_ctrl(self) -> int:
        return self.n + 1

    @property
    def n_vars(self) -> int:
        """QP decision variables per agent (control points only)."""
        return self.world_dimension * self.M * (self.n + 1)

    @property
    def horizon(self) -> float:
        return self.M * self.dt

    def planner_mode_str(self) -> str:
        return _PLANNER_MODE_STRS[self.planner_mode]

    def goal_mode_str(self) -> str:
        return _GOAL_MODE_STRS[self.goal_mode]

    def mapf_mode_str(self) -> str:
        return "pibt" if self.mapf_mode == MAPFMode.PIBT else "ecbs"

    def replace(self, **kwargs) -> "Param":
        p = dataclasses.replace(self, **kwargs)
        return p


# Small numerical epsilons (reference: include/sp_const.hpp)
SP_EPSILON = 1e-9
SP_EPSILON_FLOAT = 1e-6
SP_INFINITY = 1e9
