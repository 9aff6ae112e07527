"""The port's simulator (MultiSyncSimulator on the CPU, plain torch paths)
flies the JAX package's small mode missions with those tests' own
assertions: tests/test_sim.py (octomap-free mini mission, static goals,
BVC, 3-D crossing with downwash, LAND, DLSC sub-step, dynamic obstacles,
observation noise), tests/test_modes.py (Reciprocal-RSFC, RIGHT_HAND,
GOBACK) and tests/test_aux.py (PRIOR_BASED). Then checkpoint-forced
single steps against the JAX simulator in DLSC sub-step mode and in 3-D
with dynamic obstacles."""

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu.config import GoalMode as GoalModeJ
from lsc_dr_planner_tpu.config import Param as ParamJ
from lsc_dr_planner_tpu.config import PlannerMode as PlannerModeJ
from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator as SimJ
from lsc_dr_planner_tpu_torch.config import GoalMode, Param, PlannerMode
from lsc_dr_planner_tpu_torch.mission import ObstacleSpec, generate_random_mission
from lsc_dr_planner_tpu_torch.sim import mode_missions
from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)


def Sim(p, m, tmp_path):
    return MultiSyncSimulator(p, m, log_dir=str(tmp_path), device="cpu")


_mini_mission = mode_missions.mini_mission
_param = mode_missions.sim_param
_step = mode_missions.step


# ---------------------------------------------------------------- test_sim.py

def test_lsc_dr_mini_mission_completes(tmp_path):
    res = Sim(_param(), _mini_mission(), tmp_path).run()
    assert not res["is_collided"]
    assert res["safety_ratio_agent"] >= 1.0
    assert np.isfinite(res["total_flight_time"])
    assert res["vel_excess_ratio"] == 0.0
    assert res["acc_excess_ratio"] == 0.0


def test_lsc_static_goal_two_agents(tmp_path):
    m = generate_random_mission(2, [-3, -3, 0], [3, 3, 2.5], seed=1, min_separation=2.0)
    m.agents[0].start = np.array([-2.0, 0.0, 0.6])
    m.agents[0].goal = np.array([2.0, 0.0, 0.6])
    m.agents[1].start = np.array([2.0, 0.01, 0.6])
    m.agents[1].goal = np.array([-2.0, 0.01, 0.6])
    res = Sim(_param(goal_mode=GoalMode.STATIC), m, tmp_path).run()
    assert not res["is_collided"]
    assert res["safety_ratio_agent"] >= 1.0


def test_bvc_mode_runs(tmp_path):
    mode_missions.bvc_runs("cpu", tmp_path)


def test_3d_vertical_crossing_with_downwash(tmp_path):
    m = generate_random_mission(4, [-3, -3, 0], [3, 3, 3.0], seed=9, min_separation=1.5, z=1.5)
    m.agents[0].start = np.array([0.0, 0.0, 0.5])
    m.agents[0].goal = np.array([0.0, 0.0, 2.5])
    m.agents[1].start = np.array([0.5, 0.0, 2.5])
    m.agents[1].goal = np.array([0.5, 0.0, 0.5])
    sim = Sim(_param(world_dimension=3, multisim_max_planner_iteration=250), m, tmp_path)
    assert sim.planner.qp_cfg.dim == 3
    res = sim.run()
    assert not res["is_collided"]
    assert res["safety_ratio_agent"] >= 1.0
    assert np.isfinite(res["total_flight_time"])


def test_land_service(tmp_path):
    m = generate_random_mission(3, [-3, -3, 0], [3, 3, 3.0], seed=7, min_separation=1.5, z=1.5)
    sim = Sim(_param(world_dimension=3, multisim_max_planner_iteration=80), m, tmp_path)
    for _ in range(6):
        _step(sim)
    z_before = sim.pos[:, 2].copy()
    audit_rows = len(sim.traj_history)
    sim.land()
    for _ in range(30):
        assert not sim.is_finished()
        _step(sim, record=False)
    assert len(sim.traj_history) == audit_rows
    assert np.all(sim.pos[:, 2] < z_before)
    assert np.all(sim.pos[:, 2] >= 0.0)


def test_dlsc_substep_replanning(tmp_path):
    p = _param(planner_mode=PlannerMode.DLSC, multisim_time_step=0.1, dt=0.2,
               multisim_max_planner_iteration=200)
    sim = Sim(p, _mini_mission(), tmp_path)
    assert sim.planner.substep and sim.planner.feas_tol == 8e-3
    res = sim.run()
    assert not res["is_collided"]
    assert res["safety_ratio_agent"] >= 1.0
    assert np.isfinite(res["total_flight_time"])


def _spin_and_straight():
    return [
        ObstacleSpec(type="spin", radius=0.2, max_acc=1.0, downwash=1.0,
                     axis_position=np.array([0.0, 0.0, 0.6]),
                     axis_ori=np.array([0.0, 0.0, 1.0]),
                     start=np.array([0.8, 0.0, 0.6]), speed=0.4),
        ObstacleSpec(type="straight", radius=0.15, max_acc=1.0, downwash=1.0,
                     start=np.array([-2.0, 1.5, 0.6]), goal=np.array([2.0, 1.5, 0.6]),
                     speed=0.3),
    ]


def test_dynamic_obstacles_end_to_end(tmp_path):
    m = generate_random_mission(2, [-3, -3, 0], [3, 3, 2.5], seed=21, min_separation=2.0)
    m.obstacles.extend(_spin_and_straight())
    sim = Sim(_param(multisim_max_planner_iteration=120), m, tmp_path)
    assert sim.planner.O == 1 + 2
    res = sim.run()
    assert not res["is_collided"]
    assert res["safety_ratio_agent"] >= 1.0
    assert np.isfinite(res["safety_ratio_obs"])
    assert res["safety_ratio_obs"] >= 1.0
    assert np.isfinite(res["total_flight_time"])


def test_obstacle_observation_noise_wiring(tmp_path):
    m = generate_random_mission(2, [-3, -3, 0], [3, 3, 2.5], seed=23, min_separation=2.0)
    m.obstacles.append(ObstacleSpec(
        type="straight", radius=0.2, max_acc=1.0, downwash=1.0,
        start=np.array([-2.0, 0.5, 0.6]), goal=np.array([2.0, 0.5, 0.6]), speed=0.3))
    sim = Sim(_param(multisim_max_planner_iteration=100, multisim_observer_stddev=0.03),
              m, tmp_path)
    inp = sim._build_step_inputs()
    true_state = sim.obstacle_generator.states_at(0.0)[0]
    observed = np.asarray(inp.dynobs_pos[0])
    assert np.linalg.norm(observed - true_state.position) > 1e-6
    res = sim.run()
    assert not res["is_collided"]
    assert res["safety_ratio_obs"] >= 1.0


def test_checkpoint_resume_with_noisy_obstacles(tmp_path):
    """A run with observed-with-noise dynamic obstacles, resumed from its
    checkpoint, continues exactly like the uninterrupted run: the
    checkpoint carries the observation noise generator."""
    m = generate_random_mission(2, [-3, -3, 0], [3, 3, 2.5], seed=21, min_separation=2.0)
    m.obstacles.extend(_spin_and_straight())
    p = _param(multisim_observer_stddev=0.03, multisim_save_result=False)
    ref = Sim(p, m, tmp_path)
    for _ in range(10):
        _step(ref)
    half = Sim(p, m, tmp_path)
    for _ in range(5):
        _step(half)
    ck = str(tmp_path / "ck.npz")
    half.save_checkpoint(ck)
    res = Sim(p, m, tmp_path)
    res.load_checkpoint(ck)
    for _ in range(5):
        _step(res)
    for k in ("pos", "prev_ctrl", "current_goal", "qp_y"):
        np.testing.assert_array_equal(getattr(res, k), getattr(ref, k))
    assert res.safety_ratio_obs == ref.safety_ratio_obs


# -------------------------------------------------------------- test_modes.py

def test_reciprocal_rsfc_crossing(tmp_path):
    mode_missions.rsfc_crossing("cpu", tmp_path)


def test_right_hand_deadlock_detour(tmp_path):
    mode_missions.right_hand_detour("cpu", tmp_path)


def test_goback_round_trip(tmp_path):
    mode_missions.goback_round_trip("cpu", tmp_path)


# ---------------------------------------------------------------- test_aux.py

def test_prior_based_mode_runs(tmp_path):
    mode_missions.prior_based("cpu", tmp_path)


@pytest.mark.parametrize("name", list(mode_missions.OTHER_MODES))
def test_other_modes_fly(tmp_path, name):
    """DYNAMIC_PRIORITY (host goals pass through: the fleet holds its
    starts, as in the JAX package) and DLSC replanning once a segment
    fly a mini mission with a clean audit."""
    mode_missions.other_mode(name, "cpu", tmp_path)


# ------------------------------------------ checkpoint-forced steps against JAX

def _to_jax(kw):
    return {k: (PlannerModeJ[v.name] if isinstance(v, PlannerMode)
                else GoalModeJ[v.name] if isinstance(v, GoalMode) else v)
            for k, v in kw.items()}


FORCED = {
    "dlsc_substep": (dict(planner_mode=PlannerMode.DLSC, multisim_time_step=0.1,
                          world_use_octomap=True, multisim_save_result=False), False),
    "3d_dynobs": (dict(world_dimension=3, world_use_octomap=False,
                       multisim_save_result=False), True),
}


@pytest.mark.parametrize("name", list(FORCED))
def test_checkpoint_forced_steps_match_jax(tmp_path, name):
    """A JAX run checkpointed after each of its first 4 steps; from every
    checkpoint one step of a fresh JAX replica and one of the port: host
    state identical, corridors and convergence identical, goals within
    1e-4, control points within 0.1 m (tests/test_torch_sim.py)."""
    kw, dyn = FORCED[name]
    if name == "3d_dynobs":
        m = generate_random_mission(4, [-3, -3, 0], [3, 3, 3.0], seed=9,
                                    min_separation=1.5, z=1.5)
    else:
        m = _mini_mission()
        m.world_boxes = np.array([[0.0, 1.2, 1.25, 0.5, 0.5, 2.5]])
        m.world_file_name = "mini.csv"
    if dyn:
        m.obstacles.extend(_spin_and_straight())
    base_j = SimJ(ParamJ(**_to_jax(kw)), m, log_dir=str(tmp_path))
    base_t = Sim(Param(**kw), m, tmp_path)
    assert base_t.planner.O == base_j.planner.O
    _step(base_j, record=False)
    for k in range(4):
        ck = str(tmp_path / f"ck{k}.npz")
        base_j.save_checkpoint(ck)
        sj = SimJ(base_j.param, m, log_dir=str(tmp_path), share_static_from=base_j)
        st = MultiSyncSimulator(base_t.param, m, log_dir=str(tmp_path),
                                share_static_from=base_t)
        sj.load_checkpoint(ck)
        st.load_checkpoint(ck)
        _step(sj, record=False)
        _step(st, record=False)
        np.testing.assert_array_equal(st.pos, sj.pos)
        np.testing.assert_array_equal(st.next_waypoint, sj.next_waypoint)
        np.testing.assert_array_equal(st.sfc_lo, sj.sfc_lo)
        np.testing.assert_array_equal(st.sfc_hi, sj.sfc_hi)
        np.testing.assert_array_equal(st.qp_converged, sj.qp_converged)
        np.testing.assert_allclose(st.current_goal, sj.current_goal, rtol=0, atol=1e-4)
        conv = sj.qp_converged
        assert conv.all()
        assert np.abs(st.desired_ctrl - sj.desired_ctrl)[conv].max() < 0.1
        _step(base_j, record=False)
