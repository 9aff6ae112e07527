"""The JAX package's small mode missions, flown by the port's simulator
with those tests' own assertions: the Reciprocal-RSFC crossing, the
RIGHT_HAND detour and the GOBACK round trip (tests/test_modes.py), BVC
(tests/test_sim.py), PRIOR_BASED (tests/test_aux.py), and a mini mission
in DYNAMIC_PRIORITY and in DLSC replanning once a segment.

Each function takes the device and a log directory, flies its mission,
raises AssertionError where the test would fail, and returns a summary.
The CPU tests and `chip_smoke.py` (on the card) call the same functions.
"""

from __future__ import annotations

import numpy as np

from lsc_dr_planner_tpu_torch.config import GoalMode, Param, PlannerMode
from lsc_dr_planner_tpu_torch.mission import generate_random_mission
from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator


def mini_mission(n=4, seed=3):
    """tests/test_sim.py's mini mission."""
    return generate_random_mission(n, [-3, -3, 0], [3, 3, 2.5], seed=seed, min_separation=1.2)


def sim_param(**kw):
    """tests/test_sim.py's defaults."""
    return Param(**{**dict(world_use_octomap=False, multisim_max_planner_iteration=150,
                           qp_max_iter=150), **kw})


def modes_param(**kw):
    """tests/test_modes.py's defaults: baseline modes without the comm box."""
    return Param(**{**dict(world_use_octomap=False, multisim_max_planner_iteration=250,
                           qp_max_iter=150, communication_range=-1.0), **kw})


def step(sim, record=True):
    """One planner iteration, as the JAX tests drive it by hand."""
    if sim.planner_seq > 0:
        sim.do_step()
    sim.decentralized_mapp()
    assert sim.plan()
    if record:
        sim.save_simulation_result()


def _pair(n, lo, hi, seed, sep, starts):
    m = generate_random_mission(n, lo, hi, seed=seed, min_separation=sep)
    for a, (st, gl) in zip(m.agents, starts):
        a.start, a.goal = np.array(st), np.array(gl)
    return m


def summary(sim):
    return {"planner_steps": sim.planner_seq, "is_collided": bool(sim.is_collided),
            "safety_ratio_agent": float(sim.safety_ratio_agent),
            "finished": bool(sim.is_finished()),
            "step_p50_ms": sim.step_time.percentile(50) * 1e3 if sim.step_time.N else None}


def rsfc_crossing(device, log_dir):
    m = _pair(2, [-3, -3, 0], [3, 3, 2.5], 1, 2.0,
              [([-2.0, 0.0, 0.6], [2.0, 0.0, 0.6]), ([0.0, -2.0, 0.6], [0.0, 2.0, 0.6])])
    sim = MultiSyncSimulator(modes_param(planner_mode=PlannerMode.RECIPROCAL_RSFC,
                                         goal_mode=GoalMode.STATIC), m,
                             log_dir=str(log_dir), device=device)
    res = sim.run()
    assert not res["is_collided"]
    assert res["safety_ratio_agent"] >= 1.0
    assert np.isfinite(res["total_flight_time"])
    assert res["vel_excess_ratio"] == 0.0
    assert res["acc_excess_ratio"] == 0.0
    return {**summary(sim), "flight_time_s": res["total_flight_time"]}


def right_hand_detour(device, log_dir):
    m = _pair(2, [-4, -4, 0], [4, 4, 2.5], 1, 2.0,
              [([-2.0, 0.0, 0.6], [2.0, 0.0, 0.6]), ([2.0, 0.0, 0.6], [-2.0, 0.0, 0.6])])
    sim = MultiSyncSimulator(modes_param(planner_mode=PlannerMode.LSC,
                                         goal_mode=GoalMode.RIGHT_HAND,
                                         multisim_max_planner_iteration=300), m,
                             log_dir=str(log_dir), device=device)
    detour_fired = False
    for _ in range(300):
        if sim.is_finished():
            break
        step(sim)
        if np.max(np.linalg.norm(sim.current_goal - sim.desired_goal, axis=-1)) > 0.5:
            detour_fired = True
    assert detour_fired, "right-hand detour never triggered"
    assert sim.is_finished(), "head-on pair did not resolve"
    assert not sim.is_collided
    assert sim.safety_ratio_agent >= 1.0
    return summary(sim)


def goback_round_trip(device, log_dir):
    m = generate_random_mission(2, [-3, -3, 0], [3, 3, 2.5], seed=11, min_separation=2.5)
    sim = MultiSyncSimulator(modes_param(communication_range=3.0), m,
                             log_dir=str(log_dir), device=device)
    for _ in range(30):
        step(sim)
    assert np.all(np.linalg.norm(sim.pos - sim.start_point, axis=-1) > 1.0)
    sim.stop_patrol()
    finished = False
    for _ in range(170):
        if sim.is_finished():
            finished = True
            break
        step(sim)
    assert finished, "GOBACK never finished"
    assert np.all(np.linalg.norm(sim.pos - sim.start_point, axis=-1) <= sim.param.goal_threshold)
    assert not sim.is_collided
    return summary(sim)


def bvc_runs(device, log_dir):
    sim = MultiSyncSimulator(sim_param(planner_mode=PlannerMode.BVC, goal_mode=GoalMode.STATIC),
                             mini_mission(n=3, seed=5), log_dir=str(log_dir), device=device)
    for _ in range(10):
        step(sim, record=False)
    assert not sim.is_collided
    return summary(sim)


def prior_based(device, log_dir):
    m = generate_random_mission(3, [-3, -3, 0], [3, 3, 2.5], seed=2, min_separation=1.5)
    p = Param(world_use_octomap=False, goal_mode=GoalMode.PRIOR_BASED,
              multisim_max_planner_iteration=40, qp_max_iter=120)
    sim = MultiSyncSimulator(p, m, log_dir=str(log_dir), device=device)
    res = sim.run()
    assert not res["is_collided"]
    assert res["safety_ratio_agent"] >= 1.0
    assert sim.prior_goal_time.N == sim.planner_seq
    return {**summary(sim), "prior_goal_ms_p50": sim.prior_goal_time.percentile(50) * 1e3,
            "prior_goal_ms_max": sim.prior_goal_time.max * 1e3}


# DYNAMIC_PRIORITY (host goals pass through: the fleet holds its starts, as
# in the JAX package) and DLSC replanning once a segment
OTHER_MODES = {
    "dynamic_priority": dict(goal_mode=GoalMode.DYNAMIC_PRIORITY, communication_range=-1.0),
    "dlsc_at_dt": dict(planner_mode=PlannerMode.DLSC),
}


def other_mode(name, device, log_dir):
    """A mode of OTHER_MODES flies the mini mission with a clean audit."""
    sim = MultiSyncSimulator(sim_param(multisim_max_planner_iteration=40, **OTHER_MODES[name]),
                             mini_mission(), log_dir=str(log_dir), device=device)
    assert not sim.planner.substep
    res = sim.run()
    assert res["planner_seq"] > 10
    assert not res["is_collided"] and res["safety_ratio_agent"] >= 1.0
    assert res["vel_excess_ratio"] == 0.0 and res["acc_excess_ratio"] == 0.0
    return summary(sim)


MISSIONS = {
    "rsfc_crossing": rsfc_crossing,
    "right_hand_detour": right_hand_detour,
    "goback_round_trip": goback_round_trip,
    "bvc": bvc_runs,
    "prior_based": prior_based,
    **{name: (lambda device, log_dir, name=name: other_mode(name, device, log_dir))
       for name in OTHER_MODES},
}
