"""The port's fused fleet step against the JAX pipeline in every planner
mode, goal mode and world option it runs, on the bench layout
(`workload.fleet_layout`), teacher-forced: at every step both packages
plan from the same state, which then advances along the JAX plan.
Tolerances as in tests/test_torch_pipeline.py."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu.config import GoalMode as GoalModeJ
from lsc_dr_planner_tpu.config import Param as ParamJ
from lsc_dr_planner_tpu.config import PlannerMode as PlannerModeJ
from lsc_dr_planner_tpu.planner import pipeline as jpipe
from lsc_dr_planner_tpu.world.grid import build_grid_world as jbuild
from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.config import GoalMode, PlannerMode

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

A, STEPS, OD = 16, 4, 2
BASELINE = dict(communication_range=-1.0)  # non-DR goal modes fly without the comm box
CONFIGS = {
    "lsc_static": dict(goal_mode=GoalMode.STATIC, **BASELINE),
    "lsc_right_hand": dict(goal_mode=GoalMode.RIGHT_HAND, **BASELINE),
    "lsc_prior_based": dict(goal_mode=GoalMode.PRIOR_BASED, **BASELINE),
    "dlsc_substep": dict(planner_mode=PlannerMode.DLSC, multisim_time_step=0.1),
    "dlsc_dt": dict(planner_mode=PlannerMode.DLSC),
    "bvc": dict(planner_mode=PlannerMode.BVC, goal_mode=GoalMode.STATIC, **BASELINE),
    "rsfc": dict(planner_mode=PlannerMode.RECIPROCAL_RSFC, goal_mode=GoalMode.STATIC,
                 **BASELINE),
    "no_octomap": dict(world_use_octomap=False),
    "3d": dict(world_dimension=3),
    "dynobs": dict(goal_mode=GoalMode.STATIC, **BASELINE),
}


def _jax_param(overrides):
    kw = {}
    for k, v in overrides.items():
        if isinstance(v, PlannerMode):
            v = PlannerModeJ[v.name]
        elif isinstance(v, GoalMode):
            v = GoalModeJ[v.name]
        kw[k] = v
    return ParamJ(**{**dict(goal_mode=GoalModeJ.GRID_BASED_PLANNER, world_use_octomap=True,
                            world_dimension=2, communication_range=3.0,
                            max_obstacles=16), **kw})


def _dynobs(k, od):
    """od obstacles flying at the fleet from either side at constant
    velocity, at step k."""
    pos = np.array([[-3.2, 0.3, 0.6], [3.2, -0.9, 0.6]])[:od]
    vel = np.array([[0.4, 0.0, 0.0], [-0.4, 0.1, 0.0]])[:od]
    return dict(dynobs_pos=(pos + vel * 0.2 * k).astype(np.float32),
                dynobs_vel=vel.astype(np.float32),
                dynobs_radius=np.full(od, 0.2, np.float32),
                dynobs_downwash=np.full(od, 1.0, np.float32),
                dynobs_max_acc=np.full(od, 1.0, np.float32),
                dynobs_valid=np.ones(od, bool))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_modes_teacher_forced_match_jax(name):
    ov = CONFIGS[name]
    od = OD if name == "dynobs" else 0
    p, plan_t, fleet_t, inp_t = workload.build_fleet(A, device="cpu", **ov)
    if od:
        plan_t = type(plan_t)(p, plan_t.world, A, max_dynobs=od, agent_radius=0.15,
                              max_vel_hint=1.0)
        inp_t = dataclasses.replace(inp_t, qp_y0=None)
    if p.goal_mode == GoalMode.RIGHT_HAND:  # past the deadlock test's warm-up
        inp_t = dataclasses.replace(inp_t, planner_seq=p.deadlock_seq_threshold + 1)
    _, _, boxes, wmin, wmax = workload.fleet_layout(A)
    pj = _jax_param(ov)
    plan_j = jpipe.FleetPlanner(pj, jbuild(boxes, wmin, wmax, pj.world_resolution, 0.15),
                                A, max_dynobs=od, agent_radius=0.15, max_vel_hint=1.0)
    assert plan_j.qp_cfg.n_obs == plan_t.qp_cfg.n_obs and plan_j.feas_tol == plan_t.feas_tol
    fleet_j = jpipe.FleetArrays(**{f.name: jnp.asarray(getattr(fleet_t, f.name).numpy())
                                   for f in dataclasses.fields(fleet_t)})

    converged = []
    for k in range(STEPS + 1):
        dyn = _dynobs(k, od)
        if od:
            inp_t = dataclasses.replace(inp_t, **{f: torch.as_tensor(v) for f, v in dyn.items()})
        fields = {f.name: getattr(inp_t, f.name) for f in dataclasses.fields(inp_t)}
        jfields = {f: (v if v is None or isinstance(v, int) else jnp.asarray(v.numpy()))
                   for f, v in fields.items()}
        jfields.update({f: jnp.asarray(v) for f, v in dyn.items()})
        inp_j = jpipe.StepInputs(**jfields)
        out_j = plan_j.step(fleet_j, inp_j)
        out_t = plan_t.step(fleet_t, inp_t)
        # integer corridor boxes from identical float inputs: bit-exact
        np.testing.assert_array_equal(out_t.sfc_lo.numpy(), np.asarray(out_j.sfc_lo))
        np.testing.assert_array_equal(out_t.sfc_hi.numpy(), np.asarray(out_j.sfc_hi))
        conv_j = np.asarray(out_j.qp_converged)
        np.testing.assert_array_equal(out_t.qp_converged.numpy(), conv_j, err_msg=f"step {k}")
        np.testing.assert_allclose(out_t.current_goal.numpy(), np.asarray(out_j.current_goal),
                                   rtol=0, atol=1e-4)
        dctrl = np.abs(out_t.desired_ctrl.numpy() - np.asarray(out_j.desired_ctrl))[conv_j]
        assert dctrl.max(initial=0.0) < 0.1, (k, dctrl.max())
        converged.append(conv_j.mean())
        # the next state, along the JAX plan
        jo = types.SimpleNamespace(**{f: torch.as_tensor(np.array(getattr(out_j, f)))
                                      for f in ("desired_ctrl", "current_goal", "sfc_lo",
                                                "sfc_hi", "sfc_initialized", "qp_y")})
        inp_t = workload.advance(p, inp_t, jo)
    assert np.mean(converged) > 0.9, converged
