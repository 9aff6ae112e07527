"""The port's fused fleet step against the JAX pipeline on the bench
workload, teacher-forced: at every step both packages plan from the
state that the JAX evolving step produced. Then a free-running port-only
run checks the planner's own guarantees."""

import numpy as np
import pytest
import torch

import bench
from lsc_dr_planner_tpu_torch import convert, workload

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

STEPS = 5


def _fields(obj):
    return obj._asdict() if hasattr(obj, "_asdict") else vars(obj)


@pytest.mark.parametrize("A", [16, 32])
def test_teacher_forced_steps_match_jax(A):
    pj, plan_j, fleet_j, inp_j = bench.build_fleet(A)
    step_j = bench.make_evolve_step(pj, plan_j, fleet_j)
    _, plan_t, fleet_t, inp_t = workload.build_fleet(A, device="cpu")
    # same RNG calls in the same order: same world, fleet and start state
    world = convert.grid_world_from_numpy(_fields(plan_j.world), "cpu")
    assert torch.equal(world.blocked_cumsum, plan_t.world.blocked_cumsum)
    assert plan_t.sfc_expand_cells == plan_j.sfc_expand_cells
    fleet = convert.fleet_from_numpy(_fields(fleet_j), "cpu")
    for name in ("radius", "max_vel", "max_acc", "nominal_velocity"):
        assert torch.equal(getattr(fleet, name), getattr(fleet_t, name))
    np.testing.assert_array_equal(inp_t.pos.numpy(), np.asarray(inp_j.pos))
    np.testing.assert_array_equal(inp_t.desired_goal.numpy(),
                                  np.asarray(inp_j.desired_goal))

    for s in range(STEPS + 1):
        out_j = plan_j.step(fleet_j, inp_j)
        out_t = convert.outputs_to_numpy(
            plan_t.step(fleet, convert.inputs_from_numpy(_fields(inp_j), "cpu")))
        # integer corridor boxes from identical float inputs: bit-exact
        np.testing.assert_array_equal(out_t["sfc_lo"], np.asarray(out_j.sfc_lo))
        np.testing.assert_array_equal(out_t["sfc_hi"], np.asarray(out_j.sfc_hi))
        conv_j = np.asarray(out_j.qp_converged)
        np.testing.assert_array_equal(out_t["qp_converged"], conv_j, err_msg=f"step {s}")
        # the goal LP is closed-form: only float rounding separates them
        np.testing.assert_allclose(out_t["current_goal"], np.asarray(out_j.current_goal),
                                   rtol=0, atol=1e-4)
        # ADMM iterates stop at slightly different ε-optimal points
        dctrl = np.abs(out_t["desired_ctrl"] - np.asarray(out_j.desired_ctrl))[conv_j]
        assert dctrl.max(initial=0.0) < 0.1, (s, dctrl.max())
        inp_j, _ = step_j(inp_j)


def test_free_running_port():
    A = 24
    p, planner, fleet, inp = workload.build_fleet(A, device="cpu")
    step = workload.make_evolve_step(p, planner, fleet)
    start = inp.pos.clone()
    conv = []
    min_dist = np.inf
    for _ in range(10):
        inp, c = step(inp)
        conv.append(c.float().mean().item())
        pos = inp.pos[:, :2]
        d = torch.cdist(pos, pos) + torch.eye(A) * 1e9
        min_dist = min(min_dist, d.min().item())
        assert torch.isfinite(inp.prev_ctrl).all()
    assert np.mean(conv) > 0.9, conv
    # LSC separation certified to the QP feasibility tolerance
    assert min_dist >= 2 * 0.15 - planner.feas_tol, min_dist
    # the fleet makes progress toward its goals
    before = torch.linalg.vector_norm(start - inp.desired_goal, dim=-1)
    after = torch.linalg.vector_norm(inp.pos - inp.desired_goal, dim=-1)
    assert (after < before).float().mean() > 0.9
