"""Parity of the port's trajectory, geometry, CLSC and goal-LP ops with
the JAX package on the same numpy inputs (CPU, float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu.ops import bernstein as jbern
from lsc_dr_planner_tpu.ops import geometry as jgeo
from lsc_dr_planner_tpu.ops import lsc as jlsc
from lsc_dr_planner_tpu.ops import trajectory as jtraj
from lsc_dr_planner_tpu.planner import goal as jgoal
from lsc_dr_planner_tpu.planner import pipeline as jpipe
from lsc_dr_planner_tpu_torch.ops import bernstein as tbern
from lsc_dr_planner_tpu_torch.ops import geometry as tgeo
from lsc_dr_planner_tpu_torch.ops import lsc as tlsc
from lsc_dr_planner_tpu_torch.ops import trajectory as ttraj
from lsc_dr_planner_tpu_torch.planner import goal as tgoal
from lsc_dr_planner_tpu_torch.planner import pipeline as tpipe
from test_torch_hull_kernel import hull_cases

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

# Both sides compute in float32 with the same formulas; only the order of
# a few 3-term sums and matmuls differs, so 1e-5 absolute covers rounding
# on values of order 1-10.
ATOL = 1e-5
M, n, DT = 10, 5, 0.2


def f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.mark.parametrize("builder", [
    lambda m: m.basis_matrix(5),
    lambda m: m.subsegment_matrix(5, 0.25, 1.0),
    lambda m: m.jerk_cost_matrix(5, 3, 1, 0.2),
    lambda m: m.continuity_matrix(10, 5, 3, 0.2),
    lambda m: m.uncertainty_growth_ctrl(5, 0.2, 1.0, 3),
])
def test_bernstein_builders_copied(builder):
    np.testing.assert_array_equal(builder(tbern), builder(jbern))


def test_uncertainty_growth_table():
    np.testing.assert_array_equal(tpipe._uncertainty_growth_table(n, DT, 1.0, M),
                                  jpipe._uncertainty_growth_table(n, DT, 1.0, M))


def test_const_vel_and_shift():
    rng = np.random.default_rng(0)
    pos, vel = f32(rng, 7, 3), f32(rng, 7, 3)
    cv_t = ttraj.const_vel_ctrl(torch.tensor(pos), torch.tensor(vel), M, n, DT)
    cv_j = jtraj.const_vel_ctrl(jnp.asarray(pos), jnp.asarray(vel), M, n, DT)
    close(cv_t, cv_j)
    ctrl = f32(rng, 4, 3, M, n + 1, 3)
    np.testing.assert_array_equal(
        ttraj.shift_one_segment(torch.tensor(ctrl)).numpy(),
        np.asarray(jtraj.shift_one_segment(jnp.asarray(ctrl))))
    np.testing.assert_array_equal(ttraj.last_point(torch.tensor(ctrl)).numpy(),
                                  np.asarray(jtraj.last_point(jnp.asarray(ctrl))))


@pytest.mark.parametrize("t", [0.0, 0.2, 0.37, 1.9, 2.0])
def test_state_at(t):
    rng = np.random.default_rng(1)
    ctrl = f32(rng, 5, M, n + 1, 3)
    for a, b in zip(ttraj.state_at(torch.tensor(ctrl), t, DT),
                    jtraj.state_at(jnp.asarray(ctrl), t, DT)):
        # derivatives scale by (n/dt)² = 625: relative 1e-6 of the values
        close(a, b, atol=ATOL * max(1.0, float(np.abs(np.asarray(b)).max())))


@pytest.mark.parametrize("case", list(hull_cases()))
def test_closest_point_origin_to_hull(case):
    pts = hull_cases()[case]
    bt, dt_ = tgeo.closest_point_origin_to_hull(torch.tensor(pts))
    bj, dj = jgeo.closest_point_origin_to_hull(jnp.asarray(pts))
    close(dt_, dj)
    close(bt, bj)
    # exact oddness under points → −points (mirrored reciprocal normals)
    bn, dn = tgeo.closest_point_origin_to_hull(torch.tensor(-pts))
    np.testing.assert_array_equal(bn.numpy(), -bt.numpy())
    np.testing.assert_array_equal(dn.numpy(), dt_.numpy())


def test_segment_queries():
    rng = np.random.default_rng(3)
    p1, p2, q1, q2 = (f32(rng, 200, 3) for _ in range(4))
    q2[:20] = q1[:20]  # degenerate second segment
    p2[20:40] = p1[20:40] + (q2[20:40] - q1[20:40])  # parallel segments
    for a, b in zip(
            tgeo.closest_between_segments(*map(torch.tensor, (p1, p2, q1, q2))),
            jgeo.closest_between_segments(*map(jnp.asarray, (p1, p2, q1, q2)))):
        close(a, b)
    close(tgeo.closest_point_on_segment(*map(torch.tensor, (q1, p1, p2))),
          jgeo.closest_point_on_segment(*map(jnp.asarray, (q1, p1, p2))))


def _clsc_inputs(seed, A=4, O=5):
    rng = np.random.default_rng(seed)
    init = f32(rng, A, M, n + 1, 3)
    obs = init[:, None] + 0.8 + f32(rng, A, O, M, n + 1, 3, scale=0.5)
    init[..., 2] = 0.6
    obs[..., 2] = 0.6
    return dict(
        initial_ctrl=init, obs_ctrl=obs, obs_goal=f32(rng, A, O, 3),
        agent_radius=np.full(A, 0.15, np.float32),
        agent_downwash=np.full(A, 2.0, np.float32),
        obs_radius=np.full((A, O), 0.15, np.float32),
        obs_downwash=np.full((A, O), 2.0, np.float32),
        obs_is_agent=np.ones((A, O), bool), current_goal=f32(rng, A, 3),
        obs_mask=rng.uniform(size=(A, O)) < 0.7)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_clsc(dim, seed):
    kw = _clsc_inputs(seed)
    st = tlsc.build_clsc(**{k: torch.tensor(v) for k, v in kw.items()},
                         world_dimension=dim)
    sj = jlsc.build_clsc(**{k: jnp.asarray(v) for k, v in kw.items()},
                         world_dimension=dim)
    # invalid neighbour slots carry arbitrary content that the QP masks out
    valid = kw["obs_mask"]
    close(st.normals[torch.tensor(valid)], np.asarray(sj.normals)[valid])
    close(st.anchors[torch.tensor(valid)], np.asarray(sj.anchors)[valid])
    close(st.margins[torch.tensor(valid)], np.asarray(sj.margins)[valid])
    assert not st.normals[~torch.tensor(valid)].any()


@pytest.mark.parametrize("use_sfc", [True, False])
def test_goal_lp(use_sfc):
    rng = np.random.default_rng(4)
    A, O = 64, 6
    cur = f32(rng, A, 3)
    wp = cur + f32(rng, A, 3, scale=0.5)
    wp[:8] = cur[:8]  # a ≈ 0 rows
    normals = f32(rng, A, O, 3)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    args = dict(current_goal=cur, next_waypoint=wp, lsc_normals_last=normals,
                lsc_anchor_last=cur[:, None] - 0.5 * normals,
                lsc_margin_last=np.abs(f32(rng, A, O, scale=0.3)),
                lsc_valid=rng.uniform(size=(A, O)) < 0.8,
                sfc_lo_last=np.minimum(cur, wp) - 0.2, sfc_hi_last=np.maximum(cur, wp) + 0.1)
    gt, it = tgoal.goal_lp(**{k: torch.tensor(v) for k, v in args.items()},
                           world_dimension=2, use_sfc=use_sfc)
    gj, ij = jgoal.goal_lp(**{k: jnp.asarray(v) for k, v in args.items()},
                           world_dimension=2, use_sfc=use_sfc)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    close(gt, gj)
