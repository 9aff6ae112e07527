"""Parity of the port's planner-mode ops with the JAX package on the same
numpy inputs (CPU, float32): the LSC-family constructions other than
CLSC, the DLSC sub-segment shift, the right-hand goal and its deadlock
test, the line-of-sight raycast, the 'point' and 'substep' SFC modes and
the priority-based goal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu.mapf.grid import build_coarse_grid as jcoarse
from lsc_dr_planner_tpu.ops import lsc as jlsc
from lsc_dr_planner_tpu.ops import sfc as jsfc
from lsc_dr_planner_tpu.ops import trajectory as jtraj
from lsc_dr_planner_tpu.planner import goal as jgoal
from lsc_dr_planner_tpu.planner.priority import prior_based_goal as jprior
from lsc_dr_planner_tpu.world.grid import build_grid_world as jbuild
from lsc_dr_planner_tpu_torch.config import Param
from lsc_dr_planner_tpu_torch.mapf.grid import build_coarse_grid as tcoarse
from lsc_dr_planner_tpu_torch.ops import lsc as tlsc
from lsc_dr_planner_tpu_torch.ops import sfc as tsfc
from lsc_dr_planner_tpu_torch.ops import trajectory as ttraj
from lsc_dr_planner_tpu_torch.planner import goal as tgoal
from lsc_dr_planner_tpu_torch.planner.priority import prior_based_goal as tprior
from lsc_dr_planner_tpu_torch.world.grid import build_grid_world as tbuild

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

# Both sides compute in float32 with the same formulas; only the order of
# a few 3-term sums differs, so 1e-5 absolute covers rounding on values
# of order 1-10.
ATOL = 1e-5
M, n = 4, 5
N = n + 1


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def _lsc_case(dim, seed=0):
    """A = 5 agents, O = 6 slots: 4 agent neighbours then 2 dynamic
    obstacles; slot 5 of agent 1 masked; slot 0 of agent 0 on the agent's
    own trajectory (a degenerate hull)."""
    rng = np.random.default_rng(seed)
    A, OA, OD = 5, 4, 2
    O = OA + OD
    init = rng.normal(size=(A, M, N, 3)).astype(np.float32)
    obs = (init[:, None] + rng.normal(size=(A, O, M, N, 3)) * 0.8).astype(np.float32)
    obs[0, 0] = init[0]
    if dim == 2:
        init[..., 2] = 0.6
        obs[..., 2] = 0.6
    is_agent = np.concatenate([np.ones((A, OA), bool), np.zeros((A, OD), bool)], 1)
    mask = np.ones((A, O), bool)
    mask[1, 5] = False
    radius = np.full(A, 0.15, np.float32)
    downwash = np.full(A, 2.0, np.float32)
    obs_radius = np.where(is_agent, 0.15, 0.2).astype(np.float32)
    obs_downwash = np.where(is_agent, 2.0, 1.0).astype(np.float32)
    sizes = (obs_radius[..., None, None]
             + rng.uniform(0, 0.3, (A, O, M, N)) * ~is_agent[..., None, None]).astype(np.float32)
    obs_pos = obs[:, :, 0, 0].copy()
    goal = rng.normal(size=(A, 3)).astype(np.float32)
    return dict(init=init, obs=obs, sizes=sizes, radius=radius, downwash=downwash,
                obs_radius=obs_radius, obs_downwash=obs_downwash, is_agent=is_agent,
                obs_pos=obs_pos, goal=goal, mask=mask)


def _call(kind, pkg, arr, c):
    a = {k: arr(v) for k, v in c.items()}
    if kind == "lsc":
        return pkg.build_lsc(a["init"], a["obs"], a["sizes"], a["radius"], a["downwash"],
                             a["obs_radius"], a["obs_downwash"], a["is_agent"],
                             a["obs_pos"], a["goal"], a["mask"])
    if kind == "bvc":
        return pkg.build_bvc(a["init"], a["obs"], a["radius"], a["downwash"],
                             a["obs_radius"], a["obs_downwash"], a["is_agent"], a["mask"])
    return pkg.build_reciprocal_rsfc(a["init"], a["obs"], a["sizes"], a["radius"],
                                     a["downwash"], a["obs_radius"], a["obs_downwash"],
                                     a["is_agent"], a["mask"])


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["lsc", "bvc", "rsfc"])
def test_corridor_constructions_match_jax(kind, dim):
    c = _lsc_case(dim)
    t = _call(kind, tlsc, torch.as_tensor, c)
    j = _call(kind, jlsc, jnp.asarray, c)
    for name in ("normals", "anchors", "margins"):
        close(getattr(t, name), getattr(j, name))
    # the dynamic-obstacle margin is the predicted size plus the radius
    # (RSFC splits only two agents' in-conflict margins)
    if kind != "bvc":
        np.testing.assert_allclose(t.margins[:, 4:].numpy(),
                                   c["sizes"][:, 4:] + c["radius"][:, None, None, None],
                                   rtol=0, atol=1e-6)
    assert (t.normals[1, 5] == 0).all()  # the masked slot is vacuous
    if kind == "lsc":
        # degenerate hull: the normal falls back toward the agent's goal
        assert np.isfinite(t.normals.numpy()).all()
        assert torch.linalg.vector_norm(t.normals[0, 0], dim=-1).min() > 0.1


def test_subsegment_first():
    rng = np.random.default_rng(1)
    ctrl = rng.normal(size=(3, 2, M, N, 3)).astype(np.float32)
    for frac in (0.5, 0.25):
        close(ttraj.subsegment_first(torch.as_tensor(ctrl), frac),
              jtraj.subsegment_first(jnp.asarray(ctrl), frac))


def test_right_hand_goal_and_deadlock():
    rng = np.random.default_rng(2)
    A = 12
    pos = rng.normal(size=(A, 3)).astype(np.float32)
    vel = (rng.normal(size=(A, 3)) * 0.1).astype(np.float32)
    goal = (pos + rng.normal(size=(A, 3))).astype(np.float32)
    goal[:3] = pos[:3] + 0.05  # at the goal: never deadlocked
    for seq in (3, 9):
        dl_t = tgoal.is_deadlock(seq, torch.as_tensor(vel), torch.as_tensor(pos),
                                 torch.as_tensor(goal), 0.1, 5)
        dl_j = jgoal.is_deadlock(jnp.int32(seq), jnp.asarray(vel), jnp.asarray(pos),
                                 jnp.asarray(goal), 0.1, 5)
        np.testing.assert_array_equal(dl_t.numpy(), np.asarray(dl_j))
        close(tgoal.right_hand_goal(torch.as_tensor(pos), torch.as_tensor(goal), dl_t),
              jgoal.right_hand_goal(jnp.asarray(pos), jnp.asarray(goal), dl_j))
    assert dl_t.any() and not dl_t.all()


def _forest(seed=0, n_trees=25):
    rng = np.random.default_rng(seed)
    boxes = np.asarray([[*rng.uniform(-4, 4, 2), 0.5, 0.35, 0.35, 1.0]
                        for _ in range(n_trees)])
    gj = jbuild(boxes, [-5, -5, 0], [5, 5, 1], 0.1, 0.15)
    gt = tbuild(boxes, [-5, -5, 0], [5, 5, 1], 0.1, 0.15, "cpu")
    return rng, gj, gt


def _dist_fns(gj, gt):
    def dj(q):
        return float(gj.distance_to_obstacle(jnp.asarray(q, jnp.float32))[0])

    def dt(q):
        return float(gt.distance_to_obstacle(torch.as_tensor(q, dtype=torch.float32))[0])

    return dj, dt


def test_cast_ray_and_los_goal():
    rng, gj, gt = _forest()
    dj, dt = _dist_fns(gj, gt)
    hits = []
    for _ in range(40):
        p0 = np.append(rng.uniform(-4.5, 4.5, 2), 0.6)
        p1 = np.append(rng.uniform(-4.5, 4.5, 2), 0.6)
        got = tgoal.cast_ray(dt, p0, p1, 0.2, 1.0, 0.1)
        assert got == jgoal.cast_ray(dj, p0, p1, 0.2, 1.0, 0.1)
        hits.append(got)
        path = [p0 + (p1 - p0) * k / 4 for k in range(1, 4)]
        np.testing.assert_array_equal(
            tgoal.find_los_free_goal(dt, p0, path, p1, 0.15, 1.0, 0.1),
            jgoal.find_los_free_goal(dj, p0, path, p1, 0.15, 1.0, 0.1))
    assert any(hits) and not all(hits)


def _sfc_cases(rng, gj, M_sfc=10):
    cases = []
    for _ in range(6):
        pos = np.append(rng.uniform(-4.5, 4.5, 2), 0.6).astype(np.float32)
        last_pt = (pos + np.append(rng.uniform(-0.5, 0.5, 2), 0)).astype(np.float32)
        cgoal = (pos + np.append(rng.uniform(-1.5, 1.5, 2), 0)).astype(np.float32)
        wpt = (pos + np.append(rng.uniform(-1.0, 1.0, 2), 0)).astype(np.float32)
        slo = np.tile(np.asarray(gj.point_to_lattice_floor(jnp.asarray(pos))) - 2, (M_sfc, 1))
        shi = np.tile(np.asarray(gj.point_to_lattice_ceil(jnp.asarray(pos))) + 2, (M_sfc, 1))
        # boxes that drift along the path, so shift, hold and rebuild all occur
        drift = np.round(np.linspace(0, 1, M_sfc)[:, None]
                         * np.append(rng.integers(-6, 7, 2), 0)).astype(np.int32)
        slo, shi = (slo + drift).astype(np.int32), (shi + drift).astype(np.int32)
        ictrl = (np.linspace(pos, last_pt, M_sfc * N).reshape(M_sfc, N, 3)
                 + np.append(rng.normal(0, 0.05, (M_sfc, N, 2)), np.zeros((M_sfc, N, 1)), -1)
                 ).astype(np.float32)
        for init_done in (False, True):
            cases.append((slo, shi, init_done, last_pt, cgoal, wpt, pos, ictrl))
    return cases


@pytest.mark.parametrize("radius_cells", [40, 0])
@pytest.mark.parametrize("mode", ["point", "substep"])
def test_update_sfc_fused_modes_exact(mode, radius_cells):
    """The batched port (all trials as one fleet) against the JAX fused
    update, trial by trial: integer boxes identical."""
    rng, gj, gt = _forest()
    cases = _sfc_cases(rng, gj)
    cols = [torch.as_tensor(np.stack(c)) for c in zip(*cases)]
    t_lo, t_hi, *_ = tsfc.update_sfc(gt, mode, *cols, 0.15, max_radius_cells=radius_cells)
    for a, c in enumerate(cases):
        j_lo, j_hi = jsfc.update_sfc_fused(gj, mode, *map(jnp.asarray, c), 0.15,
                                           max_radius_cells=radius_cells)
        np.testing.assert_array_equal(t_lo[a].numpy(), np.asarray(j_lo), err_msg=str(a))
        np.testing.assert_array_equal(t_hi[a].numpy(), np.asarray(j_hi), err_msg=str(a))


def test_goal_directed_axis_order():
    rng = np.random.default_rng(4)
    lo = rng.normal(size=(50, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0, 1, (50, 3))).astype(np.float32)
    goal = rng.normal(size=(50, 3)).astype(np.float32)
    goal[:10, 2] = 0.5 * (lo[:10, 2] + hi[:10, 2])  # ties at |delta| = 0
    got = tsfc.goal_directed_axis_order(*map(torch.as_tensor, (lo, hi, goal)))
    for i in range(50):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jsfc.goal_directed_axis_order(
                jnp.asarray(lo[i]), jnp.asarray(hi[i]), jnp.asarray(goal[i]))))


def test_prior_based_goal_matches_jax():
    """Six agents in a small forest: every agent's priority goal (back
    away, A* + line of sight, or the desired goal) is identical."""
    rng, gj, gt = _forest(seed=3, n_trees=12)
    p = Param()
    A = 6
    pos = np.concatenate([rng.uniform(-4, 4, (A, 2)), np.full((A, 1), 0.6)], 1)
    pos[1, :2] = pos[0, :2] + [0.3, 0.0]  # close pair: one backs away
    goal = np.concatenate([rng.uniform(-4, 4, (A, 2)), np.full((A, 1), 0.6)], 1)
    goal[2] = pos[2]  # parked at its goal
    vel = rng.normal(size=(A, 3)) * 0.3
    prev_end = pos + rng.normal(size=(A, 3)) * 0.3
    radius, downwash = np.full(A, 0.15), np.full(A, 2.0)
    dj, dt = _dist_fns(gj, gt)

    def linf(world, as_arr):
        def f(points):
            d, c = world.distance_to_obstacle(as_arr(points))
            c = np.asarray(c)
            cp = np.clip(points, c - 0.05, c + 0.05)
            return np.max(np.abs(cp - points), axis=-1)
        return f

    cj = jcoarse([-5, -5, 0], [5, 5, 1], p.grid_resolution, 2, p.world_z_2d,
                 distance_fn=linf(gj, lambda x: jnp.asarray(x, jnp.float32)),
                 agent_radius=0.15 + p.grid_margin)
    ct = tcoarse([-5, -5, 0], [5, 5, 1], p.grid_resolution, 2, p.world_z_2d,
                 distance_fn=linf(gt, lambda x: torch.as_tensor(x, dtype=torch.float32)),
                 agent_radius=0.15 + p.grid_margin)
    np.testing.assert_array_equal(ct.occ, cj.occ)
    kinds = set()
    for i in range(A):
        nbrs = [j for j in range(A) if j != i]
        gt_i = tprior(i, pos, vel, goal, prev_end, radius, downwash, nbrs, ct, dt, p)
        gj_i = jprior(i, pos, vel, goal, prev_end, radius, downwash, nbrs, cj, dj, p)
        np.testing.assert_array_equal(gt_i, gj_i, err_msg=str(i))
        kinds.add("desired" if np.array_equal(gt_i, goal[i]) else "other")
        # without obstacles (no distance function) the goal is the desired one
        np.testing.assert_array_equal(
            tprior(i, pos, vel, goal, prev_end, radius, downwash, nbrs, ct, None, p),
            jprior(i, pos, vel, goal, prev_end, radius, downwash, nbrs, cj, None, p))
    assert kinds == {"desired", "other"}
