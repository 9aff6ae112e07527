"""The port's host modules against the JAX package's: missions, world
distance queries, the coarse MAPF grid, the PIBT/ECBS solvers (native
and Python), dynamic obstacles and octomap worlds. The host code is
numpy in both packages, so every comparison is exact, apart from the
float32 distance query, which is held to 1e-5."""

import dataclasses

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu import mission as mission_j
from lsc_dr_planner_tpu.config import Param as ParamJ
from lsc_dr_planner_tpu.mapf import ecbs as ecbs_j
from lsc_dr_planner_tpu.mapf import native as native_j
from lsc_dr_planner_tpu.mapf import pibt as pibt_j
from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator as SimJ
from lsc_dr_planner_tpu.world import grid as grid_j
from lsc_dr_planner_tpu.world import obstacles as obstacles_j
from lsc_dr_planner_tpu.world import octomap as octomap_j
from lsc_dr_planner_tpu_torch import mission as mission_t
from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.config import Param as ParamT
from lsc_dr_planner_tpu_torch.mapf import ecbs as ecbs_t
from lsc_dr_planner_tpu_torch.mapf import native as native_t
from lsc_dr_planner_tpu_torch.mapf import pibt as pibt_t
from lsc_dr_planner_tpu_torch.mapf.grid import bfs_distances
from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator as SimT
from lsc_dr_planner_tpu_torch.world import grid as grid_t
from lsc_dr_planner_tpu_torch.world import obstacles as obstacles_t
from lsc_dr_planner_tpu_torch.world import octomap as octomap_t
from tools import scale_demo

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)


def _assert_same_mission(a, b):
    sa, sb = a.stacked(), b.stacked()
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    np.testing.assert_array_equal(a.world_boxes, b.world_boxes)
    np.testing.assert_array_equal(a.world_min, b.world_min)
    np.testing.assert_array_equal(a.world_max, b.world_max)


@pytest.mark.parametrize("n, seed, sep", [(6, 0, 0.6), (12, 3, 1.0), (30, 7, 0.8)])
def test_generate_random_mission_matches_jax(n, seed, sep):
    args = (n, [-5.0, -4.0, 0.0], [5.0, 4.0, 2.5])
    kw = dict(seed=seed, min_separation=sep)
    _assert_same_mission(mission_t.generate_random_mission(*args, **kw),
                         mission_j.generate_random_mission(*args, **kw))


@pytest.mark.parametrize("n, seed", [(8, 0), (10, 0), (64, 0), (64, 5)])
def test_forest_mission_matches_scale_demo(n, seed):
    got = workload.forest_mission(n, seed)
    want = scale_demo.make_forest_mission(n, seed)
    _assert_same_mission(got, want)
    assert len(got.world_boxes) == int(0.12 * max(8.0, 1.55 * np.sqrt(n) * 1.2) ** 2)


def test_mission_json_roundtrip_matches_jax(tmp_path):
    m = workload.forest_mission(5, 2)
    path = str(tmp_path / "m.json")
    m.save(path)
    a = mission_t.Mission.load(path, world_dimension=2, world_z_2d=1.0)
    b = mission_j.Mission.load(path, world_dimension=2, world_z_2d=1.0)
    _assert_same_mission(a, b)


def _worlds(boxes, wmin, wmax):
    res, radius = 0.1, 0.15
    gj = grid_j.build_grid_world(boxes, wmin, wmax, res, radius)
    gt = grid_t.build_grid_world(boxes, wmin, wmax, res, radius, "cpu")
    return gj, gt


@pytest.mark.parametrize("n_trees", [0, 1, 26])
def test_distance_to_obstacle_matches_jax(n_trees):
    m = workload.forest_mission(64, 1)
    boxes = m.world_boxes[:n_trees]
    gj, gt = _worlds(boxes, m.world_min, m.world_max)
    assert gt.n_boxes == gj.n_boxes == n_trees
    np.testing.assert_array_equal(gt.cell_ranges.numpy(), np.asarray(gj.cell_ranges))
    rng = np.random.default_rng(n_trees)
    pts = rng.uniform(m.world_min, m.world_max, (500, 3))
    if n_trees:
        # points inside boxes, and on their faces
        inside = boxes[rng.integers(0, n_trees, 200), :3] + rng.uniform(-0.15, 0.15, (200, 3))
        pts = np.concatenate([pts, inside, boxes[:, :3] + [0.15, 0.0, 0.0]])
    pts = pts.astype(np.float32)
    dj, cj = gj.distance_to_obstacle(pts)
    dt, ct = gt.distance_to_obstacle(torch.as_tensor(pts))
    if n_trees == 0:
        assert np.isinf(dt.numpy()).all() and (ct.numpy() == 0).all()
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    if n_trees:
        assert (dt.numpy() < 0.15).sum() > 100  # the inside points were inside


@pytest.mark.parametrize("n, seed", [(8, 0), (10, 0), (64, 0), (24, 9)])
def test_coarse_grid_matches_jax(n, seed):
    """The simulator's coarse MAPF grids (margined and margin-free), built
    from each package's world distance query, have identical occupancy."""
    m = workload.forest_mission(n, seed)
    sj = SimJ(ParamJ(multisim_save_result=False), m, log_dir="log")
    st = SimT(ParamT(multisim_save_result=False), m, log_dir="log", device="cpu")
    for name in ("coarse", "coarse_nomargin"):
        a, b = getattr(st, name), getattr(sj, name)
        np.testing.assert_array_equal(a.occ, b.occ, err_msg=name)
        np.testing.assert_array_equal(a.grid_min, b.grid_min)
        assert a.dims == b.dims
    assert st.coarse.occ.any()
    assert st._layer == sj._layer
    assert st.planner.O == sj.planner.O == min(n - 1, 16)


def _mapf_instance(seed, n):
    """Start and goal cells on a forest mission's coarse grid, each goal
    reachable from its start."""
    m = workload.forest_mission(24, seed)
    st = SimT(ParamT(multisim_save_result=False), m, log_dir="log", device="cpu")
    occ = st.coarse.occ2d().copy()
    rng = np.random.default_rng(seed)
    free = [tuple(int(v) for v in c) for c in np.argwhere(~occ)]
    rng.shuffle(free)
    cur, goals = free[:n], []
    for c in free[n:]:
        if len(goals) == n:
            break
        if np.isfinite(bfs_distances(occ, c)[cur[len(goals)]]):
            goals.append(c)
    assert len(goals) == n
    return occ, cur, goals


@pytest.mark.parametrize("solver", ["pibt", "ecbs"])
@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("seed", [0, 1])
def test_mapf_solvers_match_jax(solver, backend, seed):
    occ, cur, goals = _mapf_instance(seed, 6 if solver == "ecbs" else 12)
    if backend == "native":
        assert native_t.backend_name() == "native"
        assert native_j.backend_name() == "native"
        mods = (native_t, native_j)
    else:
        mods = (pibt_t, pibt_j) if solver == "pibt" else (ecbs_t, ecbs_j)
    if solver == "pibt":
        elapsed = list(range(len(cur)))
        got, want = (mod.solve_pibt(occ, cur, cur, goals, seed=0, init_elapsed=elapsed)
                     for mod in mods)
    else:
        got, want = (mod.solve_ecbs(occ, cur, cur, goals, max_hl_nodes=2000,
                                    return_lb=True)
                     for mod in mods)
        assert got[0] is not None
    assert got is not None and got == want


def test_native_library_builds_under_build_dir():
    path = native_t._lib_path()
    assert native_t.available()
    assert path.startswith(native_t._BUILD_DIR) and path.endswith(".so")
    assert native_t._lib_path() == path  # same sources, same name


def test_obstacle_generator_matches_jax():
    kinds = [
        dict(type="straight", radius=0.2, max_acc=2.0, start=[0.0, 0, 1],
             goal=[4.0, 0, 1], speed=1.0),
        dict(type="spin", radius=0.2, max_acc=10.0, axis_position=[0.0, 0, 1],
             axis_ori=[0.0, 0, 1], start=[1.0, 0, 1], speed=1.0),
        dict(type="patrol", radius=0.2, max_acc=2.0,
             waypoints=[[0.0, 0, 1], [2.0, 0, 1], [2.0, 2, 1]], speed=1.0),
        dict(type="gaussian", radius=0.2, max_acc=1.0, start=[0.0, 0, 1],
             initial_vel=[0.5, 0, 0], max_vel=1.0, stddev_acc=0.5),
        dict(type="chasing", radius=0.2, max_acc=2.0, start=[0.0, 0, 1],
             max_vel=1.0, gamma_target=1.0, gamma_obs=1.0),
    ]

    def specs(mod):
        return [mod.ObstacleSpec(**{k: np.asarray(v, float) if isinstance(v, list) else v
                                    for k, v in kw.items()}) for kw in kinds]

    gens = [obstacles_t.ObstacleGenerator(specs(mission_t), seed=11),
            obstacles_j.ObstacleGenerator(specs(mission_j), seed=11)]
    for g in gens:
        g.models[-1].set_goal([5.0, 0, 1])
    rngs = [np.random.default_rng(3), np.random.default_rng(3)]
    for t in np.arange(0.0, 6.0, 0.2):
        a, b = (g.states_at(t, noise_std=0.05, rng=r) for g, r in zip(gens, rngs))
        assert len(a) == len(b) == len(kinds)
        for sa, sb in zip(a, b):
            for f in dataclasses.fields(sa):
                np.testing.assert_array_equal(getattr(sa, f.name), getattr(sb, f.name))


def test_bt_roundtrip_across_packages(tmp_path):
    """A .bt written by either package reads back identically in both,
    and the port's Mission loads it to the CSV world's occupancy."""
    rng = np.random.default_rng(0)
    res = 0.1
    occ = rng.random((20, 16, 8)) < 0.2
    origin = np.array([-10, -8, 0])
    pt, pj = str(tmp_path / "t.bt"), str(tmp_path / "j.bt")
    octomap_t.write_bt(pt, occ, origin, res)
    octomap_j.write_bt(pj, occ, origin, res)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    bt, rt = octomap_t.read_bt(pj)
    bj, rj = octomap_j.read_bt(pt)
    np.testing.assert_array_equal(bt, bj)
    assert rt == rj
    wmin, wmax = origin * res, (origin + np.array(occ.shape)) * res
    m = mission_t.Mission()
    m.load_world(pt)
    occ2, _, oi2, _ = grid_t.rasterize_boxes(m.world_boxes, wmin, wmax, res)
    np.testing.assert_array_equal(oi2, origin)
    np.testing.assert_array_equal(occ2, occ)
