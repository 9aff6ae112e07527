"""Local sensing in the port against the JAX package: the per-agent
blocked lattice and integral image, the map manager (sensing, merging,
versions), the SFC update over per-agent maps, the planning step with
`occ_known`, and the simulator (per-step parity from JAX checkpoints,
whole missions, checkpoints). Integer results are bit-exact; control
points are held to the pipeline's tolerance (0.1 m where both QPs
converged, goals 1e-4), as in tests/test_torch_pipeline.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from lsc_dr_planner_tpu.config import Param as ParamJ
from lsc_dr_planner_tpu.ops import sfc as jsfc
from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator as SimJ
from lsc_dr_planner_tpu.world import grid as jgrid
from lsc_dr_planner_tpu.world.map_manager import MapManager as MapManagerJ
from lsc_dr_planner_tpu_torch import convert, workload
from lsc_dr_planner_tpu_torch.config import Param as ParamT
from lsc_dr_planner_tpu_torch.mission import generate_random_mission
from lsc_dr_planner_tpu_torch.ops import sfc as tsfc
from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator as SimT
from lsc_dr_planner_tpu_torch.world import grid as tgrid
from lsc_dr_planner_tpu_torch.world.map_manager import MapManager as MapManagerT

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)


def _fields(obj):
    return obj._asdict() if hasattr(obj, "_asdict") else vars(obj)


# ======================================================================
# per-agent blocked lattice and integral image
# ======================================================================


@pytest.mark.parametrize("res, radius", [(0.1, 0.15), (0.1, 0.3), (0.2, 0.15)])
@pytest.mark.parametrize("batched", [False, True])
def test_blocked_cumsum_matches_jax(batched, res, radius):
    rng = np.random.default_rng(1)
    occ = rng.random((3, 12, 10, 6)) < 0.25
    occ[1] = False
    if not batched:
        occ = occ[0]
    blk_j, S_j = jgrid.blocked_cumsum_jnp(jnp.asarray(occ), res, radius)
    blk_t, S_t = tgrid.blocked_cumsum(torch.as_tensor(occ), res, radius)
    assert S_t.dtype == torch.int32 and blk_t.dtype == torch.bool
    np.testing.assert_array_equal(blk_t.numpy(), np.asarray(blk_j))
    np.testing.assert_array_equal(S_t.numpy(), np.asarray(S_j))
    # the host build of the global world, map by map
    for o, b in zip(occ.reshape((-1,) + occ.shape[-3:]),
                    blk_t.reshape((-1,) + blk_t.shape[-3:])):
        np.testing.assert_array_equal(b.numpy(), jgrid._blocked_lattice_mask(o, res, radius))
    if batched:
        assert not blk_t[1].any()


def _tree_world(seed=0, n=14):
    rng = np.random.default_rng(seed)
    boxes = np.asarray([[*rng.uniform(-3, 3, 2), 0.5, 0.35, 0.35, 1.0] for _ in range(n)])
    return rng, boxes, [-3.5, -3.5, 0.0], [3.5, 3.5, 1.0]


def _known_subsets(rng, boxes, wmin, wmax, A, res=0.1):
    """Per agent, the rasterization of a random half of the boxes."""
    return np.stack([tgrid.rasterize_boxes(boxes[rng.random(len(boxes)) < 0.5], wmin, wmax,
                                           res)[0] for _ in range(A)])


def test_per_agent_box_queries_match_jax():
    rng, boxes, wmin, wmax = _tree_world()
    gt = tgrid.build_grid_world(boxes, wmin, wmax, 0.1, 0.15, "cpu")
    gj = jgrid.build_grid_world(boxes, wmin, wmax, 0.1, 0.15)
    occ = _known_subsets(rng, boxes, wmin, wmax, 4)
    view = tgrid.local_grid_world(gt, tgrid.blocked_cumsum(torch.as_tensor(occ), 0.1, 0.15)[1])
    assert view.n_boxes == 0 and view.dims == gt.dims
    dims = np.asarray(gt.dims)
    lo = rng.integers(-5, dims + 5, size=(4, 500, 3)).astype(np.int32)
    hi = (lo + rng.integers(0, 30, size=(4, 500, 3))).astype(np.int32)
    agent = torch.arange(4)[:, None].expand(4, 500)
    got = view.box_blocked_count(torch.as_tensor(lo), torch.as_tensor(hi), agent)
    for a in range(4):
        blk, S = jgrid.blocked_cumsum_jnp(jnp.asarray(occ[a]), 0.1, 0.15)
        ja = jgrid.local_grid_world(gj, jnp.asarray(occ[a]), blk, S)
        np.testing.assert_array_equal(
            got[a].numpy(), np.asarray(ja.box_blocked_count(jnp.asarray(lo[a]),
                                                            jnp.asarray(hi[a]))))
    assert (got > 0).any() and (got == 0).any()
    with pytest.raises(ValueError):
        gt.box_blocked_count(torch.as_tensor(lo[0]), torch.as_tensor(hi[0]), agent[0])


# ======================================================================
# map manager
# ======================================================================


def test_map_manager_matches_jax():
    """Sensing, merging in and out of range, the union and the versions
    of both map managers over a random walk of 6 agents: identical."""
    rng, boxes, wmin, wmax = _tree_world(seed=2)
    A = 6
    mj = MapManagerJ(boxes, wmin, wmax, 0.1, A, use_global_map=False)
    mt = MapManagerT(boxes, wmin, wmax, 0.1, A, use_global_map=False, device="cpu")
    np.testing.assert_array_equal(mt.occ_true, mj.occ_true)
    pos = np.column_stack([rng.uniform(-3, 3, (A, 2)), np.full(A, 0.6)])
    for k, comm in enumerate((1.5, 10.0, 2.5, -1.0)):
        for _ in range(3):
            pos[:, :2] += rng.uniform(-0.4, 0.4, (A, 2))
            mj.sense(pos, 1.2)
            mt.sense(pos, 1.2)
            np.testing.assert_array_equal(mt.known.numpy(), mj.known)
            np.testing.assert_array_equal(mt._version, mj._version)
        mj.merge(pos, comm)
        mt.merge(pos, comm)
        np.testing.assert_array_equal(mt.known.numpy(), mj.known, err_msg=str(comm))
        np.testing.assert_array_equal(mt._version, mj._version)
        np.testing.assert_array_equal(mt.union_occ(), mj.union_occ())
        assert mt.version() == mj.version()
        if k == 0:  # some maps differ after a merge within a short range
            assert not (mt.known == mt.known[:1]).all()
    assert mt.known.all(dim=0).equal(mt.known.any(dim=0))  # comm -1: one map for all
    assert mt.union_occ().any()


def _mm(n_agents=2):
    boxes = np.array([
        [1.0, 0.0, 0.5, 0.2, 0.2, 1.0],   # near
        [2.5, 2.5, 0.5, 0.2, 0.2, 1.0],   # far
    ])
    return MapManagerT(boxes, [-3, -3, 0], [3, 3, 1], 0.1, n_agents,
                       use_global_map=False, device="cpu")


def test_sense_reveals_only_in_range():
    mm = _mm()
    assert not mm.known.any()
    mm.sense(np.array([[0.0, 0.0, 0.5], [-2.0, -2.0, 0.5]]), sensor_range=1.5)
    # agent 0 sees the near pillar only; agent 1 sees nothing
    occ0 = mm.known[0].numpy()
    occ1 = mm.known[1].numpy()
    assert occ0.any() and not occ1.any()
    idx = np.argwhere(occ0)
    centers = (idx + mm.origin_idx + 0.5) * mm.resolution
    d = np.linalg.norm(centers - np.array([0.0, 0.0, 0.5]), axis=-1)
    assert (d <= 1.5 + 1e-9).all()
    # the far pillar is undiscovered
    assert occ0.sum() < mm.occ_true.sum()


def test_merge_unions_within_range():
    mm = _mm()
    mm.sense(np.array([[0.6, 0.0, 0.5], [2.5, 2.0, 0.5]]), sensor_range=1.0)
    k0, k1 = mm.known[0].clone(), mm.known[1].clone()
    assert k0.any() and k1.any() and not (k0 & k1).any()
    # out of comm range: no change
    mm.merge(np.array([[0.6, 0.0, 0.5], [2.5, 2.0, 0.5]]), comm_range=1.0)
    assert torch.equal(mm.known[0], k0)
    # in range: both get the union
    mm.merge(np.array([[0.6, 0.0, 0.5], [2.5, 2.0, 0.5]]), comm_range=10.0)
    assert torch.equal(mm.known[0], k0 | k1)
    assert torch.equal(mm.known[1], k0 | k1)


def test_global_map_mode_knows_everything():
    boxes = np.array([[1.0, 0.0, 0.5, 0.2, 0.2, 1.0]])
    mm = MapManagerT(boxes, [-3, -3, 0], [3, 3, 1], 0.1, 3, use_global_map=True,
                     device="cpu")
    for a in range(3):
        np.testing.assert_array_equal(mm.known[a].numpy(), mm.occ_true)


# ======================================================================
# SFC update over per-agent maps
# ======================================================================


def _sfc_cases(rng, gj, n=6, M=10, N=6):
    """The case generator of tests/test_torch_modes_ops.py."""
    cases = []
    for _ in range(n):
        pos = np.append(rng.uniform(-3, 3, 2), 0.6).astype(np.float32)
        last_pt = (pos + np.append(rng.uniform(-0.5, 0.5, 2), 0)).astype(np.float32)
        cgoal = (pos + np.append(rng.uniform(-1.5, 1.5, 2), 0)).astype(np.float32)
        wpt = (pos + np.append(rng.uniform(-1.0, 1.0, 2), 0)).astype(np.float32)
        slo = np.tile(np.asarray(gj.point_to_lattice_floor(jnp.asarray(pos))) - 2, (M, 1))
        shi = np.tile(np.asarray(gj.point_to_lattice_ceil(jnp.asarray(pos))) + 2, (M, 1))
        drift = np.round(np.linspace(0, 1, M)[:, None]
                         * np.append(rng.integers(-6, 7, 2), 0)).astype(np.int32)
        slo, shi = (slo + drift).astype(np.int32), (shi + drift).astype(np.int32)
        ictrl = (np.linspace(pos, last_pt, M * N).reshape(M, N, 3)
                 + np.append(rng.normal(0, 0.05, (M, N, 2)), np.zeros((M, N, 1)), -1)
                 ).astype(np.float32)
        for init_done in (False, True):
            cases.append((slo, shi, init_done, last_pt, cgoal, wpt, pos, ictrl))
    return cases


@pytest.mark.parametrize("mode", ["hull", "point", "substep"])
def test_update_sfc_fused_per_agent_maps_exact(mode):
    """All cases as one fleet, each with its own known map, against the
    JAX pipeline's per-agent vmap over local_grid_world: identical
    integer boxes; and some differ from the boxes of the global map."""
    rng, boxes, wmin, wmax = _tree_world(seed=3, n=20)
    gj = jgrid.build_grid_world(boxes, wmin, wmax, 0.1, 0.15)
    gt = tgrid.build_grid_world(boxes, wmin, wmax, 0.1, 0.15, "cpu")
    cases = _sfc_cases(rng, gj)
    occ = _known_subsets(rng, boxes, wmin, wmax, len(cases))
    cols = [np.stack(c) for c in zip(*cases)]

    def one(args, occ_a):
        blk, S = jgrid.blocked_cumsum_jnp(occ_a, gj.resolution, gj.radius)
        return jsfc.update_sfc_fused(jgrid.local_grid_world(gj, occ_a, blk, S), mode, *args,
                                     0.15, max_radius_cells=40)

    j_lo, j_hi = jax.jit(jax.vmap(one))(tuple(map(jnp.asarray, cols)), jnp.asarray(occ))
    view = tgrid.local_grid_world(gt, tgrid.blocked_cumsum(torch.as_tensor(occ), 0.1, 0.15)[1])
    t_args = list(map(torch.as_tensor, cols))
    t_lo, t_hi, *_ = tsfc.update_sfc(view, mode, *t_args, 0.15, max_radius_cells=40)
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(j_lo))
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(j_hi))
    g_lo, g_hi, *_ = tsfc.update_sfc(gt, mode, *t_args, 0.15, max_radius_cells=40)
    assert not (torch.equal(g_lo, t_lo) and torch.equal(g_hi, t_hi))


# ======================================================================
# the planning step with occ_known
# ======================================================================


def test_teacher_forced_steps_with_known_maps_match_jax():
    """The bench fleet (A=16) with per-agent known maps (the trees within
    2.5 m of each agent's start), teacher-forced along the JAX plan as in
    tests/test_torch_pipeline.py."""
    A = 16
    pj, plan_j, fleet_j, inp_j = bench.build_fleet(A)
    step_j = bench.make_evolve_step(pj, plan_j, fleet_j)
    _, plan_t, _, _ = workload.build_fleet(A, device="cpu")
    fleet = convert.fleet_from_numpy(_fields(fleet_j), "cpu")
    pos2, _, boxes, wmin, wmax = workload.fleet_layout(A)
    near = np.linalg.norm(boxes[None, :, :2] - pos2[:, None], axis=-1) < 2.5
    known = np.stack([tgrid.rasterize_boxes(boxes[near[a]], wmin, wmax, pj.world_resolution)[0]
                      for a in range(A)])
    assert known.any() and not (known == known[:1]).all()
    inp_j = inp_j._replace(occ_known=jnp.asarray(known))
    for s in range(3):
        out_j = plan_j.step(fleet_j, inp_j)
        inp_t = convert.inputs_from_numpy(_fields(inp_j), "cpu")
        assert inp_t.occ_known.dtype == torch.bool
        out_t = convert.outputs_to_numpy(plan_t.step(fleet, inp_t))
        np.testing.assert_array_equal(out_t["sfc_lo"], np.asarray(out_j.sfc_lo))
        np.testing.assert_array_equal(out_t["sfc_hi"], np.asarray(out_j.sfc_hi))
        conv_j = np.asarray(out_j.qp_converged)
        np.testing.assert_array_equal(out_t["qp_converged"], conv_j, err_msg=f"step {s}")
        np.testing.assert_allclose(out_t["current_goal"], np.asarray(out_j.current_goal),
                                   rtol=0, atol=1e-4)
        dctrl = np.abs(out_t["desired_ctrl"] - np.asarray(out_j.desired_ctrl))[conv_j]
        assert dctrl.max(initial=0.0) < 0.1, (s, dctrl.max())
        inp_j, _ = step_j(inp_j)


def _mini(seed, boxes):
    m = generate_random_mission(3, [-3, -3, 0], [3, 3, 2.5], seed=seed, min_separation=1.5)
    m.world_boxes = np.array(boxes)
    m.world_file_name = "mini.csv"
    return m


def test_full_knowledge_equals_global_map(tmp_path):
    """With every agent's known map equal to the global map, the
    local-sensing pipeline produces the global-map trajectories."""
    m = _mini(11, [[0.0, 1.2, 1.25, 0.5, 0.5, 2.5]])
    p_g = ParamT(world_use_octomap=True, qp_max_iter=150, multisim_max_planner_iteration=12)
    p_l = ParamT(world_use_octomap=True, world_use_global_map=False, sensor_range=3.0,
                 qp_max_iter=150, multisim_max_planner_iteration=12)
    sim_g = SimT(p_g, m, log_dir=str(tmp_path), device="cpu")
    sim_l = SimT(p_l, m, log_dir=str(tmp_path), device="cpu")
    full = torch.as_tensor(sim_l.map_manager.occ_true)
    sim_l.map_manager.known[:] = full
    for it in range(6):
        if it > 0:
            sim_g.do_step()
            sim_l.do_step()
            sim_l.map_manager.known[:] = full
        sim_g.decentralized_mapp()
        sim_l.decentralized_mapp()
        assert sim_g.plan() and sim_l.plan()
        np.testing.assert_allclose(sim_l.desired_ctrl, sim_g.desired_ctrl, atol=1e-5)


# ======================================================================
# the simulator
# ======================================================================


def test_local_sensing_mission_completes(tmp_path):
    """Agents discover the world as they fly, never collide, and reach
    their goals (tests/test_map.py's mission), with the JAX audit."""
    m = _mini(7, [[0.0, 1.5, 1.25, 0.5, 0.5, 2.5], [-1.0, -1.0, 1.25, 0.4, 0.4, 2.5]])
    p = ParamT(world_use_octomap=True, world_use_global_map=False, sensor_range=3.0,
               qp_max_iter=150, multisim_max_planner_iteration=150)
    sim = SimT(p, m, log_dir=str(tmp_path), device="cpu")
    res = sim.run()
    assert not res["is_collided"] and not res["qp_failed"]
    assert res["safety_ratio_agent"] >= 1.0
    assert np.isfinite(res["total_flight_time"])
    assert sim.map_manager.union_occ().any()
    assert not sim.map_manager.union_occ().all()
    # one sense per do_step plus the initial one, one merge per plan
    assert sim.sense_time.N == sim.planner_seq and sim.merge_time.N == sim.planner_seq


def _drive(sim, start, stop):
    for it in range(start, stop):
        if it > 0:
            sim.do_step()
        sim.decentralized_mapp()
        assert sim.plan()


def test_checkpoint_local_maps_roundtrip(tmp_path):
    m = generate_random_mission(2, [-3, -3, 0], [3, 3, 2.5], seed=5, min_separation=1.5)
    m.world_boxes = np.array([[0.0, 1.0, 1.25, 0.5, 0.5, 2.5]])
    m.world_file_name = "mini.csv"
    p = ParamT(world_use_octomap=True, world_use_global_map=False, qp_max_iter=100)
    sim = SimT(p, m, log_dir=str(tmp_path), device="cpu")
    _drive(sim, 0, 4)
    ck = str(tmp_path / "ck.npz")
    sim.save_checkpoint(ck)
    sim2 = SimT(p, m, log_dir=str(tmp_path), device="cpu")
    sim2.load_checkpoint(ck)
    assert torch.equal(sim2.map_manager.known, sim.map_manager.known)
    np.testing.assert_array_equal(sim2.map_manager._version, sim.map_manager._version)
    _drive(sim, 4, 8)
    _drive(sim2, 4, 8)
    np.testing.assert_array_equal(sim2.pos, sim.pos)
    assert torch.equal(sim2.map_manager.known, sim.map_manager.known)


K_LOCAL = 3


@pytest.fixture(scope="module")
def local_forced_steps(tmp_path_factory):
    """A JAX local-sensing run of a 6-agent forest mission, checkpointed
    before each of K_LOCAL steps; from every checkpoint one step of a
    fresh JAX replica and one of the port (which loads the JAX
    checkpoint). Returns (checkpoint paths, [(jax state, port state)])."""
    tmp = tmp_path_factory.mktemp("local_forced")
    m = workload.forest_mission(6, 0)
    kw = dict(multisim_save_result=False, world_use_global_map=False, sensor_range=3.0)
    base_j = SimJ(ParamJ(**kw), m, log_dir=str(tmp))
    base_t = SimT(ParamT(**kw), m, log_dir=str(tmp), device="cpu")
    _drive(base_j, 0, 1)
    cks, out = [], []
    for k in range(K_LOCAL):
        ck = str(tmp / f"ck{k}.npz")
        base_j.save_checkpoint(ck)
        cks.append(ck)
        sj = SimJ(base_j.param, m, log_dir=str(tmp), share_static_from=base_j)
        st = SimT(base_t.param, m, log_dir=str(tmp), share_static_from=base_t)
        sj.load_checkpoint(ck)
        st.load_checkpoint(ck)
        states = []
        for s in (sj, st):
            s.do_step()
            s.decentralized_mapp()
            assert s.plan()
            states.append({k: np.array(getattr(s, k)) for k in (
                "pos", "next_waypoint", "sfc_lo", "sfc_hi", "qp_converged",
                "current_goal", "desired_ctrl")})
            states[-1]["known"] = np.array(s.map_manager.known)
            states[-1]["version"] = s.map_manager.version()
        out.append(tuple(states))
        base_j.do_step()
        base_j.decentralized_mapp()
        assert base_j.plan()
    return cks, out


def test_jax_local_checkpoint_loads(local_forced_steps, tmp_path):
    cks, _ = local_forced_steps
    m = workload.forest_mission(6, 0)
    data = np.load(cks[-1])
    st = SimT(ParamT(multisim_save_result=False, world_use_global_map=False), m,
              log_dir=str(tmp_path), device="cpu")
    st.load_checkpoint(cks[-1])
    np.testing.assert_array_equal(st.map_manager.known.numpy(), data["map_known"])
    np.testing.assert_array_equal(st.map_manager._version, data["map_version"])
    assert st._coarse_version == -1
    assert data["map_known"].any() and not data["map_known"].all(axis=0).any()


@pytest.mark.parametrize("k", range(K_LOCAL))
def test_local_sensing_step_matches_jax(local_forced_steps, k):
    sj, st = local_forced_steps[1][k]
    # host state and the known maps after sensing and merging: identical
    np.testing.assert_array_equal(st["pos"], sj["pos"])
    np.testing.assert_array_equal(st["known"], sj["known"])
    assert st["version"] == sj["version"]
    np.testing.assert_array_equal(st["next_waypoint"], sj["next_waypoint"])
    np.testing.assert_array_equal(st["sfc_lo"], sj["sfc_lo"])
    np.testing.assert_array_equal(st["sfc_hi"], sj["sfc_hi"])
    np.testing.assert_array_equal(st["qp_converged"], sj["qp_converged"])
    np.testing.assert_allclose(st["current_goal"], sj["current_goal"], rtol=0, atol=1e-4)
    conv = sj["qp_converged"]
    assert conv.all()
    assert np.abs(st["desired_ctrl"] - sj["desired_ctrl"])[conv].max() < 0.1
