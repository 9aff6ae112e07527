"""Monte-Carlo scenario batching in the port (CPU, plain torch paths):
the mirrors of tests/test_montecarlo.py, per-scenario parity with the
JAX package's MonteCarloSimulator, and the fused scenario step against
each scenario planned alone (no stage before the QP couples scenarios).

Parity tolerance, as the JAX package holds two Monte-Carlo runs whose
reductions sum in different orders (test_montecarlo_sharded_scenarios):
positions within 0.02 m; control points within 0.1 m where both QPs
converged, the pipeline's tolerance (tests/test_torch_pipeline.py)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu.config import Param as ParamJ
from lsc_dr_planner_tpu.sim.montecarlo import MonteCarloSimulator as MonteCarloJ
from lsc_dr_planner_tpu_torch import convert, workload
from lsc_dr_planner_tpu_torch.config import Param
from lsc_dr_planner_tpu_torch.mission import ObstacleSpec, generate_random_mission
from lsc_dr_planner_tpu_torch.planner.pipeline import FleetArrays, StepInputs
from lsc_dr_planner_tpu_torch.sim.montecarlo import MonteCarloSimulator
from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)


def test_montecarlo_lockstep(tmp_path):
    m = generate_random_mission(3, [-3, -3, 0], [3, 3, 2.5], seed=4, min_separation=1.5)
    p = Param(world_use_octomap=False, multisim_max_planner_iteration=80, qp_max_iter=120)
    mc = MonteCarloSimulator(p, m, n_scenarios=3, max_noise=0.5, log_dir=str(tmp_path),
                             device="cpu")
    results = mc.run()
    assert len(results) == 3
    for r in results:
        assert not r["is_collided"]
        assert r["safety_ratio_agent"] >= 1.0
    # scenario 0 is noise-free; perturbed scenarios differ
    g0 = mc.sims[0].desired_goal
    g1 = mc.sims[1].desired_goal
    assert np.linalg.norm(g0 - g1) > 1e-6
    assert set(mc.phase_times) == {"n_active", "host", "stack", "device", "apply"}
    assert mc.chunk_peak_bytes == []  # no card: no device memory record


def test_replica_shares_statics_and_matches_fresh_build(tmp_path):
    """A share_static_from replica behaves exactly like a freshly built
    simulator over the same mission, while sharing the heavy objects."""
    m = generate_random_mission(4, [-3, -3, 0], [3, 3, 2.5], seed=11, min_separation=1.2)
    p = Param(world_use_octomap=False, multisim_max_planner_iteration=30, qp_max_iter=60)
    base = MultiSyncSimulator(p, m, log_dir=str(tmp_path), device="cpu")
    fresh = MultiSyncSimulator(p, m, log_dir=str(tmp_path), device="cpu")
    replica = MultiSyncSimulator(p, m, log_dir=str(tmp_path), share_static_from=base)
    assert replica.planner is base.planner
    assert replica.coarse is base.coarse
    assert replica.world is base.world
    assert replica.device == base.device
    for it in range(4):
        for sim in (fresh, replica):
            if it > 0:
                sim.do_step()
            sim.decentralized_mapp()
            assert sim.plan()
    np.testing.assert_array_equal(fresh.pos, replica.pos)
    np.testing.assert_array_equal(fresh.desired_ctrl, replica.desired_ctrl)


def test_montecarlo_chunked_non_pow2(tmp_path):
    """S > 32 runs 32-scenario chunks one after another; a non-divisible
    count (40) pads its bucket to a multiple of 32 instead of capping at
    S."""
    p = Param(world_use_octomap=False, communication_range=3.0, profile_stages=False,
              qp_max_iter=60, qp_rescue_iter=80)
    m = generate_random_mission(3, [-4, -4, 0], [4, 4, 2.5], seed=0)
    mc = MonteCarloSimulator(p, m, n_scenarios=40, max_noise=0.2, log_dir=str(tmp_path),
                             device="cpu")
    for it in range(2):
        mc.step(it)
    assert 0.0 <= mc.last_qp_convergence <= 1.0
    assert all(np.isfinite(sim.pos).all() for sim in mc.sims)
    assert mc.phase_times["n_active"] == 40


@pytest.mark.parametrize("name", ["open", "forest_local"])
def test_montecarlo_matches_jax(tmp_path, name):
    """S=3 scenarios of a 3-agent mission, 4 lockstep steps, against the
    JAX package's Monte-Carlo on the same missions and noise: per
    scenario, positions within 0.02 m and control points within 0.1 m
    where both QPs converged; the same convergence share. In the forest
    the scenarios sense local maps (and, as in the JAX package, never
    merge them): the maps agree exactly after the first step."""
    if name == "open":
        m = generate_random_mission(3, [-3, -3, 0], [3, 3, 2.5], seed=4, min_separation=1.5)
        kw = dict(world_use_octomap=False, qp_max_iter=120)
    else:
        m = workload.forest_mission(3, 2)
        kw = dict(world_use_global_map=False, sensor_range=2.0)
    mj = MonteCarloJ(ParamJ(**kw), m, n_scenarios=3, max_noise=0.5, log_dir=str(tmp_path))
    mt = MonteCarloSimulator(Param(**kw), m, n_scenarios=3, max_noise=0.5,
                             log_dir=str(tmp_path), device="cpu")
    for it in range(4):
        mj.step(it)
        mt.step(it)
        assert mt.last_qp_convergence == mj.last_qp_convergence
        for sj, st in zip(mj.sims, mt.sims):
            np.testing.assert_allclose(st.pos, sj.pos, rtol=0, atol=0.02)
            both = st.qp_converged & sj.qp_converged
            assert np.abs(st.desired_ctrl - sj.desired_ctrl)[both].max(initial=0.0) < 0.1
            if name != "open" and it <= 1:
                np.testing.assert_array_equal(st.map_manager.known.numpy(),
                                              sj.map_manager.known)
    if name != "open":
        assert all(s.map_manager.version() > 0 for s in mt.sims)


def _fused_inputs(mc, host):
    """The fused StepInputs of the scenarios' host inputs."""
    return StepInputs(**mc._stack(host, None))


def test_fused_scenarios_plan_as_alone(tmp_path):
    """The fused S-scenario step (stages 1-5) against each scenario
    planned alone from the same state, with a dynamic obstacle observed
    under per-scenario noise: identical neighbour slots and SFC boxes,
    and QP inputs equal to float32 rounding. A reduction over the agent
    axis would show here."""
    m = workload.forest_mission(5, 1)
    m.obstacles.append(ObstacleSpec(
        type="straight", radius=0.15, max_acc=1.0, downwash=1.0,
        start=np.array([-2.0, 1.5, 0.6]), goal=np.array([2.0, 1.5, 0.6]), speed=0.3))
    p = Param(multisim_save_result=False, multisim_observer_stddev=0.05)
    mc = MonteCarloSimulator(p, m, n_scenarios=3, max_noise=0.5, log_dir=str(tmp_path),
                             device="cpu")
    for it in range(3):
        mc.step(it)
    sims, S, A = mc.sims, 3, m.qn
    for sim in sims:
        sim.do_step()
        sim.decentralized_mapp()
    host = [sim._host_step_inputs() for sim in sims]
    assert not np.array_equal(host[0]["dynobs_pos"], host[1]["dynobs_pos"])
    fused = mc.chunk_qp(mc._stack(host, None), 0, S)
    order, _ = mc.planner._neighbor_slots(_fused_inputs(mc, host), S)
    for s, (sim, h) in enumerate(zip(sims, host)):
        alone = mc.planner._step_impl(mc.fleet, sim._device_inputs(h), defer_qp=True)
        rows = slice(s * A, (s + 1) * A)
        o_alone, _ = mc.planner._neighbor_slots(sim._device_inputs(h))
        assert torch.equal(order[rows] - s * A, o_alone)
        assert torch.equal(fused.new_sfc_lo[rows], alone.new_sfc_lo)
        assert torch.equal(fused.new_sfc_hi[rows], alone.new_sfc_hi)
        torch.testing.assert_close(fused.new_goal[rows], alone.new_goal, rtol=0, atol=1e-6)
        torch.testing.assert_close(fused.obs_pred[rows], alone.obs_pred, rtol=0, atol=1e-6)
        for f in dataclasses.fields(alone.qp_inp):
            a, b = getattr(fused.qp_inp, f.name), getattr(alone.qp_inp, f.name)
            if b is not None:
                torch.testing.assert_close(a[rows], b, rtol=1e-6, atol=1e-6, msg=f.name)


def test_step5_converged_set_matches_jax_on_identical_inputs():
    """The stacked inputs with which the JAX package's Monte-Carlo plans
    step 5 of 8 scenarios of forest_mission(64, seed=1) (goal noise
    0.25 m): the port's scenario-batched step on exactly those inputs
    converges the agents JAX converges (all 512). Flown on its own
    inputs, the port fails agents 3, 39 and 61 of every scenario at this
    step: its state has drifted from JAX's by then (PERF.md, R1).
    Fixture: `tests/cpu_reference.py mcstep 8 64 1 5 <out.npz>`."""
    z = np.load(Path(__file__).parent / "fixtures" / "mc_step5_forest64_s8.npz")
    S, A = z["converged"].shape
    sim = MultiSyncSimulator(Param(multisim_save_result=False), workload.forest_mission(A, 1),
                             device="cpu")
    fields = {}
    for k in z.files:
        if k.startswith("inp_"):
            name, v = k[4:], z[k]
            if name == "planner_seq":
                v = int(v.reshape(-1)[0])
            elif not name.startswith("dynobs_"):
                v = v.reshape((S * A,) + v.shape[2:])
            fields[name] = v
    inp = convert.inputs_from_numpy(fields, "cpu")
    fleet = convert.fleet_from_numpy({k[6:]: z[k] for k in z.files if k.startswith("fleet_")},
                                     "cpu")
    for f in dataclasses.fields(fleet):
        assert torch.equal(getattr(fleet, f.name), getattr(sim.fleet, f.name)), f.name
    tiled = FleetArrays(**{k: v.repeat(S, *([1] * (v.dim() - 1))) for k, v in vars(fleet).items()})
    out = sim.planner._step_impl(tiled, inp, scenarios=S)
    np.testing.assert_array_equal(out.qp_converged.reshape(S, A).numpy(), z["converged"])
