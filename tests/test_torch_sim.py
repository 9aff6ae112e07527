"""The port's simulator (MultiSyncSimulator on the CPU, plain torch
paths) against the JAX package's: checkpoint-forced single steps,
a whole mission with the JAX audit, checkpoint resume, and the CLI."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu.config import Param as ParamJ
from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator as SimJ
from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.config import Param as ParamT
from lsc_dr_planner_tpu_torch.sim import run as run_t
from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator as SimT

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
K_STEPS = 5


def _one_step(sim):
    if sim.planner_seq > 0:
        sim.do_step()
    sim.decentralized_mapp()
    assert sim.plan()


def _state(sim):
    return {k: np.array(getattr(sim, k)) for k in (
        "pos", "next_waypoint", "sfc_lo", "sfc_hi", "qp_converged",
        "current_goal", "desired_ctrl")}


@pytest.fixture(scope="module")
def forced_steps(tmp_path_factory):
    """A JAX run of an 8-agent forest mission, checkpointed before each of
    K_STEPS steps; from every checkpoint, one step of a fresh JAX replica
    and one of the port. Returns [(jax state, port state)]."""
    tmp = tmp_path_factory.mktemp("forced")
    m = workload.forest_mission(8, 0)
    base_j = SimJ(ParamJ(multisim_save_result=False), m, log_dir=str(tmp))
    base_t = SimT(ParamT(multisim_save_result=False), m, log_dir=str(tmp), device="cpu")
    _one_step(base_j)
    out = []
    for k in range(K_STEPS):
        ck = str(tmp / f"ck{k}.npz")
        base_j.save_checkpoint(ck)
        # both sides start from the checkpoint (empty per-step MAPF memo)
        sj = SimJ(base_j.param, m, log_dir=str(tmp), share_static_from=base_j)
        st = SimT(base_t.param, m, log_dir=str(tmp), share_static_from=base_t)
        sj.load_checkpoint(ck)
        st.load_checkpoint(ck)
        assert st.planner_seq == sj.planner_seq == k + 1
        _one_step(sj)
        _one_step(st)
        out.append((_state(sj), _state(st)))
        _one_step(base_j)
    return out


@pytest.mark.parametrize("k", range(K_STEPS))
def test_checkpoint_forced_step_matches_jax(forced_steps, k):
    sj, st = forced_steps[k]
    # host numpy from identical state: identical
    np.testing.assert_array_equal(st["pos"], sj["pos"])
    np.testing.assert_array_equal(st["next_waypoint"], sj["next_waypoint"])
    # integer corridor boxes and the convergence flags: identical, as in
    # tests/test_torch_pipeline.py
    np.testing.assert_array_equal(st["sfc_lo"], sj["sfc_lo"])
    np.testing.assert_array_equal(st["sfc_hi"], sj["sfc_hi"])
    np.testing.assert_array_equal(st["qp_converged"], sj["qp_converged"])
    # the goal LP is closed-form: only float rounding separates them
    np.testing.assert_allclose(st["current_goal"], sj["current_goal"], rtol=0, atol=1e-4)
    # ADMM iterates stop at slightly different ε-optimal points (the
    # pipeline's tolerance, tests/test_torch_pipeline.py)
    conv = sj["qp_converged"]
    assert conv.all()
    assert np.abs(st["desired_ctrl"] - sj["desired_ctrl"])[conv].max() < 0.1


def _audit_ok(r):
    assert not r["is_collided"] and not r["qp_failed"]
    assert r["safety_ratio_agent"] >= 1.0
    assert r["vel_excess_ratio"] == 0.0 and r["acc_excess_ratio"] == 0.0
    assert np.isfinite(r["total_flight_time"])


@pytest.mark.parametrize("n, seed", [(5, 0), (5, 2)])
def test_whole_mission_matches_jax_audit(tmp_path, n, seed):
    """The port flies a forest mission to its goals with the JAX audit,
    within 10% of the JAX flight time. Measured on the CPU: 12.2 s for
    both at seed 0; 10.2 s (port) against 10.6 s (JAX) at seed 2, a 3.8%
    gap from float32 rounding in the ADMM iterates."""
    m = workload.forest_mission(n, seed)
    rj = SimJ(ParamJ(multisim_save_result=False), m, log_dir=str(tmp_path)).run(
        max_iterations=300)
    st = SimT(ParamT(multisim_save_result=False), m, log_dir=str(tmp_path), device="cpu")
    assert st.mapf_backend == "native"
    rt = st.run(max_iterations=300)
    assert st.step_time.N == len(st.qp_converged_share) == st.planner_seq
    _audit_ok(rj)
    _audit_ok(rt)
    assert abs(rt["total_flight_time"] - rj["total_flight_time"]) <= 0.1 * rj["total_flight_time"]
    # every agent at its goal
    d = np.linalg.norm(st.pos - st.desired_goal, axis=-1)
    assert (d <= st.param.goal_threshold).all()


def _drive(sim, start, stop):
    for it in range(start, stop):
        if it > 0:
            sim.do_step()
        sim.decentralized_mapp()
        assert sim.plan()


def test_checkpoint_resume_bit_identical(tmp_path):
    """A port run resumed from its own checkpoint continues exactly like
    the uninterrupted run (as tests/test_aux.py holds the JAX package)."""
    from lsc_dr_planner_tpu_torch.mission import generate_random_mission

    m = generate_random_mission(4, [-3, -3, 0], [3, 3, 2.5], seed=3,
                                min_separation=1.2)
    m.world_boxes = np.array([[0.0, 1.2, 1.25, 0.5, 0.5, 2.5]])
    m.world_file_name = "mini.csv"
    p = ParamT(world_use_octomap=True, qp_max_iter=120)

    ref = SimT(p, m, log_dir=str(tmp_path), device="cpu")
    _drive(ref, 0, 16)
    half = SimT(p, m, log_dir=str(tmp_path), device="cpu")
    _drive(half, 0, 8)
    ck = str(tmp_path / "ck.npz")
    half.save_checkpoint(ck)
    res = SimT(p, m, log_dir=str(tmp_path), device="cpu")
    res.load_checkpoint(ck)
    assert res.planner_seq == half.planner_seq
    _drive(res, 8, 16)

    np.testing.assert_array_equal(res.pos, ref.pos)
    np.testing.assert_array_equal(res.prev_ctrl, ref.prev_ctrl)
    np.testing.assert_array_equal(res.current_goal, ref.current_goal)
    np.testing.assert_array_equal(res.next_waypoint, ref.next_waypoint)
    assert res.sim_time == ref.sim_time
    assert res.safety_ratio_agent == ref.safety_ratio_agent


def test_jax_checkpoint_loads_without_jax(tmp_path):
    """A checkpoint written by the JAX simulator loads into the port's in
    a process that never imports jax."""
    m = workload.forest_mission(4, 1)
    sj = SimJ(ParamJ(multisim_save_result=False), m, log_dir=str(tmp_path))
    _drive(sj, 0, 3)
    ck = str(tmp_path / "jax.npz")
    sj.save_checkpoint(ck)
    code = (
        "import sys, json, numpy as np\n"
        "from lsc_dr_planner_tpu_torch import workload\n"
        "from lsc_dr_planner_tpu_torch.config import Param\n"
        "from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator\n"
        "m = workload.forest_mission(4, 1)\n"
        f"sim = MultiSyncSimulator(Param(multisim_save_result=False), m, log_dir={str(tmp_path)!r})\n"
        f"sim.load_checkpoint({ck!r})\n"
        "sim.do_step(); sim.decentralized_mapp(); assert sim.plan()\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'lsc_dr_planner_tpu')]\n"
        "print(json.dumps({'seq': sim.planner_seq, 'n_plan': sim.planning_time.total_planning_time.N,\n"
        "                  'timing': type(sim.planning_time).__module__, 'bad': bad}))\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["seq"] == sj.planner_seq + 1
    assert got["n_plan"] == sj.planning_time.total_planning_time.N + 1
    assert got["timing"] == "lsc_dr_planner_tpu_torch.utils.timing"


def _write_mission(tmp_path, n=3, seed=4):
    m = workload.forest_mission(n, seed)
    mpath, wpath = str(tmp_path / "m.json"), str(tmp_path / "w.csv")
    m.save(mpath)
    np.savetxt(wpath, m.world_boxes, delimiter=",")
    return mpath, wpath


def test_cli_flies_a_mission_on_cpu(tmp_path, capsys):
    mpath, wpath = _write_mission(tmp_path)
    results = run_t.main(["--mission", mpath, "--world", wpath, "--device", "cpu",
                          "--log-dir", str(tmp_path / "log"), "--max-iter", "300"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["mission"] == "m.json"
    assert printed == json.loads(json.dumps(results[0]))
    _audit_ok(printed)
    assert printed["mapf_backend"] == "native"
    # run()'s own per-iteration wall times and converged-QP shares
    assert 0 < printed["step_time_p50_ms"] <= printed["step_time_p99_ms"]
    assert printed["qp_converged_mean"] > 0.9


def test_cli_device_and_unported_options_raise(tmp_path):
    mpath, wpath = _write_mission(tmp_path)
    argv = ["--mission", mpath, "--world", wpath, "--log-dir", str(tmp_path / "log")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_t.main(argv + ["--device", "cuda"])
    with pytest.raises(NotImplementedError, match="item 16"):
        run_t.main(argv + ["--device", "cpu", "--debug-frames", "5"])
    with pytest.raises(NotImplementedError, match="item 12"):
        run_t.main(argv + ["--device", "cpu", "--no-global-map"])
    # options that only unported modules would read are not accepted
    for opt in ("--sensor-range", "--obs-noise", "--frames-dir"):
        with pytest.raises(SystemExit):
            run_t.main(argv + ["--device", "cpu", opt, "1"])
