"""The port's replay, debug stash, debug frames and trace_diff (CPU):
`read_csv` against the JAX package's on its CSVs and on a CSV the port's
simulator writes; the mirrors of tests/test_aux.py's replay and debug
frame tests; the debug stash against JAX's `_dbg` on the same inputs;
a CLI flight that writes debug frames; `trace_diff` on two CSVs that
diverge at a known row."""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from lsc_dr_planner_tpu.sim import replay as replay_j
from lsc_dr_planner_tpu_torch import convert, workload
from lsc_dr_planner_tpu_torch.config import Param
from lsc_dr_planner_tpu_torch.mission import generate_random_mission
from lsc_dr_planner_tpu_torch.planner.pipeline import FleetPlanner
from lsc_dr_planner_tpu_torch.sim import replay
from lsc_dr_planner_tpu_torch.sim import run as run_t
from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator
from lsc_dr_planner_tpu_torch.tools import trace_diff

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_CSVS = sorted((ROOT / "log" / "tpu_missions").glob("simulation_*.csv"))


@pytest.mark.parametrize("path", JAX_CSVS, ids=lambda p: p.name[:28])
def test_read_csv_jax_logs(path):
    """The port's reader on the JAX simulator's CSVs gives the JAX reader's
    arrays."""
    got, want = replay.read_csv(str(path)), replay_j.read_csv(str(path))
    assert got.qn == want.qn == 10 and got.on == want.on
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), f.name)
    st = replay.state_at(got, 0.5 * (got.times[0] + got.times[-1]))
    np.testing.assert_array_equal(st, replay_j.state_at(want, 0.5 * (want.times[0]
                                                                     + want.times[-1])))


def _flown(tmp_path, steps, save=True):
    m = workload.forest_mission(3, 4)
    p = Param(multisim_save_result=save, multisim_max_planner_iteration=steps)
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path), device="cpu")
    sim.run()
    return sim


def test_read_csv_port_simulation_roundtrip(tmp_path):
    """A CSV the port's simulator writes reads back as the positions the
    simulator recorded (to the CSV's six significant digits)."""
    sim = _flown(tmp_path, 8)
    (path,) = tmp_path.glob("simulation_*.csv")
    log = replay.read_csv(str(path))
    hist = np.stack(sim.traj_history)
    assert log.qn == sim.A and log.on == 0 and len(log.times) == len(hist)
    np.testing.assert_allclose(log.agent_states[:, :, :3], hist, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(log.agent_states[-1, :, :3], hist[-1], rtol=1e-5, atol=1e-6)
    assert np.all(np.diff(log.times) > 0)


def test_replay_roundtrip(tmp_path):
    """tests/test_aux.py's 2-agent, 1-obstacle CSV in the reference schema."""
    path = tmp_path / "simulation_test.csv"
    header = ",".join(["id,t,px,py,pz,vx,vy,vz,ax,ay,az,planning_time"] * 2
                      + ["obs_id,t,px,py,pz,size"])
    rows = []
    for k in range(5):
        t = 0.1 * k
        cols = []
        for qi in range(2):
            cols += [str(qi), f"{t}", f"{qi + t}", "0", "0.6",
                     "1", "0", "0", "0", "0", "0", "0.01"]
        cols += ["0", f"{t}", "3", "3", "0.6", "0.4"]
        rows.append(",".join(cols))
    path.write_text(header + "\n" + "\n".join(rows) + "\n")

    log = replay.read_csv(str(path))
    assert log.qn == 2 and log.on == 1
    st = replay.state_at(log, 0.25)
    np.testing.assert_allclose(st[0, 0], 0.25, atol=1e-9)
    np.testing.assert_allclose(st[1, 0], 1.25, atol=1e-9)
    assert len(list(replay.replay(log, rate_hz=20))) == 9
    png = replay.render_png(log, str(tmp_path / "out.png"))
    assert Path(png).stat().st_size > 0


def test_debug_stash_matches_jax():
    """`FleetPlanner.debug`: the port's `_dbg` against JAX's on the same
    inputs, key by key (every key is computed before the QP: integers and
    masks exactly, floats at rtol 1e-4 / atol 2e-4); with debug off the
    step keeps nothing."""
    A = 8
    planner_j, fleet_j, inp_j = graft._build(n_agents=A)
    rng = np.random.default_rng(5)
    inp_j = inp_j._replace(
        has_prev=jnp.asarray(rng.random(A) < 0.5),
        prev_ctrl=jnp.asarray(np.asarray(inp_j.prev_ctrl)
                              + rng.normal(0, 0.02, inp_j.prev_ctrl.shape), jnp.float32))
    planner_j.debug = True
    planner_j._step_impl(fleet_j, inp_j)
    dbg_j = planner_j._dbg

    keys = ("resolution", "world_min", "world_max", "origin_idx", "occ", "blocked_cumsum",
            "cell_ranges", "n_boxes", "radius")
    world = convert.grid_world_from_numpy({k: getattr(planner_j.world, k) for k in keys}, "cpu")
    planner = FleetPlanner(Param(max_obstacles=4, qp_max_iter=25), world, A,
                           agent_radius=0.15)
    fleet = convert.fleet_from_numpy(fleet_j._asdict(), "cpu")
    inp = convert.inputs_from_numpy(inp_j._asdict(), "cpu")
    planner._step_impl(fleet, inp)
    assert planner._dbg == {}
    planner.debug = True
    planner._step_impl(fleet, inp)
    dbg = planner._dbg
    assert set(dbg) == set(dbg_j) == {
        "ls", "obs_valid", "obs_pred", "sfc_lo_w", "sfc_hi_w", "new_goal", "initial_ctrl",
        "nd", "lb", "ub", "terminal_mask", "rhs", "active"}

    def leaves(key, v):
        if hasattr(v, "_asdict") or dataclasses.is_dataclass(v):
            fields = v._asdict() if hasattr(v, "_asdict") else vars(v)
            return {f"{key}.{k}": np.asarray(x) for k, x in fields.items()}
        return {key: np.asarray(v)}

    for key in dbg:
        got, want = leaves(key, dbg[key]), leaves(key, dbg_j[key])
        assert set(got) == set(want), key
        for name, a in got.items():
            b = np.asarray(want[name])
            if b.dtype == bool or np.issubdtype(b.dtype, np.integer):
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-4, err_msg=name)


def _three_steps(sim):
    for _ in range(3):
        if sim.planner_seq > 0:
            sim.do_step()
        sim.decentralized_mapp()
        assert sim.plan()


def test_debug_frame_render(tmp_path):
    """render_debug_frame draws SFC boxes, LSC half-planes, waypoints and
    grid paths, and comm groups from a live simulator without disturbing
    its state (tests/test_aux.py)."""
    m = generate_random_mission(4, [-3, -3, 0], [3, 3, 2.5], seed=3, min_separation=1.2)
    p = Param(world_use_octomap=False, multisim_max_planner_iteration=50, qp_max_iter=60)
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path), device="cpu")
    _three_steps(sim)
    before = (sim.planner_seq, sim.desired_goal.copy(), sim.current_goal.copy(),
              sim.desired_ctrl.copy())
    replay.render_debug_frame(sim, str(tmp_path / "dbg.png"))
    assert (tmp_path / "dbg.png").stat().st_size > 10000
    assert sim.planner_seq == before[0] and not sim.planner.debug
    np.testing.assert_array_equal(sim.desired_goal, before[1])
    np.testing.assert_array_equal(sim.current_goal, before[2])
    np.testing.assert_array_equal(sim.desired_ctrl, before[3])


def test_render_without_matplotlib_raises(tmp_path, monkeypatch):
    """On a host without matplotlib (the card's machine) rendering raises
    an ImportError that names it, before any planning step; the reader
    still works."""
    sim = MultiSyncSimulator(Param(world_use_octomap=False), generate_random_mission(
        2, [-3, -3, 0], [3, 3, 2.5], seed=3, min_separation=1.2), log_dir=str(tmp_path),
        device="cpu")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    seq = sim.planner_seq
    with pytest.raises(ImportError, match="matplotlib"):
        replay.render_debug_frame(sim, str(tmp_path / "x.png"))
    assert sim.planner_seq == seq and not (tmp_path / "x.png").exists()
    with pytest.raises(ImportError, match="matplotlib"):
        replay.render_png(replay.read_csv(str(JAX_CSVS[0])), str(tmp_path / "y.png"))


def test_cli_debug_frames(tmp_path, capsys):
    """`--debug-frames 2 --frames-dir`: a CLI flight on the CPU writes a
    frame every second planning step."""
    m = workload.forest_mission(3, 4)
    mpath, wpath = str(tmp_path / "m.json"), str(tmp_path / "w.csv")
    m.save(mpath)
    np.savetxt(wpath, m.world_boxes, delimiter=",")
    frames = tmp_path / "frames"
    run_t.main(["--mission", mpath, "--world", wpath, "--device", "cpu", "--max-iter", "6",
                "--log-dir", str(tmp_path / "log"), "--debug-frames", "2",
                "--frames-dir", str(frames)])
    capsys.readouterr()
    written = sorted(f.name for f in frames.glob("frame_*.png"))
    assert written == ["frame_0002.png", "frame_0004.png"], written
    assert all((frames / f).stat().st_size > 10000 for f in written)


def _csv(path, pos):
    """A wide simulation CSV of positions [T, A, 3] (0.1 s rows)."""
    T, A, _ = pos.shape
    header = ",".join(["id,t,px,py,pz,vx,vy,vz,ax,ay,az,planning_time"] * A)
    rows = [",".join(",".join([str(qi), f"{0.1 * t:.6g}", *(f"{x:.6g}" for x in pos[t, qi]),
                               *["0"] * 6, "0.01"]) for qi in range(A)) for t in range(T)]
    path.write_text(header + "\n" + "\n".join(rows) + "\n")
    return str(path)


def test_trace_diff_first_divergence(tmp_path, capsys):
    """Two runs equal up to row 7, where agent 2 moves 5 mm; then it
    grows. trace_diff reports row 7, t = 0.7 s, agent 2; identical logs
    report no divergence."""
    rng = np.random.default_rng(0)
    pos = np.cumsum(rng.normal(0, 0.05, (30, 4, 3)), axis=0)
    other = pos.copy()
    other[7:, 2, 0] += 0.005 * np.arange(1, 24)
    a, b = _csv(tmp_path / "a.csv", pos), _csv(tmp_path / "b.csv", other)
    div = trace_diff.main([a, b, "--tol", "1e-3"])
    assert div["row"] == 7 and div["agents"] == [2]
    assert div["t"] == pytest.approx(0.7) and div["max"] == pytest.approx(0.005, abs=1e-5)
    assert div["growth"][-1]["max"] == pytest.approx(0.115, abs=1e-4)
    out = capsys.readouterr().out
    assert "first divergence at row 7 (t=0.70s): agents [2]" in out
    assert trace_diff.main([a, a]) is None
    assert "identical" in capsys.readouterr().out
