"""The port's tools (lsc_dr_planner_tpu_torch/tools/) against the JAX
package's tools/ of the same name: the mission generators bit for bit,
sfc_bench's boxes against the JAX package's fused SFC update, and
qp_forensics's rows against the JAX pipeline's on the same states; then
each tool's command line on the CPU at a tiny size (the JAX tool's row
keys), and without `--device cpu` (no card here: it raises)."""

import functools
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from lsc_dr_planner_tpu.ops import sfc as sfc_j
from lsc_dr_planner_tpu.planner import pipeline as pipe_j
from lsc_dr_planner_tpu.world.grid import build_grid_world as build_j
from lsc_dr_planner_tpu_torch import convert, workload
from lsc_dr_planner_tpu_torch.ops import sfc
from lsc_dr_planner_tpu_torch.tools import (
    dlsc_openworld, fuzz_missions, mc_pod_bench, qp_forensics, scale_demo, sfc_bench,
)
from lsc_dr_planner_tpu_torch.world.grid import build_grid_world
from test_torch_host import _assert_same_mission
from tools import dlsc_openworld as dlsc_openworld_j
from tools import fuzz_missions as fuzz_missions_j

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)


# ---- mission generators --------------------------------------------------
def _fuzz_draws(mod, seed, A=None):
    """The draws of the fuzz harness's run_case for one seed, through
    `mod`'s random_world and make_mission: (A, kind, boxes, mission)."""
    rng = np.random.default_rng(seed)
    A = A if A is not None else int(rng.integers(8, 33))
    kind = "forest" if rng.random() < 0.5 else "maze"
    half = max(4.0, 1.3 * np.sqrt(A) + (2.0 if kind == "maze" else 0.0))
    for _try in range(20):
        boxes = mod.random_world(rng, kind, half)
        mission = mod.make_mission(rng, A, boxes, half)
        if mission is not None:
            break
    return A, kind, boxes, mission


# seeds 1000 and 1007 draw maze worlds, 1001 and 1004 forests
@pytest.mark.parametrize("seed, A", [(2001, 8), (2002, 8), (2003, 8), (1000, None),
                                     (1001, None), (1004, None), (1007, None)])
def test_fuzz_missions_match_jax(seed, A):
    a = _fuzz_draws(fuzz_missions, seed, A)
    b = _fuzz_draws(fuzz_missions_j, seed, A)
    assert a[:2] == b[:2]
    np.testing.assert_array_equal(a[2], b[2])
    assert b[3] is not None
    _assert_same_mission(a[3], b[3])
    # run_case's own draws are these
    A_t, kind, mission = fuzz_missions.case_mission(seed, A)
    assert (A_t, kind) == a[:2]
    _assert_same_mission(mission, b[3])


def test_fuzz_seeds_cover_both_world_kinds():
    kinds = {_fuzz_draws(fuzz_missions, s)[1] for s in (1000, 1001, 1004, 1007)}
    assert kinds == {"forest", "maze"}


@pytest.mark.parametrize("A", [8, 16, 24])
def test_circle_mission_matches_jax(A):
    args = (A, 0.22 * A + 1.8)
    _assert_same_mission(dlsc_openworld.circle_mission(*args, seed=A),
                         dlsc_openworld_j.circle_mission(*args, seed=A))


def test_dlsc_cases_match_jax():
    got = dlsc_openworld.cases()
    assert [n for n, _ in got] == ["circle8", "circle16", "circle24", "swap10_s0",
                                   "swap14_s1", "swap18_s2", "swap22_s3"]
    for (name, m), s in zip(got[3:], range(4)):
        A = 10 + 4 * s
        _assert_same_mission(
            m, dlsc_openworld_j.random_swap_mission(A, 1.1 * np.sqrt(A) + 2.0, seed=100 + s))


# ---- sfc_bench -----------------------------------------------------------
@pytest.mark.parametrize("clamp", [30, 70])
def test_sfc_bench_boxes_match_jax(clamp):
    """The timed call's boxes equal the JAX package's update_sfc_fused on
    the same world and inputs (both calls: the initialization, then the
    hull update), and the counters hold the trips and syncs the lanes
    need."""
    rng = np.random.default_rng(0)
    trees, wmin, wmax = sfc_bench.bench_trees(rng)
    gw = build_grid_world(trees, wmin, wmax, sfc_bench.RESOLUTION, sfc_bench.INFLATION, "cpu")
    gw_j = build_j(trees, wmin, wmax, sfc_bench.RESOLUTION, sfc_bench.INFLATION)
    np.testing.assert_array_equal(gw.blocked_cumsum.numpy(), np.asarray(gw_j.blocked_cumsum))
    pos, goal = sfc_bench.bench_agents(rng, 8)
    A, M = len(pos), sfc_bench.M

    @functools.partial(jax.jit, static_argnums=0)
    def update_j(done, lo, hi):
        ctrl = jnp.zeros((A, M, 6, 3), jnp.float32)
        f = functools.partial(sfc_j.update_sfc_fused, gw_j, "hull",
                              margin=sfc_bench.MARGIN, max_radius_cells=clamp)
        return jax.vmap(lambda lo, hi, p, g, c: f(lo, hi, done, p, g, g, p, c))(
            lo, hi, jnp.asarray(pos), jnp.asarray(goal), ctrl)[:2]

    zero = jnp.zeros((A, M, 3), jnp.int32)
    init_lo, init_hi = update_j(False, zero, zero)
    want_lo, want_hi = update_j(True, init_lo, init_hi)

    fn = sfc_bench.sfc_call(gw, pos, goal, clamp)
    sfc.reset_counts()
    lo, hi = fn()
    np.testing.assert_array_equal(lo.numpy(), np.asarray(want_lo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(want_hi))

    live = sfc_bench.lane_trips(*sfc.last_lanes)
    assert len(live) == 3 * A and int(live.max()) > 0
    max_trips = 6 * clamp + 6
    assert 0 < sfc.trips <= max_trips
    # the loop stops at the first exit check after its longest lane
    assert sfc.trips == min(8 * math.ceil(int(live.max()) / 8), max_trips)
    assert sfc.syncs == math.ceil(min(sfc.trips + 1, max_trips) / 8)


# ---- qp_forensics --------------------------------------------------------
def test_qp_forensics_rows_match_jax():
    """The rows of A=16 over 2 steps, each package planning from the same
    state (the JAX plan's): convergence and the unconverged count equal,
    the iteration percentiles within one 8-iteration exit chunk."""
    A, steps = 16, 2
    pj, plan_j, fleet_j, inp_j = bench.build_fleet(A)
    p, plan_t, _, _ = workload.build_fleet(A, device="cpu")
    fleet_t = convert.fleet_from_numpy(fleet_j._asdict(), "cpu")
    for k in range(steps):
        inp_t = convert.inputs_from_numpy(inp_j._asdict(), "cpu")
        out_j = plan_j.step(fleet_j, inp_j)
        out_t = plan_t.step(fleet_t, inp_t)
        want = qp_forensics.step_row(k, np.asarray(out_j.qp_residual),
                                     np.asarray(out_j.qp_iterations),
                                     np.asarray(out_j.qp_converged))
        got = qp_forensics.step_row(k, *qp_forensics.host(out_t))
        assert got.keys() == want.keys()
        assert (got["conv_rate"], got["n_bad"]) == (want["conv_rate"], want["n_bad"])
        for key in ("iters_p50", "iters_max"):
            assert abs(got[key] - want[key]) <= 8, (k, key, got, want)
        out = types.SimpleNamespace(**{f: torch.as_tensor(np.array(getattr(out_j, f))) for f in (
            "desired_ctrl", "current_goal", "sfc_lo", "sfc_hi", "sfc_initialized", "qp_y")})
        nxt = workload.advance(p, inp_t, out)
        inp_j = pipe_j.StepInputs(**{f: (v if v is None or isinstance(v, int)
                                         else jnp.asarray(v.numpy()))
                                     for f, v in vars(nxt).items()})


def test_qp_forensics_overrides():
    got = qp_forensics.parse_overrides(["planner_mode=dlsc", "multisim_time_step=0.1",
                                        "world_use_octomap=false", "qp_max_iter=400"])
    from lsc_dr_planner_tpu_torch.config import PlannerMode

    assert got == dict(planner_mode=PlannerMode.DLSC, multisim_time_step=0.1,
                       world_use_octomap=False, qp_max_iter=400)
    with pytest.raises(ValueError):
        qp_forensics.parse_overrides(["no_such_field=1"])


# ---- each tool's command line ----------------------------------------------
# (module, argv at a tiny size, the JAX tool's row keys, its `platform` key
# now `device`)
SIM_KEYS = {"total_flight_time", "safety_ratio_agent", "vel_excess_ratio",
            "acc_excess_ratio", "is_collided", "qp_failed", "planner_seq"}
TOOLS = {
    "sfc_bench": (sfc_bench, ["--sizes", "8", "--clamps", "30", "--reps", "1"],
                  {"A", "clamp", "sfc_ms", "per_agent_us"}),
    "qp_forensics": (qp_forensics, ["--A", "8", "--steps", "2"],
                     {"step", "conv_rate", "n_bad", "res_p50", "res_max", "iters_p50",
                      "iters_max"}),
    "mc_pod_bench": (mc_pod_bench, ["--A", "4", "--S", "2", "--steps", "1"],
                     {"A", "S", "steps", "built_s", "step_s", "agent_scenario_steps_per_s",
                      "qp_convergence_min", "qp_convergence_mean", "phases_s", "device"}),
    "scale_demo": (scale_demo, ["--agents", "3", "--max-iter", "3", "--smoke-agents", "4",
                                "--smoke-iter", "2"],
                   {"agents", "steps", "flight_time_s", "distance_m", "safety_ratio_agent",
                    "collided", "qp_failed", "step_ms_mean", "step_ms_p99", "wall_s",
                    "device"}),
    "dlsc_openworld": (dlsc_openworld, [],
                       SIM_KEYS | {"mission", "wall_s", "success", "git_commit", "device"}),
    "fuzz_missions": (fuzz_missions, ["--n", "1", "--seed0", "2001", "--layers", "hybrid",
                                      "--amin", "2", "--amax", "2"],
                      SIM_KEYS | {"seed", "layer", "A", "kind", "wall_s", "n_boxes", "clean",
                                  "device"}),
}


def _out_args(name, tmp_path):
    return {"scale_demo": ["--log-dir", str(tmp_path / "scale")],
            "dlsc_openworld": ["--out", str(tmp_path / "dlsc.jsonl")],
            "fuzz_missions": ["--out", str(tmp_path / "fuzz")]}.get(name, [])


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_main_on_cpu(name, tmp_path, monkeypatch, capsys):
    mod, argv, keys = TOOLS[name]
    if name == "dlsc_openworld":
        # one 2-agent swap in place of the seven missions
        monkeypatch.setattr(dlsc_openworld, "cases", lambda: [
            ("circle2", dlsc_openworld.circle_mission(2, 0.22 * 2 + 1.8, seed=2))])
    monkeypatch.chdir(tmp_path)  # the simulators' relative log directories
    argv = argv + _out_args(name, tmp_path) + ["--device", "cpu"]
    rows = mod.main(argv)
    assert rows and all(keys <= r.keys() for r in rows), rows
    assert all(r["device"] == "cpu" for r in rows if "device" in r)
    assert not any("platform" in r for r in rows)
    printed = capsys.readouterr().out
    if name in ("dlsc_openworld", "fuzz_missions"):
        # the rows went to the JSONL; a second run finds them and skips
        assert mod.main(argv) == []
        path = (tmp_path / "dlsc.jsonl" if name == "dlsc_openworld"
                else tmp_path / "fuzz" / "fuzz.jsonl")
        assert [json.loads(line) for line in path.read_text().splitlines()] == \
            json.loads(json.dumps(rows))
    else:
        assert [json.loads(line) for line in printed.splitlines()
                if line.startswith("{")][:len(rows)] == json.loads(json.dumps(rows))
    if name == "sfc_bench":
        (r,) = rows
        assert 0 < r["trips"] <= 6 * 30 + 6 and r["syncs"] == r["trips"] // 8 + 1
        assert r["bound_ms"] > 0 and r["launches_per_call"] is None  # no launch on the CPU
    if name == "mc_pod_bench":
        assert rows[0]["chunk_peak_bytes"] == []  # the card's peaks; none on the CPU


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_main_needs_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the tools run on it")
    mod, argv, _ = TOOLS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv + _out_args(name, tmp_path))
