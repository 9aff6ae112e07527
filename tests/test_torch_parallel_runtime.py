"""The port's multi-device runtime in spawned gloo ranks on the CPU: the
Monte-Carlo scenario split against the unsharded run (the mirror of
tests/test_montecarlo.py::test_montecarlo_sharded_scenarios), the
scaling harness and the dry run (tests/test_parallel.py's harness test,
`__graft_entry__.dryrun_multichip`)."""

import json

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu_torch.config import Param
from lsc_dr_planner_tpu_torch.mission import generate_random_mission
from lsc_dr_planner_tpu_torch.parallel import mesh, testing
from lsc_dr_planner_tpu_torch.sim.montecarlo import MonteCarloSimulator

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)


def _spawn(tmp_path, n, case):
    (tmp_path / "case.json").write_text(json.dumps(case))
    torch.multiprocessing.spawn(testing.run_case, args=(n, str(tmp_path)), nprocs=n)
    return dict(np.load(tmp_path / "out.npz"))


def test_montecarlo_split_scenarios(tmp_path):
    """8 scenarios split over 2 ranks give the unsharded run's per-scenario
    results: each rank's QP batch exits on its own, so, as the JAX test
    allows for its sharded run, positions agree within 0.02 m after 8
    iterations, with the same collisions."""
    mission = dict(n_agents=3, world_min=[-3, -3, 0], world_max=[3, 3, 2.5], seed=2,
                   min_separation=1.5)
    param = dict(world_use_octomap=False, multisim_max_planner_iteration=40, qp_max_iter=60)
    mc_kw = dict(n_scenarios=8, max_noise=0.2)
    m = generate_random_mission(**mission)
    ref = MonteCarloSimulator(Param(**param), m, log_dir=str(tmp_path), device="cpu",
                              host_workers=1, **mc_kw)
    r_ref = ref.run(max_iterations=8)
    out = _spawn(tmp_path, 2, {"kind": "montecarlo", "mission": mission, "param": param,
                               "montecarlo": mc_kw, "iterations": 8})
    for s, sim in enumerate(ref.sims):
        np.testing.assert_allclose(out["pos"][s], sim.pos, atol=0.02)
    assert out["is_collided"].tolist() == [r["is_collided"] for r in r_ref]


def test_scaling_harness_smoke(tmp_path):
    """measure_scaling in a 2-rank group: a row for 1 and for 2 devices,
    each with a positive rate (no speed claim on a shared CPU); a row
    larger than the group is skipped."""
    out = _spawn(tmp_path, 2, {"kind": "scaling", "scaling": dict(
        device_counts=(1, 2, 4), A_per_device=2, steps=2)})
    rows = json.loads(str(out["rows"]))
    assert [(r["devices"], r["agents"]) for r in rows] == [(1, 2), (2, 4)]
    for r in rows:
        assert r["steps_per_s"] > 0 and r["agent_steps_per_s"] == pytest.approx(
            r["agents"] * r["steps_per_s"])
    assert rows[0]["efficiency"] == 1.0


def test_dryrun_multichip(tmp_path):
    """One all-gather and one halo step over 2 ranks, shapes checked."""
    mesh.dryrun_multichip(2, device="cpu", init_method=f"file://{tmp_path}/init")


def test_init_group_backend_from_device(tmp_path, monkeypatch):
    """The backend follows the device: gloo for the CPU, NCCL for a card
    (no fallback); "cuda" without a card raises before any group forms."""
    seen = {}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    mesh.init_group("cpu", 0, 1, f"file://{tmp_path}/init")
    assert seen["backend"] == "gloo" and seen["world_size"] == 1
    if not torch.cuda.is_available():
        seen.clear()
        with pytest.raises(RuntimeError, match="cuda"):
            mesh.init_group("cuda", 0, 1, f"file://{tmp_path}/init")
        assert seen == {}


def test_multichip_check_on_cpu(tmp_path):
    """multichip_check.py's ranks on the CPU (gloo, 2 ranks, A=16): rank
    0's state broadcast to the others, both sharded steps held to the
    same blocks planned without the group (exactly, here) and to the
    whole fleet's step, the scaling rows; it imports no jax."""
    import ast
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    tree = ast.parse((root / "multichip_check.py").read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not roots & {"jax", "jaxlib", "lsc_dr_planner_tpu"}, roots
    sys.path.insert(0, str(root))
    try:
        import multichip_check
    finally:
        sys.path.remove(str(root))
    res = multichip_check.run(2, 16, "cpu", tmp_path / "multichip.json", warmup=1, reps=1)
    assert res["backend"] == "gloo" and res["ranks"] == 2
    for name in ("allgather", "halo"):
        assert res[name]["converged"][1] == 16, res[name]
        assert res[name]["max_diff_fleet"]["sfc_lo"] == 0.0
        assert res[name]["max_diff_block"]["desired_ctrl"] == 0.0
    assert [r["devices"] for r in res["weak"]] == [1, 2]
    assert [r["agents"] for r in res["strong"]] == [16, 16]
