"""The CUDA QP-preparation kernel (csrc/qp_prepare.cu, ops/qp_prepare_cuda.py)
against the plain body `qp._prepare_plain`, on the card.

These tests need a CUDA device and nvcc; without them they skip. They
import neither jax nor the JAX package, so on the GPU machine they run
with `python -m pytest --noconftest -m cuda tests/test_torch_qp_prepare_kernel.py`
(tests/conftest.py imports jax). The contract is `chip_smoke.py`'s
`prepare_check`: the elementwise outputs and copies equal, element for
element; each sum within `qp_check.prepare_tolerances`; per agent, Kinv's
distance from the float64 inverse of the kernel's own KKT matrix at most
twice the plain body's float32 Kinv's from the inverse of its own (or
1e-5); info 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.config import GoalMode, PlannerMode
from lsc_dr_planner_tpu_torch.ops import qp, qp_check, qp_prepare_cuda

pytestmark = pytest.mark.cuda

# fleet layouts (build_fleet overrides) whose QPs take the kernel's shapes
LAYOUTS = {
    "2d": {},  # LSC-DR 2-D: dim·K 56, comm rows
    "3d": dict(world_dimension=3),  # dim·K 84
    "no_comm": dict(planner_mode=PlannerMode.BVC, goal_mode=GoalMode.STATIC,
                    communication_range=-1.0),  # dim·K 60, no comm rows
    "3d_dk90": dict(world_dimension=3, planner_mode=PlannerMode.DLSC),  # dim·K 90, padded to 96
    # dim·K 246 (31 tile rows): the global build, the tiles in the workspace
    "3d_M28": dict(world_dimension=3, M=28),
}


def _global_min_layout():
    """The layout (3-D, the shortest horizon M) whose QP is the smallest
    that takes the global build."""
    for M in range(17, 29):
        cfg = _fleet_cfg(M)
        ts = qp.torch_statics(cfg, torch.device("cuda"))
        if qp_prepare_cuda.build_name(3, cfg.n_obs, M, cfg.N, ts["K"]) == \
                qp_prepare_cuda.GLOBAL_BUILD:
            return dict(world_dimension=3, M=M)
    raise AssertionError("no horizon up to M = 28 takes the global build")


def _fleet_cfg(M):
    return workload.build_fleet(37, device="cuda", world_dimension=3, M=M)[1].qp_cfg


def _fleet_qp(A, **overrides):
    p, planner, fleet, inp = workload.build_fleet(A, device="cuda", **overrides)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(3):
        inp, _ = step(inp)
    return planner.qp_cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp, planner.feas_tol


def _take(inp, sl):
    return qp.QPInputs(**{f.name: None if getattr(inp, f.name) is None
                          else getattr(inp, f.name)[sl] for f in dataclasses.fields(inp)})


def _tile(inp, times):
    return qp.QPInputs(**{f.name: None if getattr(inp, f.name) is None
                          else getattr(inp, f.name).repeat(times, *[1] * (getattr(
                              inp, f.name).dim() - 1)) for f in dataclasses.fields(inp)})


@pytest.fixture(scope="module")
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module",
                params=["2d", "3d", "no_comm", "3d_dk90", "O9", "A1", "A133", "A8192",
                        "3d_M28", "global_min"])
def case_qp(request, cuda_dev):
    """The QP of a fleet after 3 evolving steps: a ragged 2-D fleet (A=37),
    3-D (dim·K 84), comm rows off, DLSC 3-D (dim·K 90), 10 agents (O = 9
    slots), one agent of the 2-D fleet, 133 agents (one an SM of the
    H100's 132, and one more), the 1024-agent fleet's QP eight times
    over (A = 8,192, mc_pod_bench's batch), and the global build's: 3-D
    at M = 28 (dim·K 246) and at the shortest horizon that takes it."""
    name = request.param
    if name in LAYOUTS:
        return _fleet_qp(37, **LAYOUTS[name])
    if name == "global_min":
        return _fleet_qp(37, **_global_min_layout())
    if name == "O9":
        return _fleet_qp(10)
    if name == "A133":
        return _fleet_qp(133)
    if name == "A1":
        cfg, inp, tol = _fleet_qp(37)
        return cfg, _take(inp, slice(5, 6)), tol
    cfg, inp, tol = _fleet_qp(1024)
    return cfg, _tile(inp, 8), tol


def test_kernel_matches_plain_body(case_qp):
    cfg, inp, _ = case_qp
    ts = qp.torch_statics(cfg, inp.p0.device)
    A, dk = inp.p0.shape[0], cfg.dim * ts["K"]
    name = qp_prepare_cuda.build_name(cfg.dim, cfg.n_obs, cfg.M, cfg.N, ts["K"])
    assert (name == qp_prepare_cuda.GLOBAL_BUILD) == (dk > 200), (name, dk)
    got = qp.prepare(cfg, inp)
    want = qp.prepare(cfg, inp, plain=True)
    rec = qp_check.prepare_agreement(cfg, inp, got, want)
    assert all(n == 0 for n in rec["differing"].values()), rec
    assert all(n == 0 for n in rec["vacuous_differing"].values()), rec
    assert all(s <= 1.0 for s in rec["share_of_tolerance"].values()), rec
    assert int(got.info.abs().sum()) == 0
    kmat = torch.empty(A, dk, dk, dtype=torch.float64, device=inp.p0.device)
    out = qp_prepare_cuda.prepare_cuda(cfg, ts, inp, qp.prepare_scalars(cfg), kmat=kmat)
    assert torch.equal(out["Kinv"], got.loop.Kinv)
    d_kernel = qp_check.kinv_distance(out["Kinv"], kmat)
    d_plain = qp_check.kinv_distance(want.loop.Kinv, qp.kkt_matrix(cfg, inp)[0])
    assert (d_kernel <= torch.clamp(2 * d_plain, min=1e-5)).all(), (d_kernel.max(), d_plain)
    assert got.loop.kernel_rows_marked() and got.loop.take(torch.tensor([0])).kernel_rows_marked()


@pytest.mark.parametrize("layout", ["2d", "3d", "3d_M28"])
def test_kinv_symmetric_and_an_indefinite_agent_alone(cuda_dev, layout):
    """Kinv is exactly symmetric. An agent whose KKT matrix is made
    indefinite (its 5th segment's terminal weight -1e5) gets info > 0
    and an all-NaN Kinv, nothing raises, and every output of the other
    agents is the same, bit for bit, as in the batch without it."""
    cfg, inp, _ = _fleet_qp(37, **LAYOUTS[layout])
    ts = qp.torch_statics(cfg, cuda_dev)
    sc = qp.prepare_scalars(cfg)
    good = qp_prepare_cuda.prepare_cuda(cfg, ts, inp, sc)
    assert torch.equal(good["Kinv"], good["Kinv"].transpose(1, 2))
    assert int(good["info"].abs().sum()) == 0
    tmask = inp.terminal_mask.clone()
    tmask[5, 4] = -1e5
    bad = qp_prepare_cuda.prepare_cuda(cfg, ts, dataclasses.replace(inp, terminal_mask=tmask), sc)
    torch.cuda.synchronize()
    assert int(bad["info"][5]) > 0 and bad["Kinv"][5].isnan().all()
    others = torch.arange(inp.p0.shape[0], device=cuda_dev) != 5
    for name in qp_prepare_cuda.OUTPUTS:
        assert torch.equal(bad[name][others], good[name][others]), name


def test_cpu_tensors_and_large_dk_raise(cuda_dev):
    """The kernel's entry refuses CPU tensors and a world of 4 dimensions
    (dim·K 112; any dim·K of 2 or 3 dimensions has a build, see
    tests/test_torch_cuda.py's WIDE shapes), before it launches."""
    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(_fleet_qp(4)[0], dim=4)
    ts = qp.torch_statics(cfg, cuda_dev)
    A, dim, O, M, N, R = 2, 4, cfg.n_obs, cfg.M, cfg.N, qp.n_rows(cfg)

    def rnd(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=cuda_dev)

    inp = qp.QPInputs(p0=rnd(A, dim), v0=rnd(A, dim), a0=rnd(A, dim), goal=rnd(A, dim),
                      terminal_mask=torch.ones(A, M, device=cuda_dev), lsc_normals=rnd(A, O, M, dim),
                      lsc_rhs=rnd(A, O, M, N),
                      lsc_active=torch.ones(A, O, M, N, dtype=torch.bool, device=cuda_dev),
                      vmax=rnd(A, dim).abs(), amax=rnd(A, dim).abs(), lb=rnd(A, dim, M, N) - 5,
                      ub=rnd(A, dim, M, N) + 5, comm_halfrange=torch.ones(A, device=cuda_dev),
                      x0=rnd(A, dim, M, N), y0=rnd(A, R))
    before = qp_prepare_cuda.launches
    with pytest.raises(ValueError, match="dim 2 or 3"):
        qp.prepare(cfg, inp)
    cpu = qp.QPInputs(**{f.name: getattr(inp, f.name).cpu() for f in dataclasses.fields(inp)})
    with pytest.raises(ValueError, match="CUDA tensors"):
        qp_prepare_cuda.prepare_cuda(cfg, qp.torch_statics(cfg, torch.device("cpu")), cpu,
                                     qp.prepare_scalars(cfg))
    assert qp_prepare_cuda.launches == before


def test_workspace_choice_mirrors_the_library(cuda_dev):
    """`qp_prepare_cuda.tiles_in_workspace` (pure Python, the CPU tests'
    choice of the global build) agrees with the library at every 3-D
    horizon from M = 10 to 30 and with 4 to 480 slots, and on the card's
    opt-in limit; the global build is GLOBAL_BUILD."""
    lib = qp_prepare_cuda.build()
    for M in range(10, 31):
        cfg = qp.QPConfig(dim=3, M=M, n=5, phi=3, n_obs=4, use_comm=True, stop_at_horizon=True,
                          dt=0.2, control_input_weight=0.01, terminal_weight=1.0, rho=1.0,
                          sigma=1e-6, alpha=1.6, max_iter=200, eps_abs=1e-3, rescue_iter=800)
        K = qp.torch_statics(cfg, cuda_dev)["K"]
        for O in (4, 36, 160, 480):
            work = lib.qp_prepare_work_doubles(3, O, M, 6, K) > 0
            assert work == qp_prepare_cuda.tiles_in_workspace(3, O, M, 6, K), (M, O, K)
            assert (qp_prepare_cuda.build_name(3, O, M, 6, K) == qp_prepare_cuda.GLOBAL_BUILD) \
                == work


@pytest.mark.parametrize("A", [37, 72])
def test_solve_does_not_synchronise(cuda_dev, A):
    """qp.solve on the card reads nothing back to the host: under
    torch.cuda.set_sync_debug_mode("error") a synchronising call raises.
    A=37 takes the in-place rescue, A=72 the compacted one. The first
    solve builds the kernels and the statics' tensors (host copies)."""
    cfg, inp, tol = _fleet_qp(A)
    qp.reset_counts()
    launches = qp_prepare_cuda.launches
    want = qp.solve(cfg, inp, tol)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = qp.solve(cfg, inp, tol)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(got.x, want.x) and torch.equal(got.converged, want.converged)
    assert qp_prepare_cuda.launches == launches + 2 and qp.plain_cuda_calls == 0
    qp.prepare(cfg, inp, plain=True)
    assert qp.plain_cuda_calls == 1
