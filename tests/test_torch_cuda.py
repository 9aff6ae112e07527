"""The CUDA ADMM kernel against the port's plain loop, on the card.

These tests need a CUDA device and nvcc; without them they skip. They
import neither jax nor the JAX package, so on the GPU machine they run
with `python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(tests/conftest.py imports jax).
"""

import dataclasses

import pytest
import torch

from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.config import GoalMode, PlannerMode
from lsc_dr_planner_tpu_torch.ops import qp, qp_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def fleet_qp():
    """A ragged bench fleet (A=37) after 3 evolving steps, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    p, planner, fleet, inp = workload.build_fleet(37, device="cuda")
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(3):
        inp, _ = step(inp)
    d = planner._step_impl(fleet, inp, defer_qp=True)
    return planner.qp_cfg, d.qp_inp, planner.feas_tol


def test_one_chunk_matches_plain_loop(fleet_qp):
    cfg, qp_inp, feas_tol = fleet_qp
    li = qp.prepare(cfg, qp_inp).loop
    before = qp_cuda.launches
    got = qp.run_loop(cfg, li, 8, feas_tol)
    torch.cuda.synchronize()
    assert qp_cuda.launches == before + 1
    want = qp.admm_loop_plain(cfg, li, 8, feas_tol)
    # one chunk: the same 8 iterations, sums in another order
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert (got[3] == want[3]).float().mean() >= 0.995
    assert int(got[4]) == int(want[4]) == 8


def test_global_exit_stops_the_loop(fleet_qp):
    """Many chunks. The fleet passes its exit tests before max_iter; the
    kernel's state is then the iterate of that test, not of a later one."""
    cfg, qp_inp, feas_tol = fleet_qp
    li = qp.prepare(cfg, qp_inp).loop
    got = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)
    stop = int(got[4])
    assert stop < cfg.max_iter, "this fleet should exit early"
    assert int(got[3].max()) <= stop
    # the launches after the exit change nothing: bitwise the same state
    again = qp.run_loop(cfg, li, stop, feas_tol)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    # the plain loop's iterate after `stop` iterations (feas_tol=0 turns
    # its exit tests off); sums in another order, as in one chunk
    want = qp.admm_loop_plain(cfg, li, stop, 0.0)
    assert int(want[4]) == stop
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_full_solve_contract(fleet_qp):
    cfg, qp_inp, feas_tol = fleet_qp
    out = qp.solve(cfg, qp_inp, feas_tol)
    ref = qp.solve(cfg, qp_inp, feas_tol, plain=True)
    assert out.converged.float().mean() >= ref.converged.float().mean() - 0.005
    both = out.converged & ref.converged
    assert out.primal_residual[out.converged].max() < feas_tol
    # objectives in float64: the float32 objective of agents far from the
    # origin carries ~1e-2 relative cancellation noise for identical x
    pr = qp.prepare(cfg, qp_inp)
    torch.testing.assert_close(qp.objective(cfg, pr, out.x.double())[both],
                               qp.objective(cfg, pr, ref.x.double())[both],
                               rtol=2e-2, atol=2e-2)
    assert (out.x - ref.x).abs()[both].max() < 0.1


def test_wrapper_rejects_bad_inputs(fleet_qp):
    cfg, qp_inp, feas_tol = fleet_qp
    li = qp.prepare(cfg, qp_inp).loop
    bad = dataclasses.replace(li)
    bad.z = li.z.double()
    with pytest.raises(ValueError):
        qp.run_loop(cfg, bad, 8, feas_tol)
    bad = dataclasses.replace(li)
    bad.Kinv = li.Kinv.transpose(1, 2)
    with pytest.raises(ValueError):
        qp.run_loop(cfg, bad, 8, feas_tol)
    bad = dataclasses.replace(li)
    bad.ln = li.ln[:, :-1]
    with pytest.raises(ValueError):
        qp.run_loop(cfg, bad, 8, feas_tol)
    # a stencil table of another row count than the rows' static block
    ts = qp.torch_statics(cfg, li.xi.device)
    short = {k: (v[:-1] if k in ("idx", "coef", "rho") else v) for k, v in ts["stencil"].items()}
    with pytest.raises(ValueError, match="R_stat"):
        qp_cuda.admm_loop_cuda(li, short, ts["N3k"], ts["N3kT"], cfg.rho * qp._RHO_SCALE["lsc"],
                               8, qp.CHUNK, 0.0, cfg.sigma, cfg.alpha, cfg.eps_abs)
    # a ρ or an LSC upper bound other than the ones the kernel assumes
    bad = dataclasses.replace(li, rho=li.rho * 2)
    with pytest.raises(ValueError, match="per family"):
        qp.run_loop(cfg, bad, 8, feas_tol)
    un = li.un.clone()
    un[:, 0] = 1.0
    with pytest.raises(ValueError, match="per family"):
        qp.run_loop(cfg, dataclasses.replace(li, un=un), 8, feas_tol)


def _per_agent_close(a, b):
    """|a − b| within rtol 1e-4 of the agent's largest |b| / atol 1e-5."""
    d, m = (a - b).abs().flatten(1), b.abs().flatten(1)
    return bool((d.amax(1) <= 1e-5 + 1e-4 * m.amax(1)).all())


def test_dk_above_96_raises():
    """dim·K > 96 is taken by no build of the kernel: a clear error that
    names the limit, no launch (M=12 in 3-D: K = 36, dim·K = 108)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cfg = qp.QPConfig(dim=3, M=12, n=5, phi=3, n_obs=4, use_comm=True, stop_at_horizon=False,
                      dt=0.2, control_input_weight=0.01, terminal_weight=1.0, rho=1.0,
                      sigma=1e-6, alpha=1.6, max_iter=16, eps_abs=1e-3)
    ts = qp.torch_statics(cfg, torch.device("cuda"))
    A, K, R = 2, ts["K"], qp.n_rows(cfg)
    assert 3 * K > 96
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=g)  # noqa: E731
    li = qp.LoopInputs(normals=rnd(A, cfg.n_obs, cfg.M, 3), Kinv=rnd(A, 3 * K, 3 * K),
                       Pn=rnd(A, K, K), qn=rnd(A, 3, K), ln=rnd(A, R),
                       un=torch.full((A, R), 1e20, device="cuda"),
                       rho=ts["kernel_rho"].expand(A, R), scale=torch.ones(A, R, device="cuda"),
                       xi=rnd(A, 3, K), z=rnd(A, R), y=rnd(A, R))
    before = qp_cuda.launches
    with pytest.raises(ValueError, match="<= 96"):
        qp.run_loop(cfg, li, cfg.max_iter, 5e-3)
    assert qp_cuda.launches == before


# The planner modes whose QPs take the kernel's other builds: dim·K 60
# (2-D BVC with static goals and no comm box: use_comm=False), 84 (LSC in
# 3-D) and 90 (DLSC in 3-D)
MODES = {
    60: dict(planner_mode=PlannerMode.BVC, goal_mode=GoalMode.STATIC,
             communication_range=-1.0),
    84: dict(world_dimension=3),
    90: dict(world_dimension=3, planner_mode=PlannerMode.DLSC),
}


def _fleet_qp(A, dk):
    p, planner, fleet, inp = workload.build_fleet(A, device="cuda", **MODES[dk])
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(3):
        inp, _ = step(inp)
    cfg = planner.qp_cfg
    assert cfg.dim * qp.torch_statics(cfg, torch.device("cuda"))["K"] == dk
    return cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp, planner.feas_tol


@pytest.fixture(scope="module", params=sorted(MODES))
def mode_qp(request):
    """A ragged fleet (A=37) of each mode after 3 evolving steps, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return _fleet_qp(37, request.param)


def _share(a, b):
    """Largest |a − b| over the tolerance rtol 1e-4 / atol 1e-5 about b."""
    return ((a - b).abs() / (1e-5 + 1e-4 * b.abs())).max().item()


def test_mode_qp_one_chunk_matches_plain_loop(mode_qp):
    cfg, qp_inp, feas_tol = mode_qp
    li = qp.prepare(cfg, qp_inp).loop
    before = dict(qp_cuda.build_launches)
    got = qp.run_loop(cfg, li, 8, feas_tol)
    torch.cuda.synchronize()
    name = qp_cuda.build_name(qp_cuda.build(), cfg.dim * li.Pn.shape[-1])
    assert qp_cuda.build_launches[name] == before.get(name, 0) + 1
    want = qp.admm_loop_plain(cfg, li, 8, feas_tol)
    for a, b in zip(got[:3], want[:3]):
        assert torch.isfinite(a).all()
        assert _per_agent_close(a, b)
    assert (got[3] == want[3]).float().mean() >= 0.99


def test_mode_qp_whole_run_matches_plain_loop(mode_qp):
    """The run to the kernel's own exit: bitwise its chain of single-chunk
    launches, every chunk per agent within the tolerance of the plain chunk
    from the same state, no change from the launches after the exit, and
    the whole run within one tolerance per chunk of the plain iterate after
    as many iterations, or no farther from the float64 plain iterate than
    the float32 plain loop is."""
    cfg, qp_inp, feas_tol = mode_qp
    li = qp.prepare(cfg, qp_inp).loop
    got = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)
    stop = int(got[4])
    again = qp.run_loop(cfg, li, stop, feas_tol)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    state = li
    for _ in range(stop // 8):
        k = qp.run_loop(cfg, state, 8, feas_tol)
        p = qp.admm_loop_plain(cfg, state, 8, feas_tol)
        assert all(_per_agent_close(a, b) for a, b in zip(k[:3], p[:3]))
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)
    want = qp.admm_loop_plain(cfg, li, stop, 0.0)
    share = max(_share(a, b) for a, b in zip(got[:3], want[:3]))
    if share > stop // 8:
        exact = qp.admm_loop_plain(
            cfg, qp.LoopInputs(*(getattr(li, f.name).double()
                                 for f in dataclasses.fields(li))), stop, 0.0)
        k64 = max(_share(a.double(), e) for a, e in zip(got[:3], exact[:3]))
        p64 = max(_share(b.double(), e) for b, e in zip(want[:3], exact[:3]))
        assert k64 <= p64, (share, k64, p64)


def test_3d_compacted_rescue():
    """The compacted rescue (RESCUE = 64 agents, 800 iterations) at dim·K
    84: one bench step of the 3-D fleet at A=128, as in qp.solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cfg, qp_inp, feas_tol = _fleet_qp(128, 84)
    main = qp.prepare(cfg, qp_inp).loop
    xi, z, y = qp.run_loop(cfg, main, cfg.max_iter, feas_tol)[:3]
    li = qp.rescue_batch(cfg, main, xi, z, y, feas_tol)[2]
    assert li.xi.shape[0] == qp.RESCUE
    got = qp.run_loop(cfg, li, cfg.rescue_iter, feas_tol)
    stop = int(got[4])
    state = li
    for _ in range(stop // 8):
        k = qp.run_loop(cfg, state, 8, feas_tol)
        p = qp.admm_loop_plain(cfg, state, 8, feas_tol)
        assert all(_per_agent_close(a, b) for a, b in zip(k[:3], p[:3]))
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)
    out = qp.solve(cfg, qp_inp, feas_tol)
    ref = qp.solve(cfg, qp_inp, feas_tol, plain=True)
    assert out.converged.float().mean() >= ref.converged.float().mean() - 0.01
    both = out.converged & ref.converged
    assert (out.x - ref.x).abs()[both].max() < 0.1


@pytest.fixture(scope="module")
def sim_qp():
    """The QP of the simulator's 4th step on a 10-agent forest mission, on
    the card: O = 9 neighbour slots (another row count and shared-memory
    size than the bench's 16) and the in-place rescue (A <= 64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from lsc_dr_planner_tpu_torch.config import Param
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

    sim = MultiSyncSimulator(Param(multisim_save_result=False), workload.forest_mission(10),
                             log_dir="log", device="cuda")
    for it in range(3):
        if it:
            sim.do_step()
        sim.decentralized_mapp()
        assert sim.plan()
    sim.do_step()
    sim.decentralized_mapp()
    d = sim.planner._step_impl(sim.fleet, sim._build_step_inputs(), defer_qp=True)
    assert sim.planner.O == 9
    return sim.planner.qp_cfg, d.qp_inp, sim.planner.feas_tol


def test_simulator_qp_one_chunk_matches_plain_loop(sim_qp):
    cfg, qp_inp, feas_tol = sim_qp
    li = qp.prepare(cfg, qp_inp).loop
    got = qp.run_loop(cfg, li, 8, feas_tol)
    want = qp.admm_loop_plain(cfg, li, 8, feas_tol)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_simulator_qp_exit_matches_plain_iterate(sim_qp):
    """Many chunks at O = 9: the kernel's state at its own exit (or at
    max_iter) is bitwise the chain of single-chunk launches, each chunk
    agrees with the plain chunk from the same state (per agent: within
    rtol 1e-4 of its largest entry, as a mid-run dual of an inactive row
    is a difference of two terms of that size), and the whole run is the
    plain loop's iterate after as many iterations."""
    cfg, qp_inp, feas_tol = sim_qp
    li = qp.prepare(cfg, qp_inp).loop
    got = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)
    stop = int(got[4])
    again = qp.run_loop(cfg, li, stop, feas_tol)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    state = li
    for _ in range(stop // 8):
        k = qp.run_loop(cfg, state, 8, feas_tol)
        p = qp.admm_loop_plain(cfg, state, 8, feas_tol)
        for a, b in zip(k[:3], p[:3]):
            d, b = (a - b).abs().flatten(1), b.abs().flatten(1)
            assert (d.amax(1) <= 1e-5 + 1e-4 * b.amax(1)).all()
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)
    want = qp.admm_loop_plain(cfg, li, stop, 0.0)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_simulator_qp_in_place_rescue_contract(sim_qp):
    cfg, qp_inp, feas_tol = sim_qp
    before = qp_cuda.launches
    out = qp.solve(cfg, qp_inp, feas_tol)
    torch.cuda.synchronize()
    # main loop and in-place rescue, one launch per 8-iteration chunk
    assert qp_cuda.launches - before == -(-cfg.max_iter // 8) + -(-cfg.rescue_iter // 8)
    ref = qp.solve(cfg, qp_inp, feas_tol, plain=True)
    assert out.converged.float().mean() >= ref.converged.float().mean()
    both = out.converged & ref.converged
    assert (out.x - ref.x).abs()[both].max() < 0.1


@pytest.fixture(scope="module")
def rescue_qp():
    """The compacted rescue batch (RESCUE = 64 agents, 800 iterations) of
    one bench step at A=128: the loop inputs of the second loop call in
    qp.solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    p, planner, fleet, inp = workload.build_fleet(128, device="cuda")
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(3):
        inp, _ = step(inp)
    cfg, feas_tol = planner.qp_cfg, planner.feas_tol
    qp_inp = planner._step_impl(fleet, inp, defer_qp=True).qp_inp
    main = qp.prepare(cfg, qp_inp).loop
    xi, z, y = qp.run_loop(cfg, main, cfg.max_iter, feas_tol)[:3]
    li = qp.rescue_batch(cfg, main, xi, z, y, feas_tol)[2]
    assert li.xi.shape[0] == qp.RESCUE
    return cfg, li, cfg.rescue_iter, feas_tol


def test_rescue_batch_one_chunk_matches_plain_loop(rescue_qp):
    cfg, li, _, feas_tol = rescue_qp
    got = qp.run_loop(cfg, li, 8, feas_tol)
    want = qp.admm_loop_plain(cfg, li, 8, feas_tol)
    for a, b in zip(got[:3], want[:3]):
        assert torch.isfinite(a).all()
        assert _per_agent_close(a, b)


def test_rescue_batch_run_to_exit_is_its_chain_of_chunks(rescue_qp):
    """The rescue loop to the kernel's own exit: bitwise the chain of
    single-chunk launches, every chunk per agent within the tolerance of
    the plain chunk from the same state, and no change from the launches
    after the exit."""
    cfg, li, max_iter, feas_tol = rescue_qp
    got = qp.run_loop(cfg, li, max_iter, feas_tol)
    stop = int(got[4])
    again = qp.run_loop(cfg, li, stop, feas_tol)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    state = li
    for _ in range(stop // 8):
        k = qp.run_loop(cfg, state, 8, feas_tol)
        p = qp.admm_loop_plain(cfg, state, 8, feas_tol)
        assert all(_per_agent_close(a, b) for a, b in zip(k[:3], p[:3]))
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)
