"""The CUDA ADMM kernel against the port's plain loop, on the card.

These tests need a CUDA device and nvcc; without them they skip. They
import neither jax nor the JAX package, so on the GPU machine they run
with `python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(tests/conftest.py imports jax).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.config import GoalMode, PlannerMode
from lsc_dr_planner_tpu_torch.ops import qp, qp_check, qp_cuda, qp_prepare_cuda

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


# QPs past the register builds (dim·K > 96) and past one block's shared
# memory: (Param overrides of build_fleet, agents, the ADMM build and its
# placement of the rows and of Kinv, the preparation's build). The cluster
# build splits an agent's rows and Kinv over its CTAs' shared memory.
CLUSTER = qp_cuda.CLUSTER_BUILD
GLOBAL_PREP = qp_prepare_cuda.GLOBAL_BUILD  # the preparation's tiles in the workspace
WIDE = {
    # 3-D at M = 12, 40 slots within 5 m: dim·K 102 (chip_smoke.py's 8f shape)
    "dk102": (dict(world_dimension=3, M=12, communication_range=5.0, max_obstacles=40), 48,
              CLUSTER, "shared", "shared", "<4>"),
    # DLSC in 3-D at M = 12: dim·K 108
    "dk108": (dict(world_dimension=3, M=12, planner_mode=PlannerMode.DLSC), 37,
              CLUSTER, "shared", "shared", "<4>"),
    # 3-D at M = 16: dim·K 138
    "dk138": (dict(world_dimension=3, M=16), 37, CLUSTER, "shared", "shared", "<4>"),
    # 3-D at M = 28: dim·K 246, Kinv (242 KB) and the KKT tiles past one block
    "dk246": (dict(world_dimension=3, M=28), 37, CLUSTER, "shared", "shared", GLOBAL_PREP),
    # and 160 slots: the rows (~29,400 a agent) too (8 CTAs an agent)
    "dk246_O160": (dict(world_dimension=3, M=28, communication_range=30.0, max_obstacles=160),
                   168, CLUSTER, "shared", "shared", GLOBAL_PREP),
    # Bézier degree 8 (N = 9 control points, K = 58): dim·K 116 in 2-D
    # (chip_smoke.py's 8h shape) and 174 in 3-D
    "dk116_n8": (dict(n=8), 64, CLUSTER, "shared", "shared", "<4>"),
    "dk174_n8_3d": (dict(n=8, world_dimension=3), 64, CLUSTER, "shared", "shared", "<4>"),
}
# Degree 8's QPs are ill-conditioned for float32 ADMM: two float32 solves
# scatter 0-0.5 m from float64, agent by agent either the nearer (the
# kernel's farthest agent 0.37 m from float64 at dk116_n8 against the
# float32 plain solve's 0.51 m, one agent of it 0.1-0.37 m where the plain
# solve's lies under a fifth of that; PERF.md §6). Their solves are
# held to float64 no less exactly than the float32 plain solve: the
# kernel's farthest agent within 0.1 m or no farther than the plain solve's
# (tests/test_torch_wide_shapes.py holds the port to the JAX package so).
ILL_CONDITIONED = ("dk116_n8", "dk174_n8_3d")


def _chunk_held(cfg, state, k, p, feas_tol):
    """One chunk of the kernel (k) from `state` against the plain chunk
    (p), by chip_smoke.py's loop_check with its float64 clause: per agent
    within the tolerance, or within one tolerance of the float64 plain
    chunk, or within qp_check.F64_FACTOR times the float32 plain loop's
    envelope about it (`qp_check.float32_envelope`; at 160 slots of 28
    segments the float32 plain loop's own duals stray ~4 tolerances from
    float64, and one float32 run can land near it by luck)."""
    exact = env = None
    for t, (a, b) in enumerate(zip(k[:3], p[:3])):
        assert torch.isfinite(a).all()
        far = qp_check.agent_shares(a, b) > 1.0
        if not far.any():
            continue
        if exact is None:
            exact = qp.admm_loop_plain(cfg, qp_check.as_f64(state), 8, feas_tol)
        k64 = qp_check.agent_shares(a.double(), exact[t])
        off = far & (k64 > 1.0)
        if not off.any():
            continue
        if env is None:
            env = qp_check.float32_envelope(cfg, state, 8, feas_tol, p, exact, 0)
        ratio = k64[off] / env[t][off]
        assert (ratio <= qp_check.F64_FACTOR).all(), (t, ratio)


@pytest.fixture(scope="module", params=sorted(WIDE))
def wide_qp(request):
    """The QP of a fleet of each WIDE shape after 2 evolving steps, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    over, A = WIDE[request.param][:2]
    p, planner, fleet, inp = workload.build_fleet(A, device="cuda", **over)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(2):
        inp, _ = step(inp)
    cfg = planner.qp_cfg
    qp_inp = planner._step_impl(fleet, inp, defer_qp=True).qp_inp
    return request.param, cfg, qp_inp, planner.feas_tol


def _shape(cfg, li):
    K = li.Pn.shape[-1]
    return cfg.dim, cfg.n_obs, cfg.M, cfg.N, K, li.z.shape[1] - cfg.n_obs * cfg.M * cfg.N


def test_wide_qp_takes_its_builds_and_matches_plain(wide_qp):
    """The preparation kernel equals its plain body (prepare_check's
    contract), and the loop kernel's build and placement are the shape's;
    one chunk of it held to the plain chunk (`_chunk_held`)."""
    name, cfg, qp_inp, feas_tol = wide_qp
    build, rows, kinv, prep_build = WIDE[name][2:]
    got = qp.prepare(cfg, qp_inp)
    want = qp.prepare(cfg, qp_inp, plain=True)
    rec = qp_check.prepare_agreement(cfg, qp_inp, got, want)
    assert all(n == 0 for n in rec["differing"].values()), rec
    assert all(s <= 1.0 for s in rec["share_of_tolerance"].values()), rec
    assert int(got.info.abs().sum()) == 0
    li = got.loop
    shape = _shape(cfg, li)
    assert cfg.dim * shape[4] > 96
    assert qp_prepare_cuda.build_name(*shape[:5]) == prep_build
    lib = qp_cuda.build()
    assert qp_cuda.build_name(lib, *shape, li.xi.shape[0]) == build
    assert qp_cuda.placement(lib, *shape) == {"rows": rows, "kinv": kinv}
    assert qp_cuda.launch_plan(shape, li.xi.shape[0])["ctas_per_sm"] > 0
    before = dict(qp_cuda.build_launches)
    out = qp.run_loop(cfg, li, 8, feas_tol)
    torch.cuda.synchronize()
    assert qp_cuda.build_launches[build] == before.get(build, 0) + 1
    ref = qp.admm_loop_plain(cfg, li, 8, feas_tol)
    _chunk_held(cfg, li, out, ref, feas_tol)
    assert (out[3] == ref[3]).float().mean() >= 0.99


def test_wide_qp_run_is_its_chain_and_solves(wide_qp):
    """The main loop to the kernel's own exit is bitwise its chain of
    single chunks, each held to the plain chunk (`_chunk_held`), and its
    whole run is held to the float64 plain loop (`qp_check.whole_run_f64`);
    the launches after the exit change nothing; the solve's contract: its
    convergence against the float32 plain solve's, and, per agent where
    the three converged, its control points within 0.1 m of the float64
    plain solve's (`qp_check.solve_f64`), or no farther from them than
    qp_check.F64_FACTOR times the float32 plain solve's, as the whole
    run's float64 clause (the ILL_CONDITIONED shapes: no less exact than
    the float32 plain solve, farthest agent to farthest agent). At 160
    slots of 28 segments both float32 solves lie up to 0.33 m from
    float64 on the H100 (p99 0.23 m): float32 ADMM itself misses the 0.1
    m contract there, as the JAX package's does (PERF.md §6)."""
    name, cfg, qp_inp, feas_tol = wide_qp
    li = qp.prepare(cfg, qp_inp).loop
    got = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)
    state = li
    for _ in range(int(got[4]) // 8):
        k = qp.run_loop(cfg, state, 8, feas_tol)
        _chunk_held(cfg, state, k, qp.admm_loop_plain(cfg, state, 8, feas_tol), feas_tol)
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)
    again = qp.run_loop(cfg, li, int(got[4]), feas_tol)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    rec = qp_check.whole_run_f64(cfg, li, got)
    assert rec["agents_failed"] == 0, rec
    out = qp.solve(cfg, qp_inp, feas_tol)
    ref = qp.solve(cfg, qp_inp, feas_tol, plain=True)
    assert out.converged.float().mean() >= ref.converged.float().mean() - 0.01
    exact = qp_check.solve_f64(cfg, qp_inp, feas_tol)
    both = out.converged & ref.converged & exact.converged
    assert both.any()
    d_k, d_p = ((r.x.double() - exact.x).abs().flatten(1).amax(1)[both] for r in (out, ref))
    if name in ILL_CONDITIONED:
        assert d_k.max() <= max(0.1, float(d_p.max())), (d_k.max(), d_p.max())
    else:
        assert ((d_k < 0.1) | (d_k <= qp_check.F64_FACTOR * d_p)).all(), (d_k.max(), d_p.max())


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
    name = qp_cuda.build_name(qp_cuda.build(), *_shape(cfg, li), li.xi.shape[0])
    assert name == {60: "<128,30>", 84: "<288,30>", 90: "<288,30>"}[cfg.dim * li.Pn.shape[-1]]
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


# The triple build's shapes (dim·K 61–96; no shape has dim·K 61, a prime):
# 2-D LSC at M = 11 (62) and 12 (68), 3-D LSC (84) and DLSC (90) at M = 10,
# and 2-D DLSC at M = 16 (96: the ten-warp width)
TRIPLE = {62: dict(M=11), 68: dict(M=12), 84: dict(world_dimension=3),
          90: dict(world_dimension=3, planner_mode=PlannerMode.DLSC),
          96: dict(M=16, planner_mode=PlannerMode.DLSC)}


@pytest.fixture(scope="module", params=sorted(TRIPLE))
def triple_qp(request):
    """A ragged fleet (A=37) of each TRIPLE shape after 3 evolving steps, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    p, planner, fleet, inp = workload.build_fleet(37, device="cuda", **TRIPLE[request.param])
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(3):
        inp, _ = step(inp)
    cfg = planner.qp_cfg
    assert cfg.dim * qp.torch_statics(cfg, torch.device("cuda"))["K"] == request.param
    return request.param, cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp, \
        planner.feas_tol


def test_triple_build_matches_plain_and_float64(triple_qp):
    """The triple build takes the shape as `qp_cuda.triple_plan` plans it
    (threads, shared bytes; four blocks an SM up to dim·K 90, three
    above, for a batch of 37 and of 1,024); one chunk held to the plain chunk (`_chunk_held`); the run to
    its exit bitwise its chain of single chunks, each held to the plain
    chunk, and its whole run held to the float64 plain loop
    (`qp_check.whole_run_f64`)."""
    dk, cfg, qp_inp, feas_tol = triple_qp
    li = qp.prepare(cfg, qp_inp).loop
    shape = _shape(cfg, li)
    plan = qp_cuda.triple_plan(*shape)
    lib = qp_cuda.build()
    name = qp_cuda.build_name(lib, *shape, li.xi.shape[0])
    assert name == f"<{plan['threads']},{plan['build_columns']}>"
    assert lib.admm_smem_bytes(*shape, 1, 0) == plan["smem_bytes"]
    assert lib.admm_blocks_per_sm(*shape, 1, 0) >= (4 if dk <= 90 else 3)
    full = qp_cuda.launch_plan(shape, 1024)  # the bench's batch: 4 agents an SM at 84, 90
    assert full["ctas_per_sm"] == lib.admm_blocks_per_sm(*shape, 1, 0)
    assert full["smem_bytes"] == plan["smem_bytes"]
    assert qp_cuda.placement(lib, *shape) == {"rows": "shared", "kinv": "registers"}
    before = dict(qp_cuda.build_launches)
    k = qp.run_loop(cfg, li, 8, feas_tol)
    torch.cuda.synchronize()
    assert qp_cuda.build_launches[name] == before.get(name, 0) + 1
    _chunk_held(cfg, li, k, qp.admm_loop_plain(cfg, li, 8, feas_tol), feas_tol)
    got = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)
    state = li
    for _ in range(int(got[4]) // 8):
        k = qp.run_loop(cfg, state, 8, feas_tol)
        _chunk_held(cfg, state, k, qp.admm_loop_plain(cfg, state, 8, feas_tol), feas_tol)
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)
    rec = qp_check.whole_run_f64(cfg, li, got)
    assert rec["agents_failed"] == 0, rec


def test_triple_build_agent_alone_same_bits():
    """An agent's chunk does not depend on its batch: agents of 8b's
    1,024-agent 3-D batch, each alone, give the same bits as in the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cfg, qp_inp, feas_tol = _fleet_qp(1024, 84)
    li = qp.prepare(cfg, qp_inp).loop
    batch = qp.run_loop(cfg, li, 8, feas_tol)
    for j in (0, 511, 1023):
        alone = qp.run_loop(cfg, li.take(torch.tensor([j], device="cuda")), 8, feas_tol)
        for a, b in zip(alone[:4], batch[:4]):
            assert torch.equal(a[0], b[j]), j

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
    is a difference of two terms of that size), and the whole run is
    held to the float64 plain iterate after as many iterations
    (`qp_check.whole_run_f64`: per agent within one tolerance of it, or
    within F64_FACTOR times the float32 plain loop's spread about it;
    after ~200 iterations the float32 plain loop is itself a few
    tolerances from float64 on this state, so a float32 run is no
    reference for another)."""
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
    rec = qp_check.whole_run_f64(cfg, li, got)
    assert rec["agents_failed"] == 0, rec


@pytest.fixture(scope="module")
def moved_dlsc_3d():
    """The DLSC 3-D bench fleet (A=1024, dim·K 90: chip_smoke.py's phase
    8e) after 3 evolving steps, with every agent's position moved by
    1e-6 m in a random direction (one state a seed): the QPs of the next
    step, prepared on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    p, planner, fleet, inp = workload.build_fleet(1024, device="cuda", world_dimension=3,
                                                  planner_mode=PlannerMode.DLSC)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(3):
        inp, _ = step(inp)
    cfg = planner.qp_cfg
    out = []
    for seed in (11, 12, 13):
        g = torch.Generator(device="cuda").manual_seed(seed)
        d = torch.randn(inp.pos.shape, generator=g, device="cuda")
        moved = dataclasses.replace(
            inp, pos=inp.pos + 1e-6 * d / torch.linalg.vector_norm(d, dim=-1, keepdim=True))
        qi = planner._step_impl(fleet, moved, defer_qp=True).qp_inp
        out.append(qp.prepare(cfg, qi).loop)
    return cfg, planner.feas_tol, out


@pytest.mark.parametrize("state", [0, 1, 2])
def test_moved_dlsc_3d_whole_run_is_held_to_float64(moved_dlsc_3d, state):
    """The float64 criterion of the whole run (`qp_check.whole_run_f64`)
    on the ill-conditioned 3-D DLSC batch moved by a micrometre: the
    acceleration rows' duals (ρ = 50) of a few agents are where float32
    sums of the Kinv matvec and the adjoint strayed 5–8 times the
    float32 plain loop's spread."""
    cfg, feas_tol, lis = moved_dlsc_3d
    li = lis[state]
    got = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)
    rec = qp_check.whole_run_f64(cfg, li, got, seed=state)
    assert rec["agents_failed"] == 0, rec


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


# ---- local sensing and Monte-Carlo batching on the card --------------------


def _forest64_known(rng):
    """forest_mission(64, seed=1)'s world, and per agent the rasterization
    of a random half of its trees (numpy)."""
    from lsc_dr_planner_tpu_torch.world import grid

    m = workload.forest_mission(64, 1)
    boxes = m.world_boxes
    occ = np.stack([grid.rasterize_boxes(boxes[rng.random(len(boxes)) < 0.5], m.world_min,
                                         m.world_max, 0.1)[0] for _ in range(64)])
    return m, occ


def test_per_agent_sfc_on_card_matches_cpu():
    """The per-agent blocked lattices and integral images, and the SFC
    update over them in its three modes, on the card against the CPU
    path on the same inputs: identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lsc_dr_planner_tpu_torch.ops import sfc
    from lsc_dr_planner_tpu_torch.world import grid

    rng = np.random.default_rng(0)
    m, occ = _forest64_known(rng)
    A, M, N = 64, 10, 6
    views, args = [], []
    for dev in ("cpu", "cuda"):
        g = grid.build_grid_world(m.world_boxes, m.world_min, m.world_max, 0.1, 0.15, dev)
        blk, S = grid.blocked_cumsum(torch.as_tensor(occ, device=dev), 0.1, 0.15)
        views.append((blk.cpu(), S.cpu(), grid.local_grid_world(g, S)))
    assert torch.equal(views[0][0], views[1][0]) and torch.equal(views[0][1], views[1][1])
    half = 0.5 * (m.world_max[0] - m.world_min[0]) - 0.5
    pos = np.column_stack([rng.uniform(-half, half, (A, 2)), np.full(A, 0.6)]).astype(np.float32)
    last_pt = (pos + np.column_stack([rng.uniform(-0.5, 0.5, (A, 2)), np.zeros(A)])).astype(np.float32)
    cgoal = (pos + np.column_stack([rng.uniform(-1.5, 1.5, (A, 2)), np.zeros(A)])).astype(np.float32)
    wpt = (pos + np.column_stack([rng.uniform(-1, 1, (A, 2)), np.zeros(A)])).astype(np.float32)
    g0 = views[0][2]
    slo = (g0.point_to_lattice_floor(torch.as_tensor(pos)) - 2)[:, None].expand(A, M, 3)
    shi = (g0.point_to_lattice_ceil(torch.as_tensor(pos)) + 2)[:, None].expand(A, M, 3)
    init = torch.as_tensor(rng.random(A) < 0.7)
    ictrl = torch.as_tensor(np.linspace(pos, last_pt, M * N, axis=1).reshape(A, M, N, 3))
    cpu_args = [slo.contiguous(), shi.contiguous(), init, *map(torch.as_tensor,
                                                               (last_pt, cgoal, wpt, pos)), ictrl]
    for mode in ("hull", "point", "substep"):
        out = [sfc.update_sfc(v, mode, *(a.to(v.device) for a in cpu_args), 0.15,
                              max_radius_cells=40) for _, _, v in views]
        assert torch.equal(out[0][0], out[1][0].cpu()), mode
        assert torch.equal(out[0][1], out[1][1].cpu()), mode


def test_map_manager_on_card_matches_numpy():
    """Sensing and merging on the card against the JAX package's numpy
    algorithm (with an exact int64 merge product) over a random walk of
    forest_mission(64, seed=1)'s agents: identical maps and versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lsc_dr_planner_tpu_torch.world.map_manager import MapManager

    m = workload.forest_mission(64, 1)
    mm = MapManager(m.world_boxes, m.world_min, m.world_max, 0.1, 64, use_global_map=False,
                    device="cuda")
    occ, A = mm.occ_true, 64
    idx = np.argwhere(occ)
    centers = (idx + mm.origin_idx + 0.5) * 0.1
    known = np.zeros((A,) + occ.shape, bool)
    version = np.zeros(A, np.int64)
    rng = np.random.default_rng(1)
    pos = m.stacked()["start"].astype(np.float64)
    for step in range(6):
        pos[:, :2] += rng.uniform(-0.3, 0.3, (A, 2))
        mm.sense(pos, 3.0)
        hit = ((centers[None] - pos[:, None]) ** 2).sum(-1) <= 9.0
        for a in range(A):
            cells = tuple(idx[hit[a]].T)
            version[a] += int((~known[a][cells]).sum())
            known[a][cells] = True
        comm = (1.5, 3.0, -1.0)[step % 3]
        mm.merge(pos, comm)
        d = np.max(np.abs(pos[:, None] - pos[None]), axis=-1)
        adj = (d < comm) if comm > 0 else np.ones_like(d, bool)
        np.fill_diagonal(adj, False)
        flat = known.reshape(A, -1)
        before = flat.sum(1)
        flat = flat | (adj.astype(np.int64) @ flat.astype(np.int64) > 0)
        version += flat.sum(1) - before
        known = flat.reshape(known.shape)
        np.testing.assert_array_equal(mm.known.cpu().numpy(), known)
        np.testing.assert_array_equal(mm._version, version)
    np.testing.assert_array_equal(mm.union_occ(), known.any(0))


@pytest.fixture(scope="module")
def montecarlo_qp():
    """The flattened QP of one Monte-Carlo step (S=8 scenarios of
    forest_mission(64, seed=1): A = 512) after 3 lockstep steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from lsc_dr_planner_tpu_torch.config import Param
    from lsc_dr_planner_tpu_torch.sim.montecarlo import MonteCarloSimulator

    mc = MonteCarloSimulator(Param(multisim_save_result=False), workload.forest_mission(64, 1),
                             n_scenarios=8, max_noise=0.25, log_dir="log", device="cuda")
    for it in range(3):
        mc.step(it)
    _, dev, B = mc.prepare_step(3)
    d = mc.chunk_qp(dev, 0, B)
    assert d.qp_inp.p0.shape[0] == 512
    return mc.planner.qp_cfg, d.qp_inp, mc.planner.feas_tol


def _chain_matches_plain(cfg, li, max_iter, feas_tol):
    """The run to the kernel's own exit is bitwise its chain of single
    chunks, each per agent within the tolerance of the plain chunk from
    the same state (loop_check's per-agent rule)."""
    got = qp.run_loop(cfg, li, max_iter, feas_tol)
    stop = int(got[4])
    state = li
    for _ in range(stop // 8):
        k = qp.run_loop(cfg, state, 8, feas_tol)
        p = qp.admm_loop_plain(cfg, state, 8, feas_tol)
        assert all(_per_agent_close(a, b) for a, b in zip(k[:3], p[:3]))
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)
    return got


def test_montecarlo_flattened_qp_matches_plain_loop(montecarlo_qp):
    cfg, qp_inp, feas_tol = montecarlo_qp
    main = qp.prepare(cfg, qp_inp).loop
    xi, z, y = _chain_matches_plain(cfg, main, cfg.max_iter, feas_tol)[:3]
    # the compacted rescue picks its agents across the 8 scenarios
    rescue = qp.rescue_batch(cfg, main, xi, z, y, feas_tol)[2]
    assert rescue.xi.shape[0] == qp.RESCUE
    _chain_matches_plain(cfg, rescue, cfg.rescue_iter, feas_tol)
    out = qp.solve(cfg, qp_inp, feas_tol)
    ref = qp.solve(cfg, qp_inp, feas_tol, plain=True)
    assert out.converged.float().mean() >= ref.converged.float().mean() - 0.005
    both = out.converged & ref.converged
    assert (out.x - ref.x).abs()[both].max() < 0.1


# ---- the cluster build ----------------------------------------------------


def _cluster_run(cfg, li, max_iter, feas_tol, C):
    """The whole loop on the cluster build at cluster size C."""
    ts = qp.torch_statics(cfg, li.xi.device)
    qp.check_kernel_rows(cfg, li)
    return qp_cuda.admm_loop_cuda(li, ts["stencil"], ts["N3k"], ts["N3kT"],
                                  cfg.rho * qp._RHO_SCALE["lsc"], max_iter, qp.CHUNK,
                                  0.6 * feas_tol, cfg.sigma, cfg.alpha, cfg.eps_abs, C=C)


@pytest.mark.parametrize("name", ["dk102", "dk116_n8", "dk246"])
def test_cluster_result_does_not_depend_on_C(name):
    """xi, z, y, itdone and the exit of the whole loop are the same bits at
    every cluster size whose CTA fits the device and whose clusters can be
    resident (every sum runs over the fixed groups in one order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    over, A = WIDE[name][:2]
    p, planner, fleet, inp = workload.build_fleet(A, device="cuda", **over)
    step = workload.make_evolve_step(p, planner, fleet)
    inp, _ = step(inp)
    cfg = planner.qp_cfg
    li = qp.prepare(cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp).loop
    lib = qp_cuda.build()
    shape = _shape(cfg, li)
    limit = lib.admm_smem_limit()
    sizes = [C for C in qp_cuda.CLUSTER_SIZES
             if lib.admm_active_clusters(*shape, A, C,
                                         int(qp_cuda.stage_n3k(shape, C, limit))) > 0]
    assert len(sizes) >= 2, sizes
    runs = {}
    for C in sizes:
        runs[C] = _cluster_run(cfg, li, cfg.max_iter, planner.feas_tol, C)
        torch.cuda.synchronize()
        assert qp_cuda.last_launch["C"] == C and qp_cuda.last_launch["active_clusters"] > 0
    for C in sizes[1:]:
        for a, b in zip(runs[sizes[0]], runs[C]):
            assert torch.equal(a, b), (name, sizes[0], C)


@pytest.mark.parametrize("name", ["8f", "8h"])
def test_cluster_rescue_batch(name):
    """The compacted rescue (RESCUE = 64 agents, 800 iterations) at 8f's
    shape (3-D, M = 12, 80 slots within 5 m) and 8h's (Bézier degree 8):
    one main step of a fleet of 128, as in qp.solve; the rescue's cluster
    size; its run to its exit bitwise its chain of single chunks, each
    held to the plain chunk (`_chunk_held`: per agent within the
    tolerance, or by the float64 clause)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    over = {"8f": dict(world_dimension=3, M=12, communication_range=5.0, max_obstacles=80),
            "8h": dict(n=8)}[name]
    p, planner, fleet, inp = workload.build_fleet(128, device="cuda", **over)
    step = workload.make_evolve_step(p, planner, fleet)
    inp, _ = step(inp)
    cfg, feas_tol = planner.qp_cfg, planner.feas_tol
    main = qp.prepare(cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp).loop
    xi, z, y = qp.run_loop(cfg, main, cfg.max_iter, feas_tol)[:3]
    li = qp.rescue_batch(cfg, main, xi, z, y, feas_tol)[2]
    assert li.xi.shape[0] == qp.RESCUE
    got = qp.run_loop(cfg, li, cfg.rescue_iter, feas_tol)
    torch.cuda.synchronize()
    plan = qp_cuda.last_launch
    assert plan["build"] == CLUSTER and plan["active_clusters"] > 0, plan
    state = li
    for _ in range(int(got[4]) // 8):
        k = qp.run_loop(cfg, state, 8, feas_tol)
        _chunk_held(cfg, state, k, qp.admm_loop_plain(cfg, state, 8, feas_tol), feas_tol)
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)


def test_cluster_exit_at_the_first_test():
    """A batch whose every agent passes the exit test at chunk 1: the
    dk102 fleet's agents that pass a test within the rescue's 800
    iterations from the main loop's iterate, resumed from there, and of
    those the ones that pass at chunk 1 (an agent's iterate does not depend
    on the batch). The loop reports 8 iterations, the later launches
    return at once (the whole call costs less than four single-chunk
    calls) and leave the state of chunk 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    over, A = WIDE["dk102"][:2]
    p, planner, fleet, inp = workload.build_fleet(A, device="cuda", **over)
    step = workload.make_evolve_step(p, planner, fleet)
    inp, _ = step(inp)
    cfg, feas_tol = planner.qp_cfg, planner.feas_tol
    li = qp.prepare(cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp).loop
    first = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)
    second = qp.run_loop(cfg, li.resume(*first[:3]), cfg.rescue_iter, feas_tol)
    idx = (second[3] < cfg.rescue_iter).nonzero()[:, 0]
    sub = li.take(idx).resume(*(t[idx] for t in second[:3]))
    third = qp.run_loop(cfg, sub, cfg.max_iter, feas_tol)
    keep = (third[3] == 8).nonzero()[:, 0]
    assert keep.numel() >= 4, (idx.numel(), third[3])
    done = sub.take(keep)
    got = qp.run_loop(cfg, done, cfg.max_iter, feas_tol)
    one = qp.run_loop(cfg, done, 8, feas_tol)
    torch.cuda.synchronize()
    assert qp_cuda.last_launch["build"] == CLUSTER
    assert int(got[4]) == 8 and (got[3] == 8).all(), (int(got[4]), got[3])
    for a, b in zip(got, one):
        assert torch.equal(a, b)

    def ms(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            qp.run_loop(cfg, done, iters, feas_tol)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / 5

    full, chunk = ms(cfg.max_iter), ms(8)
    assert full < 4 * chunk, (full, chunk)


def test_memory_build_on_a_full_batch():
    """Past the register builds, a batch that fills every SM twice over
    with two agents an SM (Bézier degree 8 at A = 264) takes the memory
    build, one agent a block: one chunk held to the plain chunk
    (`_chunk_held`), and the run to its exit bitwise its chain of chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    p, planner, fleet, inp = workload.build_fleet(2 * qp_cuda.SMS, device="cuda", n=8)
    step = workload.make_evolve_step(p, planner, fleet)
    inp, _ = step(inp)
    cfg, feas_tol = planner.qp_cfg, planner.feas_tol
    li = qp.prepare(cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp).loop
    before = dict(qp_cuda.build_launches)
    k = qp.run_loop(cfg, li, 8, feas_tol)
    torch.cuda.synchronize()
    assert qp_cuda.last_launch["build"] == qp_cuda.MEMORY_BUILD, qp_cuda.last_launch
    assert qp_cuda.build_launches[qp_cuda.MEMORY_BUILD] == before.get(qp_cuda.MEMORY_BUILD, 0) + 1
    _chunk_held(cfg, li, k, qp.admm_loop_plain(cfg, li, 8, feas_tol), feas_tol)
    got = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)
    state = li
    for _ in range(int(got[4]) // 8):
        k = qp.run_loop(cfg, state, 8, feas_tol)
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)


def test_cluster_launch_refusals():
    """The wrapper's library refuses a cluster size other than 2, 4, 8 (1:
    the memory build, 0: the global build) and agrees with
    `qp_cuda.cluster_plan` on a CTA's bytes, with `memory_block_bytes` on
    a block's and with `global_block_bytes` on the global build's; a shape
    past the cluster build's reach is planned on the global build."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    lib = qp_cuda.build()
    shape_8f, shape_8h = (3, 80, 12, 6, 34, 774), (2, 16, 10, 9, 58, 590)
    assert lib.admm_smem_bytes(*shape_8f, 3, 0) == 0
    assert lib.admm_blocks_per_sm(*shape_8f, 3, 0) == -2
    assert lib.admm_active_clusters(*shape_8f, 64, 16, 0) == -2
    assert lib.admm_smem_bytes(*shape_8h, 1, 0) == qp_cuda.memory_block_bytes(*shape_8h)
    assert lib.admm_blocks_per_sm(*shape_8h, 1, 0) == 2
    assert lib.admm_blocks_per_sm(*shape_8f, 1, 0) == 1
    for shape in (shape_8f, shape_8h, (3, 160, 28, 6, 82, 2478)):
        for A in (1024, 64):
            C, n3k, nbytes = qp_cuda.cluster_plan(shape, A, lib.admm_smem_limit())
            assert lib.admm_smem_bytes(*shape, C, int(n3k)) == nbytes
            assert lib.admm_active_clusters(*shape, A, C, int(n3k)) > 0
            assert lib.admm_blocks_per_sm(*shape, C, int(n3k)) > 0
    shape = (3, 640, 28, 6, 82, 2478)
    with pytest.raises(ValueError, match="reach"):
        qp_cuda.cluster_plan(shape, 1024, lib.admm_smem_limit())
    plan = qp_cuda.launch_plan(shape, 1024)
    assert plan["build"] == qp_cuda.GLOBAL_BUILD and plan["C"] == 0, plan
    assert plan["smem_bytes"] == qp_cuda.global_block_bytes(*shape) == lib.admm_smem_bytes(
        *shape, 0, 0)
    assert plan["ctas_per_sm"] == lib.admm_blocks_per_sm(*shape, 0, 0) >= 2


def _random_qp_inputs(cfg, A, seed, device="cuda"):
    """QP inputs of A agents from a numpy seed, shaped as the pipeline's:
    positions within 20 m of the origin, unit normals with masked slots,
    LSC rows active where the slot is, the first segment's pinned points
    inactive, world-sized bounds, a warm start near the agent, duals; on
    `device`."""
    rng = np.random.default_rng(seed)
    dim, O, M, N = cfg.dim, cfg.n_obs, cfg.M, cfg.N
    p0 = rng.uniform(-20, 20, (A, dim))
    nrm = rng.standard_normal((A, O, M, dim))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mask = rng.random((A, O)) < 0.8
    nrm *= mask[..., None, None]
    active = np.broadcast_to(mask[..., None, None], (A, O, M, N)).copy()
    active &= rng.random((A, O, M, N)) < 0.9
    active[:, :, 0, :cfg.phi] = False
    centre = p0[:, :, None, None]
    arrays = dict(
        p0=p0, v0=rng.uniform(-1, 1, (A, dim)), a0=rng.uniform(-2, 2, (A, dim)),
        goal=p0 + rng.uniform(-3, 3, (A, dim)),
        terminal_mask=(np.arange(M) >= rng.integers(1, M, A)[:, None]), lsc_normals=nrm,
        lsc_rhs=rng.uniform(-2, 2, (A, O, M, N)), lsc_active=active,
        vmax=rng.uniform(1, 3, (A, dim)), amax=rng.uniform(2, 5, (A, dim)),
        lb=centre - rng.uniform(2, 6, (A, dim, M, N)),
        ub=centre + rng.uniform(2, 6, (A, dim, M, N)),
        comm_halfrange=rng.uniform(1, 2, A), x0=centre + rng.uniform(-1, 1, (A, dim, M, N)),
        y0=0.1 * rng.standard_normal((A, qp.n_rows(cfg))))
    return qp.QPInputs(**{k: torch.as_tensor(v, dtype=torch.bool if k == "lsc_active"
                                              else torch.float32, device=device)
                          for k, v in arrays.items()})


def test_global_build_past_the_cluster_reach():
    """A shape the cluster build refuses (3-D at M = 28 with 480 slots:
    an agent's rows and Kinv past 8 CTAs' shared memory), on a few
    agents of random QPs: the loop takes the global build, rows and Kinv
    in global memory; one chunk held to the plain chunk (`_chunk_held`:
    the float64 clause), the run to its exit bitwise its chain of chunks
    and held to the float64 plain loop (`qp_check.whole_run_f64`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cfg = qp.QPConfig(dim=3, M=28, n=5, phi=3, n_obs=480, use_comm=True, stop_at_horizon=True,
                      dt=0.2, control_input_weight=0.01, terminal_weight=1.0, rho=1.0,
                      sigma=1e-6, alpha=1.6, max_iter=200, eps_abs=1e-3, rescue_iter=800)
    feas_tol = 5e-3
    li = qp.prepare(cfg, _random_qp_inputs(cfg, 5, seed=4)).loop
    shape = _shape(cfg, li)
    lib = qp_cuda.build()
    assert shape == (3, 480, 28, 6, 82, 2478)
    assert not qp_cuda.cluster_reach(shape, lib.admm_smem_limit())
    assert qp_cuda.build_name(lib, *shape, 5) == qp_cuda.GLOBAL_BUILD
    assert qp_cuda.placement(lib, *shape) == {"rows": "global", "kinv": "global"}
    before = dict(qp_cuda.build_launches)
    k = qp.run_loop(cfg, li, 8, feas_tol)
    torch.cuda.synchronize()
    assert qp_cuda.last_launch["build"] == qp_cuda.GLOBAL_BUILD and qp_cuda.last_launch["C"] == 0
    assert qp_cuda.build_launches[qp_cuda.GLOBAL_BUILD] == before.get(qp_cuda.GLOBAL_BUILD, 0) + 1
    _chunk_held(cfg, li, k, qp.admm_loop_plain(cfg, li, 8, feas_tol), feas_tol)
    got = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)
    state = li
    for _ in range(int(got[4]) // 8):
        k = qp.run_loop(cfg, state, 8, feas_tol)
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)
    rec = qp_check.whole_run_f64(cfg, li, got)
    assert rec["agents_failed"] == 0, rec


# (build_fleet overrides, agents, the cluster size loop_plan gives the batch)
# of the shapes where the global build, forced, runs beside the cluster build:
# chip_smoke.py's 8f (3-D at M = 12, 80 slots) and 8g's 160 slots at M = 28
GLOBAL_BESIDE_CLUSTER = {
    "8f": (dict(world_dimension=3, M=12, communication_range=5.0, max_obstacles=80), 64, 2),
    "dk246_O160": (WIDE["dk246_O160"][0], WIDE["dk246_O160"][1], 8),
}


@pytest.mark.parametrize("name", sorted(GLOBAL_BESIDE_CLUSTER))
def test_global_build_is_the_cluster_bits(name):
    """The global build forced (C = 0) against the cluster build at the
    batch's cluster size: xi, z, y, itdone and the iterations the same
    bits for one chunk and for the run to its exit (the global build runs
    the cluster build's order of operations in one block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    over, A, C = GLOBAL_BESIDE_CLUSTER[name]
    p, planner, fleet, inp = workload.build_fleet(A, device="cuda", **over)
    step = workload.make_evolve_step(p, planner, fleet)
    inp, _ = step(inp)
    cfg, feas_tol = planner.qp_cfg, planner.feas_tol
    li = qp.prepare(cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp).loop
    shape = _shape(cfg, li)
    assert qp_cuda.launch_plan(shape, A)["C"] == C
    for iters in (qp.CHUNK, cfg.max_iter):
        got = _cluster_run(cfg, li, iters, feas_tol, 0)
        torch.cuda.synchronize()
        assert qp_cuda.last_launch["build"] == qp_cuda.GLOBAL_BUILD
        want = _cluster_run(cfg, li, iters, feas_tol, C)
        torch.cuda.synchronize()
        assert qp_cuda.last_launch["C"] == C
        for a, b in zip(got, want):
            assert torch.equal(a, b), (name, iters)


def test_global_build_rescue_sized_batch():
    """The 480-slot shape of test_global_build_past_the_cluster_reach on a
    rescue-sized batch (qp.RESCUE = 64 agents of random QPs, 64 blocks on
    132 SMs): the global build; one chunk held to the plain chunk
    (`_chunk_held`), the run to its exit bitwise its chain of chunks, each
    agent's run the same bits as that agent alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cfg = qp.QPConfig(dim=3, M=28, n=5, phi=3, n_obs=480, use_comm=True, stop_at_horizon=True,
                      dt=0.2, control_input_weight=0.01, terminal_weight=1.0, rho=1.0,
                      sigma=1e-6, alpha=1.6, max_iter=200, eps_abs=1e-3, rescue_iter=800)
    feas_tol = 5e-3
    li = qp.prepare(cfg, _random_qp_inputs(cfg, qp.RESCUE, seed=5)).loop
    k = qp.run_loop(cfg, li, 8, feas_tol)
    torch.cuda.synchronize()
    assert qp_cuda.last_launch["build"] == qp_cuda.GLOBAL_BUILD
    _chunk_held(cfg, li, k, qp.admm_loop_plain(cfg, li, 8, feas_tol), feas_tol)
    got = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)
    state = li
    for _ in range(int(got[4]) // 8):
        k = qp.run_loop(cfg, state, 8, feas_tol)
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)
    idx = torch.tensor([7], device="cuda")
    alone = qp.run_loop(cfg, li.take(idx), int(got[4]), 0.0)
    for a, b in zip(qp.run_loop(cfg, li, int(got[4]), 0.0)[:3], alone[:3]):
        assert torch.equal(a[idx], b)
