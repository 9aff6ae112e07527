"""The ADMM kernel's triple build (`csrc/admm.cu`, dim·K 61–96) on the CPU.

The kernel itself runs only on the card (its `cuda` tests are in
tests/test_torch_cuda.py, which imports no jax). Here:

- `qp_cuda.triple_plan`, the pure-Python mirror of the build's block for
  every dim·K 61–96 in 2-D and 3-D: its threads, the three threads of
  each Kinv row, the Kinv columns a thread holds and its shared bytes
  (admm.cu's triple_smem_floats), and four blocks an SM at the bench's
  3-D shapes (dim·K 84 and 90);
- `triple_twin`, a torch twin of the build's order of sums on the CPU
  (float32 state; each adjoint row, Kinv row and control point summed in
  double as three partials over thirds of its terms, added (p0 + p1) +
  p2; the adjoint points summed in double and rounded to float32 once;
  each row rounded once), against the plain loop chunk by chunk at dim·K
  84 (3-D LSC), 90 (3-D DLSC) and 68 (2-D, M = 12), and, with the port's
  plain preparation before it and its finish after it (`qp.solve` with
  the twin as its loop), against the JAX package's `solve` on the same
  QP inputs, with tests/test_torch_qp.py's contract.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.config import PlannerMode
from lsc_dr_planner_tpu_torch.ops import qp, qp_check, qp_cuda

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

H100_SMEM_OPTIN = 232448  # bytes a block may opt in to on the H100 (227 KB)


def _cfg(dim, M, n=5, O=16):
    return qp.QPConfig(dim=dim, M=M, n=n, phi=3, n_obs=O, use_comm=True, stop_at_horizon=True,
                       dt=0.2, control_input_weight=1.0, terminal_weight=10.0, rho=1.0,
                       sigma=1e-6, alpha=1.6, max_iter=200, eps_abs=1e-3)


def _shape(cfg):
    """(dim, O, M, N, K, R_stat) of cfg's QP: the ADMM builds' shape."""
    ts = qp.torch_statics(cfg, torch.device("cpu"))
    return (cfg.dim, cfg.n_obs, cfg.M, cfg.N, ts["K"], ts["stencil"]["idx"].shape[0])


def _plan_shapes():
    """A shape of every dim·K 61–96 in 2-D (even) and 3-D (multiples of
    3): the bench's statics at the horizon whose K comes nearest, K set to
    dim·K / dim (the block's bytes depend on K, M, N, O and R_stat)."""
    out = []
    for dim in (2, 3):
        for dk in range(61, 97):
            if dk % dim:
                continue
            K = dk // dim
            M = max(1, min(17, (K + 2) // 3))
            R_stat = _shape(_cfg(dim, M))[5]
            out.append((dim, 16, M, 6, K, R_stat))
    return out


@pytest.mark.parametrize("shape", _plan_shapes(), ids=lambda s: f"{s[0]}d_dk{s[0] * s[4]}")
def test_triple_plan(shape):
    """Nine warps up to dim·K 90 and ten above; three threads a Kinv row,
    ten triples a warp holding every row; ⌈dk/3⌉ columns a thread within
    the build's columns (its name's, in registers and shared memory); the
    shared bytes of admm.cu's triple_smem_floats."""
    dim, O, M, N, K, R_stat = shape
    dk, MN = dim * K, M * N
    plan = qp_cuda.triple_plan(*shape)
    W = 9 if dk <= 90 else 10
    assert plan["threads"] == 32 * W
    assert plan["threads_a_row"] == 3
    assert plan["rows_in_registers"] == 10 * W >= dk
    assert plan["columns"] == -(-dk // 3) <= plan["build_columns"] == (30 if W == 9 else 32)
    R = O * MN + R_stat
    pad = 2 + 3 * dim if W == 10 else 0  # the ten-warp width's rhs and ξ̃ padding
    floats = (2 * (2 * dim * MN + dk + pad) + O * M * dim + 4 * R + R_stat + 3 * dk + MN
              + plan["shared_columns"] * 30 * W)
    assert plan["smem_bytes"] == qp_cuda.triple_block_bytes(*shape) == 4 * floats


@pytest.mark.parametrize("dk,mode", [(84, PlannerMode.LSC), (90, PlannerMode.DLSC)])
def test_triple_plan_four_blocks_an_sm_in_3d(dk, mode):
    """The bench's 3-D shapes (16 slots, M = 10) fit four blocks an SM's
    shared memory on the H100; a shape outside 61–96 is refused."""
    p, planner, fleet, inp = workload.build_fleet(4, device="cpu", world_dimension=3,
                                                  planner_mode=mode)
    shape = _shape(planner.qp_cfg)
    assert shape[0] * shape[4] == dk
    plan = qp_cuda.triple_plan(*shape)
    assert plan["threads"] == 288
    assert qp_cuda.ctas_per_sm(plan["smem_bytes"], H100_SMEM_OPTIN) >= 4
    for bad in ((2, 16, 10, 6, 30, 410), (3, 16, 12, 6, 34, 774)):
        with pytest.raises(ValueError, match="61–96"):
            qp_cuda.triple_plan(*bad)


# ---- the twin -----------------------------------------------------------


def _thirds(n):
    """The kernel's thirds of n terms: [p·⌈n/3⌉, min(n, (p+1)·⌈n/3⌉))."""
    t = -(-n // 3)
    return [slice(min(n, p * t), min(n, (p + 1) * t)) for p in range(3)]


def _combine(parts):
    return (parts[0] + parts[1]) + parts[2]


def _stencils(tab, nv, R_stat):
    """[dim·MN, R_stat] double: the transposed stencils (adj_ptr, adj_row)."""
    ptr, rows, coef = tab["adj_ptr"], tab["adj_row"], tab["adj_coef"]
    out = torch.zeros(nv, R_stat, dtype=torch.float64)
    for i in range(nv):
        e = slice(int(ptr[i]), int(ptr[i + 1]))
        out[i, torch.as_tensor(rows[e]).long()] = torch.as_tensor(coef[e]).float().double()
    return out


def triple_twin(cfg, li, max_iter, feas_tol):
    """The triple build's loop on CPU tensors (float32 LoopInputs): the
    kernel's order of sums, its exit gates every qp.CHUNK iterations and
    its global exit; returns what qp.admm_loop_plain returns."""
    ts = qp.torch_statics(cfg, li.xi.device)
    tab = qp.stencil_table(cfg)
    B, O, M, dim = li.normals.shape
    K, MN, N = ts["K"], cfg.M * cfg.N, cfg.N
    dk, R_lsc = dim * K, O * MN
    f32 = torch.float32
    rho_lsc = torch.tensor(cfg.rho * qp._RHO_SCALE["lsc"], dtype=f32)
    rho_stat = ts["stencil"]["rho"]
    sigma, alpha = torch.tensor(cfg.sigma, dtype=f32), torch.tensor(cfg.alpha, dtype=f32)
    beta = torch.tensor(1 - cfg.alpha, dtype=f32)
    N3k = ts["N3k"].double()
    idx = torch.as_tensor(tab["idx"]).long()
    coef = torch.as_tensor(tab["coef"]).float().double()
    mof = torch.arange(MN) // N
    nrm = li.normals[:, :, mof, :].double()  # [B, O, MN, dim]
    stencils = _stencils(tab, dim * MN, li.z.shape[1] - R_lsc)
    lo = li.ln
    hi = torch.cat([torch.full((B, R_lsc), float("inf")), li.un[:, R_lsc:]], 1)
    rho = torch.cat([rho_lsc.expand(B, R_lsc), rho_stat.expand(B, -1)], 1)
    Kinv = li.Kinv.double()
    stop_tol = torch.tensor(0.6 * feas_tol, dtype=f32)

    def adjoint(w):  # Aᵀw: the points in double, rounded once, the rows in thirds
        wl, ws = w[:, :R_lsc].view(B, O, MN).double(), w[:, R_lsc:].double()
        va = (torch.einsum("bomd,bom->bdm", nrm, wl).reshape(B, -1) + ws @ stencils.T)
        va = va.float().double().view(B, dim, MN)
        return _combine([torch.einsum("km,bdm->bdk", N3k[:, sm], va[..., sm])
                         for sm in _thirds(MN)])

    def points(x):  # control points in double, thirds of k
        x = x.double()
        return _combine([torch.einsum("bdk,km->bdm", x[..., sk], N3k[sk])
                         for sk in _thirds(K)])

    def rows(vd):  # [B, dim, MN] double → float32 rows, each rounded once
        r_lsc = torch.einsum("bomd,bdm->bom", nrm, vd).reshape(B, R_lsc)
        r_st = (coef * vd.reshape(B, -1)[:, idx]).sum(-1)
        return torch.cat([r_lsc, r_st], 1).float()

    def solve(rhs):  # Kinv·rhs in double, thirds of the columns
        return _combine([torch.einsum("bij,bj->bi", Kinv[..., sc], rhs[:, sc])
                         for sc in _thirds(dk)])

    xi, z, y = li.xi, li.z, li.y
    ax = rows(points(xi))
    itdone = torch.full((B,), max_iter, dtype=torch.int32)
    best = torch.full((B,), float("inf"))
    noimp = torch.zeros(B, dtype=torch.int32)
    n_chunks = max(1, -(-max_iter // qp.CHUNK))
    ck = 0
    while ck < n_chunks:
        xip = xi
        for _ in range(qp.CHUNK):
            g = adjoint(rho * z - y)
            rhs = (sigma.double() * xi.double() - li.qn.double()) + g
            xt = solve(rhs.reshape(B, -1)).view(B, dim, K)
            zt = rows(points(xt))
            xi = alpha * xt.float() + beta * xi
            zmix = alpha * zt + beta * z
            zn = torch.minimum(torch.maximum(zmix + y / rho, lo), hi)
            y = y + rho * (zmix - zn)
            z = zn
            ax = alpha * zt + beta * ax
        ck += 1
        viol = torch.clamp(torch.maximum(lo - ax, ax - hi), min=0.0)
        feas = (viol / li.scale).amax(-1) < stop_tol
        aty = adjoint(y).float()
        px = torch.einsum("akl,adl->adk", li.Pn, xi)
        rd = (px + li.qn + aty).abs().reshape(B, -1).amax(-1)
        dmag = torch.maximum(px.abs().reshape(B, -1).amax(-1),
                             torch.maximum(aty.abs().reshape(B, -1).amax(-1),
                                           li.qn.abs().reshape(B, -1).amax(-1)))
        opt = rd < cfg.eps_abs + 1e-3 * dmag
        stalled = (xi - xip).abs().reshape(B, -1).amax(-1) < 1e-4 * torch.clamp(
            xi.abs().reshape(B, -1).amax(-1), min=1.0)
        obj = torch.einsum("adk,adk->a", 0.5 * px + li.qn, xi)
        improved = obj < best - 2e-4 * torch.clamp(obj.abs(), min=1.0)
        best = torch.where(feas & improved, obj, best)
        noimp = torch.where(feas & ~improved, noimp + 1, 0).to(torch.int32)
        done = feas & (opt | stalled | (noimp >= 2))
        itdone = torch.where(done & (itdone == max_iter), ck * qp.CHUNK, itdone).to(torch.int32)
        if bool(done.all()):
            break
    return xi, z, y, itdone, torch.tensor(ck * qp.CHUNK, dtype=torch.int32)


# (build_fleet overrides, agents): dim·K 84 (3-D LSC, the bench's 8b), 90
# (3-D DLSC, 8e) and 68 (2-D at M = 12)
TWIN_CASES = {84: (dict(world_dimension=3), 12),
              90: (dict(world_dimension=3, planner_mode=PlannerMode.DLSC), 12),
              68: (dict(M=12), 12)}


@pytest.fixture(scope="module", params=sorted(TWIN_CASES))
def twin_qp(request):
    """The port's QP (plain body, CPU) of a fleet after 2 evolving steps."""
    over, A = TWIN_CASES[request.param]
    p, planner, fleet, inp = workload.build_fleet(A, device="cpu", **over)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(2):
        inp, _ = step(inp)
    cfg = planner.qp_cfg
    assert cfg.dim * qp.torch_statics(cfg, torch.device("cpu"))["K"] == request.param
    qp_inp = planner._step_impl(fleet, inp, defer_qp=True).qp_inp
    return request.param, cfg, qp.prepare(cfg, qp_inp).loop, planner.feas_tol


def test_twin_matches_plain_loop(twin_qp):
    """The twin's run to its exit against the plain loop's: the exit
    within the float32 plain loop's own exits when its inputs move by one
    ulp (`test_torch_admm_cluster._plain_exits`); every chunk of the twin,
    from the twin's state, held to the plain chunk from the same state by
    tests/test_torch_cuda.py's `_chunk_held` (per agent within the loop
    tolerance, or by its float64 clause); the run is its chain of single
    chunks, bit for bit."""
    from test_torch_admm_cluster import _plain_exits
    from test_torch_cuda import _chunk_held

    dk, cfg, li, feas_tol = twin_qp
    got = triple_twin(cfg, li, cfg.max_iter, feas_tol)
    exits = _plain_exits(cfg, li, feas_tol)
    assert min(exits) <= int(got[4]) <= max(exits), (int(got[4]), sorted(exits))
    state = li
    for _ in range(int(got[4]) // qp.CHUNK):
        k = triple_twin(cfg, state, qp.CHUNK, feas_tol)
        _chunk_held(cfg, state, k, qp.admm_loop_plain(cfg, state, qp.CHUNK, feas_tol), feas_tol)
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)


def test_twin_whole_run_is_held_to_float64(twin_qp):
    """The twin's whole run against the float64 plain loop, as
    tests/test_torch_cuda.py holds the kernel's (`qp_check.whole_run_f64`)."""
    dk, cfg, li, feas_tol = twin_qp
    got = triple_twin(cfg, li, cfg.max_iter, feas_tol)
    rec = qp_check.whole_run_f64(cfg, li, got)
    assert rec["agents_failed"] == 0, rec


def _jax_cfg_inputs(jqp, cfg, qp_inp):
    """The JAX package's QPConfig and QPInputs of the port's."""
    import jax.numpy as jnp

    jcfg = jqp.QPConfig(**{f: getattr(cfg, f) for f in jqp.QPConfig._fields
                           if f != "rho_eq"}, rho_eq=cfg.rho)
    jin = jqp.QPInputs(**{f: None if getattr(qp_inp, f) is None
                          else jnp.asarray(getattr(qp_inp, f).numpy())
                          for f in jqp.QPInputs._fields})
    return jcfg, jin


def test_twin_solve_matches_jax(monkeypatch):
    """`qp.solve` on the CPU with the twin as its loop (the port's plain
    preparation before it, its rescue and finish after it) against the
    JAX package's `solve` on the same QP inputs (the port's 3-D fleet of
    8, dim·K 84, after 2 evolving steps), with tests/test_torch_qp.py's
    contract: as many agents converged less one, objectives within
    rtol/atol 2e-2 and control points within 0.1 m where both converged."""
    from lsc_dr_planner_tpu.ops import qp as jqp
    from test_torch_qp import check_contract

    p, planner, fleet, inp = workload.build_fleet(8, device="cpu", world_dimension=3)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(2):
        inp, _ = step(inp)
    cfg, feas_tol = planner.qp_cfg, planner.feas_tol
    qp_inp = planner._step_impl(fleet, inp, defer_qp=True).qp_inp
    assert cfg.dim * qp.torch_statics(cfg, torch.device("cpu"))["K"] == 84
    ref = jqp.solve(*_jax_cfg_inputs(jqp, cfg, qp_inp), feas_tol=feas_tol)
    calls = []

    def twin_loop(cfg_, li, max_iter, feas_tol_, plain=False):
        calls.append(max_iter)
        return triple_twin(cfg_, li, max_iter, feas_tol_)

    monkeypatch.setattr(qp, "run_loop", twin_loop)
    out = qp.solve(cfg, qp_inp, feas_tol=feas_tol)
    assert calls[0] == cfg.max_iter
    check_contract(out, ref, feas_tol, full_convergence=False)
    assert np.isfinite(out.x.numpy()).all()
