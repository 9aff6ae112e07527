"""The CUDA ADMM kernel's row operator, held on the CPU against the dense
operators it replaces.

The kernel takes the static rows (velocity, acceleration, comm pairs,
bounds) as stencils over the control points (`qp.stencil_table`, built
from `_solver_statics`'s A_dim and row order) and the LSC rows through
the control points too. Applied here by a small plain-torch mirror of the
kernel's operator, the table must give the dense `An_stat`·ξ and
`An_stat`ᵀ·w of the port and of the JAX package, and the whole operator
the plain loop's `_fwd` and `_adj`. The table also fixes the row order,
so these cases are the CPU evidence that the kernel's layout is right.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu.ops import qp as jqp
from lsc_dr_planner_tpu.ops import qp_pallas
from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.ops import qp, qp_cuda

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

CPU = torch.device("cpu")
B = 5  # agents


def qp_cfg(dim=2, use_comm=True, n_obs=16):
    """The bench QP configuration (`Param` defaults, M=10, n=5)."""
    return qp.QPConfig(dim=dim, M=10, n=5, phi=3, n_obs=n_obs, use_comm=use_comm,
                       stop_at_horizon=True, dt=0.2, control_input_weight=0.01,
                       terminal_weight=1.0, rho=1.0, sigma=1e-6, alpha=1.6, max_iter=200,
                       eps_abs=1e-3, rescue_iter=800)


def jax_cfg(cfg):
    return jqp.QPConfig(**dataclasses.asdict(cfg), rho_eq=1.0)


def stencil_rows(ts, xi):
    """Static rows [B, R_stat] of ξ [B, dim, K] as the kernel forms them:
    control points VU = N_null·ξ_d, then Σ_e coef·VU[idx]."""
    vu = torch.einsum("mik,adk->admi", ts["N3"], xi).reshape(xi.shape[0], -1)
    st = ts["stencil"]
    return (st["coef"] * vu[:, st["idx"].long()]).sum(-1)


def stencil_adjoint(cfg, ts, w):
    """ξ-space [B, dim, K] of static-row cotangents w [B, R_stat] as the
    kernel forms it: the compressed columns into the control points, then
    one N3k product."""
    st = ts["stencil"]
    ptr = st["adj_ptr"].long()
    col = torch.repeat_interleave(torch.arange(len(ptr) - 1), ptr[1:] - ptr[:-1])
    va = torch.zeros(w.shape[0], len(ptr) - 1, dtype=w.dtype).index_add_(
        1, col, st["adj_coef"] * w[:, st["adj_row"].long()])
    return torch.einsum("mik,admi->adk", ts["N3"], va.reshape(-1, cfg.dim, cfg.M, cfg.N))


def kernel_fwd(cfg, ts, normals, xi):
    """All rows [B, R] as the kernel forms them: LSC rows from the control
    points and the normals, static rows from the stencils."""
    vu = torch.einsum("mik,adk->admi", ts["N3"], xi)
    lsc = torch.einsum("aomd,admi->aomi", normals, vu).reshape(xi.shape[0], -1)
    return torch.cat([lsc, stencil_rows(ts, xi)], dim=-1)


def kernel_adj(cfg, ts, normals, w):
    """Aᵀw as the kernel forms it: LSC and static cotangents summed into
    one control-point accumulator, then one N3k product."""
    Bw, R_lsc = w.shape[0], cfg.n_obs * cfg.M * cfg.N
    wl = w[:, :R_lsc].reshape(Bw, cfg.n_obs, cfg.M, cfg.N)
    va = torch.einsum("aomd,aomi->admi", normals, wl)
    g = torch.einsum("mik,admi->adk", ts["N3"], va)
    return g + stencil_adjoint(cfg, ts, w[:, R_lsc:])


def random_inputs(cfg, ts, dtype, seed=0):
    """ξ [B, dim, K], static cotangents w [B, R_stat], unit normals
    [B, O, M, dim] and all-row cotangents [B, R], from a numpy seed."""
    rng = np.random.default_rng(seed)
    K, R_stat = ts["K"], ts["An_stat"].shape[0]
    nrm = rng.standard_normal((B, cfg.n_obs, cfg.M, cfg.dim))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    R = cfg.n_obs * cfg.M * cfg.N + R_stat
    t = [torch.as_tensor(a, dtype=dtype) for a in (
        rng.standard_normal((B, cfg.dim, K)), rng.standard_normal((B, R_stat)), nrm,
        rng.standard_normal((B, R)))]
    return t


# float32: both sides round each product and sum in float32 (the table's
# 3-term differences of ~N(0, 1) control points, the dense 28- and
# ~400-term products): 2e-5 absolute on entries of order 1 to 10.
TOL = {torch.float64: dict(rtol=1e-12, atol=1e-12), torch.float32: dict(rtol=1e-5, atol=2e-5)}
CASES = [(dim, use_comm, dtype) for dim in (2, 3) for use_comm in (True, False)
         for dtype in (torch.float64, torch.float32)]


@pytest.mark.parametrize("dim,use_comm,dtype", CASES)
def test_stencil_table_is_An_stat(dim, use_comm, dtype):
    cfg = qp_cfg(dim, use_comm)
    ts = qp.torch_statics(cfg, CPU, dtype)
    xi, w, _, _ = random_inputs(cfg, ts, dtype)
    An = ts["An_stat"]
    An_jax = torch.as_tensor(jqp._solver_statics(jax_cfg(cfg))["An_stat"], dtype=dtype)
    assert An.shape == An_jax.shape == (ts["stencil"]["idx"].shape[0], dim * ts["K"])
    rows = stencil_rows(ts, xi)
    adj = stencil_adjoint(cfg, ts, w)
    for dense in (An, An_jax):
        torch.testing.assert_close(rows, xi.reshape(B, -1) @ dense.T, **TOL[dtype])
        torch.testing.assert_close(adj.reshape(B, -1), w @ dense, **TOL[dtype])


@pytest.mark.parametrize("n_obs", [9, 16])
@pytest.mark.parametrize("dim,use_comm,dtype", CASES)
def test_kernel_operator_is_the_plain_loops(n_obs, dim, use_comm, dtype):
    """The whole row operator (LSC and static rows) against the plain
    loop's `_fwd` / `_adj`, at the row counts of the simulator's 10-agent
    fleet (O = 9: 9·60 LSC rows) and of the bench (O = 16)."""
    cfg = qp_cfg(dim, use_comm, n_obs)
    ts = qp.torch_statics(cfg, CPU, dtype)
    xi, _, normals, w = random_inputs(cfg, ts, dtype, seed=n_obs)
    assert w.shape[1] == qp.n_rows(cfg)
    torch.testing.assert_close(kernel_fwd(cfg, ts, normals, xi), qp._fwd(cfg, ts, normals, xi),
                               **TOL[dtype])
    torch.testing.assert_close(kernel_adj(cfg, ts, normals, w), qp._adj(cfg, ts, normals, w),
                               **TOL[dtype])


@pytest.mark.parametrize("dim,use_comm", [(2, True), (2, False), (3, True)])
def test_stencil_table_shape_and_rho(dim, use_comm):
    """At most 3 nonzeros a row, compressed columns that hold every
    nonzero once, and the per-row ρ of the JAX kernel's static rows."""
    cfg = qp_cfg(dim, use_comm)
    tab = qp.stencil_table(cfg)
    R_stat = qp.n_rows(cfg) - cfg.n_obs * cfg.M * cfg.N
    assert tab["idx"].shape == tab["coef"].shape == (R_stat, qp_cuda.STENCIL_WIDTH)
    assert (tab["idx"] < dim * cfg.M * cfg.N).all() and (tab["idx"] >= 0).all()
    nnz = int((tab["coef"] != 0).sum())
    assert tab["adj_ptr"][0] == 0 and tab["adj_ptr"][-1] == nnz == len(tab["adj_row"])
    assert (np.diff(tab["adj_ptr"]) >= 0).all()
    np.testing.assert_array_equal(tab["rho"], qp_pallas._rho_stat(jax_cfg(cfg)))


@pytest.fixture(scope="module")
def fleet32():
    """The port's bench fleet (A=32) and the loop inputs of its first
    step's QP, on the CPU."""
    p, planner, fleet, inp = workload.build_fleet(32, device="cpu")
    qp_inp = planner._step_impl(fleet, inp, defer_qp=True).qp_inp
    return planner.qp_cfg, qp.prepare(planner.qp_cfg, qp_inp).loop


def test_loop_inputs_fit_the_kernel(fleet32):
    """What the kernel takes in place of LoopInputs fields, on the bench
    fleet's QP: li.rho is ρ_lsc on the LSC rows and the table's ρ on the
    static rows for every agent, and every LSC row's u is vacuous."""
    cfg, li = fleet32
    R_lsc = cfg.n_obs * cfg.M * cfg.N
    ts = qp.torch_statics(cfg, CPU)
    assert (li.rho[:, :R_lsc] == torch.tensor(cfg.rho * qp._RHO_SCALE["lsc"])).all()
    assert torch.equal(li.rho[:, R_lsc:], ts["stencil"]["rho"].expand(li.rho.shape[0], -1))
    assert torch.equal(li.rho, ts["kernel_rho"].expand_as(li.rho))
    assert (li.un[:, :R_lsc] >= 1e19).all()
    qp.check_kernel_rows(cfg, li)


@pytest.mark.parametrize("change", ["rho_lsc", "rho_static", "finite_lsc_bound", "rows",
                                    "in_place_after_check"])
def test_kernel_rows_check_rejects_other_inputs(fleet32, change):
    """`run_loop` hands the kernel only loop inputs whose ρ and LSC upper
    bounds are the ones the kernel assumes (it reads neither); an edit
    in place after a passed check is seen too."""
    cfg, li = fleet32
    R_lsc = cfg.n_obs * cfg.M * cfg.N
    rho, un = li.rho.clone(), li.un.clone()
    if change == "in_place_after_check":
        checked = dataclasses.replace(li, rho=rho, un=un)
        qp.check_kernel_rows(cfg, checked)
        qp.check_kernel_rows(cfg, checked)
        un[0, 0] = 1.0
        with pytest.raises(ValueError):
            qp.check_kernel_rows(cfg, checked)
        return
    if change == "rho_lsc":
        rho[3, 7] *= 2
    elif change == "rho_static":
        rho[0, R_lsc + 5] = 1.0
    elif change == "finite_lsc_bound":
        un[1, 2] = 4.0
    else:
        rho, un = rho[:, :-1], un[:, :-1]
    with pytest.raises(ValueError):
        qp.check_kernel_rows(cfg, dataclasses.replace(li, rho=rho, un=un))
