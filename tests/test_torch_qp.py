"""Parity of the port's batched ADMM QP with the JAX package.

The JAX side runs as its own tests run it on the CPU: qp.solve takes the
XLA loop there. The same QP instances (assembled by the JAX pipeline)
go through both solvers. Exact iterate equality is not expected: sums
run in another order, and the patience/stall gates then exit a chunk
earlier or later for a few agents. The contract is the one of
tests/test_qp_pallas.py: feasibility at the gate, objectives within
2e-2 and control points within 0.1 where both converged.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bench
from lsc_dr_planner_tpu.ops import qp as jqp
from lsc_dr_planner_tpu.ops import qp_pallas
from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.ops import qp as tqp
from lsc_dr_planner_tpu_torch.ops import qp_cuda
from tests.test_qp_pallas import _mini_qp

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)


def port_cfg(cfg):
    keep = {f.name for f in dataclasses.fields(tqp.QPConfig)}
    return tqp.QPConfig(**{k: v for k, v in cfg._asdict().items() if k in keep})


def port_inputs(qp_inp, device="cpu"):
    return tqp.QPInputs(**{k: (None if v is None else torch.as_tensor(np.array(v), device=device))
                           for k, v in qp_inp._asdict().items()})


def bench_qp(A, steps=3):
    """The bench fleet's QP after `steps` evolving steps (JAX pipeline)."""
    p, planner, fleet, inp = bench.build_fleet(A)
    step = bench.make_evolve_step(p, planner, fleet)
    for _ in range(steps):
        inp, _ = step(inp)
    d = planner._step_impl(fleet, inp, defer_qp=True)
    return planner.qp_cfg, d.qp_inp, planner.feas_tol


def capture_jax_loop_inputs(monkeypatch, cfg, qp_inp, feas_tol):
    """The JAX solver's loop inputs, taken where it hands them to its
    loop backend (the Pallas entry point, intercepted)."""
    seen = []

    def capture(cfg_, st, normals, Kinv, Pn, qn, ln, un, scale, xi0, z0, y0,
                max_iter, feas_tol_, interpret=False):
        seen.append(dict(normals=normals, Kinv=Kinv, Pn=Pn, qn=qn, ln=ln, un=un,
                         scale=scale, xi=xi0, z=z0, y=y0))
        A = xi0.shape[0]
        return xi0, z0, y0, jax.numpy.full((A,), max_iter, jax.numpy.int32), jax.numpy.int32(0)

    monkeypatch.setattr(qp_pallas, "pallas_mode", lambda: "on")
    monkeypatch.setattr(qp_pallas, "admm_loop_pallas", capture)
    jqp.solve(cfg, qp_inp, feas_tol=feas_tol)
    return {k: np.asarray(v) for k, v in seen[0].items()}


@pytest.fixture(scope="module")
def bench32():
    return bench_qp(32)


def test_prepare_matches_jax(monkeypatch, bench32):
    cfg, qp_inp, feas_tol = bench32
    ref = capture_jax_loop_inputs(monkeypatch, cfg, qp_inp, feas_tol)
    li = tqp.prepare(port_cfg(cfg), port_inputs(qp_inp)).loop
    for name in ("normals", "Pn", "qn", "ln", "un", "scale", "xi", "z", "y"):
        got = getattr(li, name).numpy()
        # float32 einsums in another sum order: 1e-4 relative, plus an
        # absolute floor at 1e-4 of the array's scale for near-zero entries
        # (ln/un carry the ±1e20 vacuous-row sentinel; compare finite rows)
        want = ref[name]
        fin = np.abs(want) < 1e19
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(want[fin]).max()),
                                   err_msg=name)
        np.testing.assert_array_equal(np.abs(got) >= 1e19, ~fin, err_msg=name)
    # Kinv inverts a KKT matrix of condition ~1.6e5 in float32, so each
    # package's Kinv carries a relative error of order cond·eps ≈ 1e-2
    # (measured 3.7e-3 Frobenius between the two): compare it through its
    # action on the reference KKT matrix (float64 inverse of the JAX Kinv)
    kt = li.Kinv.numpy().astype(np.float64)
    kj = ref["Kinv"].astype(np.float64)
    rel = np.linalg.norm(kt - kj, axis=(1, 2)) / np.linalg.norm(kj, axis=(1, 2))
    assert rel.max() < 1e-2, rel.max()
    resid = np.einsum("aij,ajk->aik", kt, np.linalg.inv(kj)) - np.eye(kt.shape[-1])
    assert np.abs(resid).max() < 2e-2, np.abs(resid).max()


def check_contract(res_t, res_j, feas_tol, full_convergence):
    conv_t = res_t.converged.numpy()
    conv_j = np.asarray(res_j.converged)
    if full_convergence:
        assert conv_j.all() and conv_t.all(), (conv_j, conv_t)
    # the port certifies at least as many agents as the reference, less a
    # straggler (iterate rounding can move one agent across the gate)
    assert conv_t.sum() >= conv_j.sum() - 1, (conv_t.mean(), conv_j.mean())
    both = conv_t & conv_j
    assert res_t.primal_residual.numpy()[conv_t].max(initial=0.0) < feas_tol
    obj_t = res_t.objective.numpy()[both]
    obj_j = np.asarray(res_j.objective)[both]
    np.testing.assert_allclose(obj_t, obj_j, rtol=2e-2, atol=2e-2)
    dx = np.abs(res_t.x.numpy() - np.asarray(res_j.x))[both]
    assert dx.max(initial=0.0) < 0.1


def test_solve_mini_qp():
    cfg, qp_inp, feas_tol = _mini_qp()
    ref = jqp.solve(cfg, qp_inp, feas_tol=feas_tol)
    out = tqp.solve(port_cfg(cfg), port_inputs(qp_inp), feas_tol=feas_tol)
    check_contract(out, ref, feas_tol, full_convergence=True)


def test_solve_bench32_in_place_rescue(bench32):
    cfg, qp_inp, feas_tol = bench32
    assert qp_inp.p0.shape[0] <= tqp.RESCUE and cfg.rescue_iter > 0
    ref = jqp.solve(cfg, qp_inp, feas_tol=feas_tol)
    out = tqp.solve(port_cfg(cfg), port_inputs(qp_inp), feas_tol=feas_tol)
    check_contract(out, ref, feas_tol, full_convergence=False)
    assert out.converged.numpy().mean() > 0.9


def test_solve_bench72_compacted_rescue():
    cfg, qp_inp, feas_tol = bench_qp(72, steps=2)
    ref = jqp.solve(cfg, qp_inp, feas_tol=feas_tol)
    out = tqp.solve(port_cfg(cfg), port_inputs(qp_inp), feas_tol=feas_tol)
    check_contract(out, ref, feas_tol, full_convergence=False)
    assert out.converged.numpy().mean() > 0.9


def test_solve_cold_duals_and_short_budget():
    """Without rescue and without a dual warm start the port still tracks
    the reference (iterations bounded by max_iter)."""
    cfg, qp_inp, feas_tol = _mini_qp()
    cfg = cfg._replace(rescue_iter=0, max_iter=64)
    ref = jqp.solve(cfg, qp_inp, feas_tol=feas_tol)
    out = tqp.solve(port_cfg(cfg), port_inputs(qp_inp), feas_tol=feas_tol)
    assert out.iterations.numpy().max() <= 64
    check_contract(out, ref, feas_tol, full_convergence=False)


@pytest.mark.parametrize("A", [12, 72])
def test_solve_f64_is_the_plain_solve_in_float64(A):
    """`qp_check.solve_f64` (the float64 reference of the wide solves on
    the card), with its in-place (A=12) and compacted (A=72) rescue: the
    plain path in float64 throughout, which certifies as many agents as
    the float32 plain solve and lies within 0.1 m of it where both
    converged."""
    from lsc_dr_planner_tpu_torch.ops import qp_check

    p, planner, fleet, inp = workload.build_fleet(A, device="cpu")
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(2):
        inp, _ = step(inp)
    cfg, feas_tol = planner.qp_cfg, planner.feas_tol
    qp_inp = planner._step_impl(fleet, inp, defer_qp=True).qp_inp
    out = tqp.solve(cfg, qp_inp, feas_tol)
    exact = qp_check.solve_f64(cfg, qp_inp, feas_tol)
    assert exact.x.dtype == exact.z.dtype == exact.objective.dtype == torch.float64
    assert exact.converged.sum() >= out.converged.sum() - 1
    both = out.converged & exact.converged
    assert both.float().mean() > 0.9
    assert (out.x.double() - exact.x).abs()[both].max() < 0.1


def test_rescue_batch_takes_the_worst_agents_first():
    """`rescue_batch` (the compacted rescue of `solve`): the RESCUE most
    infeasible agents of the iterate, worst first, and the rescue's loop
    inputs start from their iterate."""
    p, planner, fleet, inp = workload.build_fleet(72, device="cpu")
    pcfg, feas_tol = planner.qp_cfg, planner.feas_tol
    li = tqp.prepare(pcfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp).loop
    xi, z, y = tqp.admm_loop_plain(pcfg, li, 16, feas_tol)[:3]
    # push every other agent off its iterate by a seeded amount, so that
    # the infeasible ones differ in how far they are out
    rng = np.random.default_rng(0)
    A = xi.shape[0]
    amp = rng.uniform(0.0, 0.05, (A, 1, 1)) * (np.arange(A) % 2)[:, None, None]
    xi = xi + torch.as_tensor(rng.standard_normal(xi.shape) * amp, dtype=xi.dtype)
    idx, take, sub = tqp.rescue_batch(pcfg, li, xi, z, y, feas_tol)
    ts = tqp.torch_statics(pcfg, li.xi.device)
    Ax = tqp._fwd(pcfg, ts, li.normals, xi)
    resc = (torch.clamp(torch.maximum(li.ln - Ax, Ax - li.un), min=0.0) / li.scale).amax(-1)
    bad = resc >= 0.6 * feas_tol
    assert idx.shape == (tqp.RESCUE,) and len(set(idx.tolist())) == tqp.RESCUE
    assert torch.equal(take, bad[idx])
    assert 0 < int(bad.sum()) < li.xi.shape[0]
    # every agent left out is no worse than every infeasible agent taken
    left = torch.ones(li.xi.shape[0], dtype=torch.bool)
    left[idx] = False
    key = torch.where(bad, resc, -1.0)
    assert (key[idx][:-1] >= key[idx][1:]).all()
    assert key[left].max() <= key[idx][take].min()
    for name in ("normals", "Kinv", "ln", "un", "rho", "scale"):
        assert torch.equal(getattr(sub, name), getattr(li, name)[idx])
    assert torch.equal(sub.xi, xi[idx]) and torch.equal(sub.y, y[idx])


def test_wrapper_takes_plain_loop_on_cpu():
    cfg, qp_inp, feas_tol = _mini_qp()
    pcfg = port_cfg(cfg)
    li = tqp.prepare(pcfg, port_inputs(qp_inp)).loop
    before = qp_cuda.launches
    got = tqp.run_loop(pcfg, li, 40, feas_tol)
    want = tqp.admm_loop_plain(pcfg, li, 40, feas_tol)
    assert qp_cuda.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel wrapper itself never falls back: CPU tensors raise
    before anything is built or launched."""
    cfg, qp_inp, feas_tol = _mini_qp()
    pcfg = port_cfg(cfg)
    li = tqp.prepare(pcfg, port_inputs(qp_inp)).loop
    ts = tqp.torch_statics(pcfg, li.xi.device)
    before = qp_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        qp_cuda.admm_loop_cuda(li, ts["stencil"], ts["N3k"], ts["N3kT"],
                               pcfg.rho * tqp._RHO_SCALE["lsc"], 40, tqp.CHUNK,
                               0.6 * feas_tol, pcfg.sigma, pcfg.alpha, pcfg.eps_abs)
    assert qp_cuda.launches == before

