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
