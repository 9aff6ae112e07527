"""The one QP the main path leaves unconverged, held to the JAX package.

`chip_smoke.py`'s main path (`workload.build_fleet(1024)`, 20 evolving
steps on the card) leaves one agent unconverged in one step: agent 840
at step 6, under the CUDA kernel and under the plain loop on the card
alike (`chip_smoke.py::unconverged_steps`, which writes that step's QP
inputs to `chiprun_out/unconverged_qp_step6.npz`). The fixture
`tests/fixtures/qp_step6_agents840_0.npz` keeps agents 840 and 0 of that
state (`python tests/test_torch_qp_straggler.py fixture <that npz>`
makes it): a batch of two, which the port's plain loop solves as it
solves the whole batch of 1,024 (the same residual for agent 840).

Here, on the CPU, the JAX package's solver and the port's plain loop
both leave agent 840 unconverged at the same residual, just over the
tolerance, and both converge agent 0 to the same plan: the state, not
the port, holds the agent. `JAX_PLATFORMS=cpu python
tests/test_torch_qp_straggler.py report` prints each solver's verdict
on the pair and on agent 840 alone, and how far the reduced linear term
`qn` of agent 840 moves between the two batch sizes (float32 cancellation: `qn` is a difference of terms of
order |P|·|p0| ≈ 1e6).
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "qp_step6_agents840_0.npz"
AGENTS = (840, 0)

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)


def load(sel=slice(None)):
    """(cfg dict, feas_tol, {QPInputs field: numpy [B, ...]}) of the
    fixture's agents `sel`."""
    z = np.load(FIXTURE)
    fields = {k: z[k][sel] for k in z.files if k not in ("cfg", "feas_tol", "agents", "step")}
    return json.loads(str(z["cfg"])), float(z["feas_tol"]), fields


def solve_port(sel=slice(None)):
    from lsc_dr_planner_tpu_torch.ops import qp as tqp

    cfg, tol, f = load(sel)
    inp = tqp.QPInputs(**{k: torch.as_tensor(v) for k, v in f.items()})
    return tqp.solve(tqp.QPConfig(**cfg), inp, tol)


def solve_jax(sel=slice(None)):
    import jax.numpy as jnp

    from lsc_dr_planner_tpu.config import Param
    from lsc_dr_planner_tpu.ops import qp as jqp

    cfg, tol, f = load(sel)
    jcfg = jqp.QPConfig(**cfg, rho_eq=Param().qp_rho_eq)
    return jqp.solve(jcfg, jqp.QPInputs(**{k: jnp.asarray(v) for k, v in f.items()}), tol)


def verdicts(res):
    return (np.asarray(res.converged), np.asarray(res.primal_residual),
            np.asarray(res.iterations))


def test_step6_agent840_unconverged_in_both_packages():
    """On the pair, both solvers leave agent 840 unconverged after every
    iteration of the loop and the rescue, at residuals within 5% of each
    other, between the tolerance and 1.2 times it; both converge agent 0
    to the same plan (objective 2e-2, control points 0.1: the contract of
    tests/test_torch_qp.py)."""
    cfg, tol, _ = load()
    conv_t, res_t, it_t = verdicts(solve_port())
    res_jx = solve_jax()
    conv_j, res_j, it_j = verdicts(res_jx)
    budget = cfg["max_iter"] + cfg["rescue_iter"]
    assert not conv_t[0] and not conv_j[0], (res_t[0], res_j[0])
    assert it_t[0] == it_j[0] == budget, (it_t[0], it_j[0])
    assert tol < res_t[0] < 1.2 * tol and tol < res_j[0] < 1.2 * tol, (res_t[0], res_j[0])
    assert abs(res_t[0] - res_j[0]) < 0.05 * res_j[0], (res_t[0], res_j[0])
    assert conv_t[1] and conv_j[1]
    out = solve_port()
    np.testing.assert_allclose(out.objective.numpy()[1], np.asarray(res_jx.objective)[1],
                               rtol=2e-2, atol=2e-2)
    assert np.abs(out.x.numpy()[1] - np.asarray(res_jx.x)[1]).max() < 0.1


def test_step6_pair_is_the_batch_for_agent840():
    """Agent 840's result in a batch of two does not depend on its
    partner: with agent 0 or with itself, the same plan and residual, so
    the pair stands for the batch of 1,024 (a batch of one rounds the
    products of `prepare` otherwise; see `report`)."""
    a = solve_port()
    b = solve_port([0, 0])
    assert torch.equal(a.x[0], b.x[0]) and torch.equal(a.primal_residual[0],
                                                       b.primal_residual[0])


def report():
    """Each solver's verdict on the pair and on agent 840 alone, and the
    move of agent 840's reduced linear term qn between batch sizes."""
    from lsc_dr_planner_tpu_torch.ops import qp as tqp

    cfg, tol, _ = load()
    rows = {}
    for name, solve in (("port_plain_cpu", solve_port), ("jax_cpu", solve_jax)):
        for batch, sel in (("pair", slice(None)), ("alone", slice(0, 1))):
            conv, res, it = verdicts(solve(sel))
            rows[f"{name} {batch}"] = {"converged": bool(conv[0]), "residual": float(res[0]),
                                       "iterations": int(it[0])}
    qn = {}
    for batch, sel in (("pair", slice(None)), ("alone", slice(0, 1))):
        c, _, f = load(sel)
        inp = tqp.QPInputs(**{k: torch.as_tensor(v) for k, v in f.items()})
        loop = tqp.prepare(tqp.QPConfig(**c), inp).loop
        qn[batch] = loop.qn[0].double()
        rows["Pn max"] = float(loop.Pn[0].abs().max())
    rows["qn max"] = float(qn["pair"].abs().max())
    rows["qn max move alone vs pair"] = float((qn["pair"] - qn["alone"]).abs().max())
    print(json.dumps({"tol": tol, **rows}, indent=1))


def make_fixture(dump):
    """The fixture from chip_smoke.py's dump of step 6: agents 840 and 0."""
    z = np.load(dump)
    sel = list(AGENTS)
    np.savez_compressed(FIXTURE, cfg=z["cfg"], feas_tol=z["feas_tol"], agents=np.array(sel),
                        step=np.array(6), **{k: z[k][sel] for k in z.files
                                             if k not in ("cfg", "feas_tol")})


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    if sys.argv[1:2] == ["fixture"]:
        make_fixture(sys.argv[2])
    else:
        report()
