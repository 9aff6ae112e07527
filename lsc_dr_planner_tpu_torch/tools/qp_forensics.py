"""QP convergence forensics (port of tools/qp_forensics.py): which agents
of the bench workload (`workload.build_fleet(A)`, evolving along its own
plan) the QP leaves unconverged, from the solver's own `qp_residual` and
`qp_iterations`, and whether the iteration cap or an infeasible QP
holds them back.

One JSON row per step (the JAX tool's fields: convergence, the count
and first ten residuals and iterations of the unconverged agents, the
residual and iteration percentiles). If the last step leaves agents
unconverged, that step's state is solved again by a second
`FleetPlanner` at `qp_max_iter=1000`: a residual that drops was short of
iterations, one that stays flat is an infeasible QP (the failsafe by
design). The JAX tool re-solves the state one step later, whose agents
are not those its row lists; here both rows read the same state.

`--set KEY=VALUE` sets a `Param` field over the bench configuration, as
`workload.build_fleet(A, **overrides)` takes it (an enum by its member's
name), for instance DLSC sub-step:
`--set planner_mode=DLSC --set multisim_time_step=0.1`.

    python -m lsc_dr_planner_tpu_torch.tools.qp_forensics [--A 1024] [--steps 8]
        [--set KEY=VALUE ...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json

import numpy as np

from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.config import Param
from lsc_dr_planner_tpu_torch.device import DEFAULT as DEFAULT_DEVICE
from lsc_dr_planner_tpu_torch.planner.pipeline import FleetPlanner

RESOLVE_ITER = 1000


def parse_overrides(items) -> dict:
    """["KEY=VALUE", ...] → Param overrides, each VALUE read as its
    field's default is typed (an enum by its member's name)."""
    defaults = {f.name: f.default for f in dataclasses.fields(Param)}
    out = {}
    for item in items:
        key, sep, value = item.partition("=")
        if not sep or key not in defaults:
            raise ValueError(f"--set wants KEY=VALUE with KEY a Param field, got {item!r}")
        kind = type(defaults[key])
        if issubclass(kind, enum.Enum):
            out[key] = kind[value.upper()]
        elif kind is bool:
            out[key] = value.lower() in ("1", "true", "yes")
        elif kind in (int, float, str):
            out[key] = kind(value)
        else:
            raise ValueError(f"--set cannot set {key} (a {kind.__name__})")
    return out


def host(out):
    """(qp_residual, qp_iterations, qp_converged) of a step's outputs in numpy."""
    return (out.qp_residual.float().cpu().numpy(), out.qp_iterations.cpu().numpy(),
            out.qp_converged.cpu().numpy())


def step_row(k: int, res, its, conv) -> dict:
    """The JAX tool's row of step k from its QP's residuals, iterations
    and converged flags [A] (numpy)."""
    bad = np.nonzero(~conv)[0]
    row = {
        "step": k,
        "conv_rate": round(float(conv.mean()), 4),
        "n_bad": int(len(bad)),
        "res_p50": round(float(np.percentile(res, 50)), 5),
        "res_max": round(float(res.max()), 4),
        "iters_p50": int(np.percentile(its, 50)),
        "iters_max": int(its.max()),
    }
    if len(bad):
        row["bad_residuals"] = [round(float(res[i]), 4) for i in bad[:10]]
        row["bad_iters"] = [int(its[i]) for i in bad[:10]]
    return row


def run(A: int, steps: int, device=DEFAULT_DEVICE, **overrides):
    """The rows of `steps` (≥ 1) evolving steps at A agents, then the
    re-solve row if the last step left agents unconverged."""
    p, planner, fleet, inp = workload.build_fleet(A, device=device, **overrides)
    rows, out = [], None
    for k in range(steps):
        if out is not None:
            inp = workload.advance(p, inp, out)
        out = planner.step(fleet, inp)
        rows.append(step_row(k, *host(out)))
        print(json.dumps(rows[-1]), flush=True)
    res, _, conv = host(out)
    bad = np.nonzero(~conv)[0]
    if len(bad):
        planner2 = FleetPlanner(dataclasses.replace(p, qp_max_iter=RESOLVE_ITER), planner.world,
                                A, max_dynobs=0, agent_radius=0.15, max_vel_hint=1.0)
        out2 = planner2.step(fleet, inp)
        res2, _, conv2 = host(out2)
        rows.append({
            "note": f"same state re-solved at max_iter={RESOLVE_ITER}",
            "conv_rate_1000": round(float(conv2.mean()), 4),
            "bad_res_200_vs_1000": [[round(float(res[i]), 4), round(float(res2[i]), 4)]
                                    for i in bad[:10]],
            "still_bad": int(np.sum(~conv2)),
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--A", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="a Param field over the bench configuration (repeatable)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    return run(args.A, args.steps, args.device, **parse_overrides(args.set))


if __name__ == "__main__":
    main()
