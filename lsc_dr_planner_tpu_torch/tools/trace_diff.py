"""Where two simulation CSVs of the same mission first diverge (port of
tools/trace_diff.py, on the port's `sim.replay.read_csv`).

Everything before the first divergence is the same flight, so the row it
reports is where the two runs first took a different decision (a goal-LP
gate, a MAPF waypoint, the QP's exit chunk): compare, for instance, the
JAX package's CSV with the port's, or two commits.

    python -m lsc_dr_planner_tpu_torch.tools.trace_diff a.csv b.csv [--tol 1e-3]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from lsc_dr_planner_tpu_torch.sim.replay import ReplayLog, read_csv


def first_divergence(la: ReplayLog, lb: ReplayLog, tol: float) -> Optional[dict]:
    """The first row where an agent's positions differ by more than
    `tol` m (max norm) over the rows both logs have: its row, time,
    agents and largest difference, and the difference's growth after it
    (rows +10, +50 and the last). None when there is no such row."""
    assert la.qn == lb.qn, (la.qn, lb.qn)
    T = min(len(la.times), len(lb.times))
    per_agent = np.max(np.abs(la.agent_states[:T, :, :3] - lb.agent_states[:T, :, :3]),
                       axis=2)  # [T, A]
    d = per_agent.max(axis=1, initial=0.0)
    idx = np.nonzero(d > tol)[0]
    if len(idx) == 0:
        return None
    t0 = int(idx[0])
    marks = dict.fromkeys([t0, min(t0 + 10, T - 1), min(t0 + 50, T - 1), T - 1])
    return {"row": t0, "t": float(la.times[t0]),
            "agents": np.nonzero(per_agent[t0] > tol)[0].tolist(), "max": float(d[t0]),
            "growth": [{"row": t, "t": float(la.times[t]), "max": float(d[t]),
                        "agents_over_tol": int((per_agent[t] > tol).sum())} for t in marks]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csv_a")
    ap.add_argument("csv_b")
    ap.add_argument("--tol", type=float, default=1e-3,
                    help="position divergence threshold [m]")
    args = ap.parse_args(argv)

    la, lb = read_csv(args.csv_a), read_csv(args.csv_b)
    T = min(len(la.times), len(lb.times))
    div = first_divergence(la, lb, args.tol)
    if div is None:
        d = np.abs(la.agent_states[:T, :, :3] - lb.agent_states[:T, :, :3])
        print(f"identical to {args.tol} m over {T} rows (max diff {d.max(initial=0.0):.2e} m)")
    else:
        print(f"first divergence at row {div['row']} (t={div['t']:.2f}s): "
              f"agents {div['agents']}, max {div['max']:.4f} m")
        for g in div["growth"]:
            print(f"  t={g['t']:7.2f}s  max diff {g['max']:8.4f} m  "
                  f"agents>{args.tol}: {g['agents_over_tol']}")
    if len(la.times) != len(lb.times):
        print(f"run lengths differ: {len(la.times)} vs {len(lb.times)} rows "
              f"({la.times[-1]:.1f}s vs {lb.times[-1]:.1f}s)")
    return div


if __name__ == "__main__":
    main()
