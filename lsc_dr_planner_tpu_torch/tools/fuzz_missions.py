"""Out-of-distribution deadlock fuzzing (port of tools/fuzz_missions.py).

The waypoint layer's escalation constants (retreat, no-progress and MCP
fallback windows, sim/simulator.py) were tuned on the reference's
acceptance missions; this harness guards their generalization: random
worlds (forest-like scatter and maze-like wall fields), random fleets
(8-32 agents by default), each waypoint-layer mode forced, and every run
must finish collision-free with zero dynamic-limit excess, no QP
failure and a finite flight time (no deadlock).

Starts and goals are rejection-sampled away from obstacles and checked
for grid connectivity (a disconnected goal would read as a deadlock and
is an artifact of the generator, not a planner failure).

One JSON row per (seed, layer), appended to `--out`/fuzz.jsonl (pairs
already there are skipped), with `device`: the card's name and power
limit.

    python -m lsc_dr_planner_tpu_torch.tools.fuzz_missions [--n 200] [--seed0 1000]
        [--out log/torch_fuzz] [--budget S] [--smoke] [--amin 8] [--amax 32]
        [--layers hybrid,mcp] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import deque

import numpy as np

from lsc_dr_planner_tpu_torch.config import Param
from lsc_dr_planner_tpu_torch.device import DEFAULT as DEFAULT_DEVICE
from lsc_dr_planner_tpu_torch.device import describe
from lsc_dr_planner_tpu_torch.device import resolve as resolve_device
from lsc_dr_planner_tpu_torch.mission import generate_random_mission
from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

LOG_DIR = "log/fuzz_sim"  # the simulators' log directory (nothing is written there)


def random_world(rng, kind, half):
    """Random obstacle boxes [N, 6] (cx, cy, cz, sx, sy, sz)."""
    boxes = []
    if kind == "forest":
        n = int(rng.integers(10, 40))
        for _ in range(n):
            s = rng.uniform(0.3, 0.9)
            cx, cy = rng.uniform(-half + 1, half - 1, 2)
            boxes.append([cx, cy, 1.0, s, s, 2.0])
    else:  # maze-like wall field
        # Wall centre lines snap to the 0.5 m MAPF grid's cell-centre
        # lattice, like the reference's maze worlds: a thin wall at an
        # arbitrary offset can slice the transition between two free
        # cell centres without marking either cell occupied, a world
        # outside the cell-based grid semantics of the reference and of
        # this repo, which livelocks the waypoint layer by construction.
        def snap_center(v):
            # grid nodes sit on multiples of 0.5 (build_coarse_grid)
            return np.round(v / 0.5) * 0.5

        n = int(rng.integers(6, 16))
        for _ in range(n):
            L = rng.uniform(1.0, 2.0 * half - 2.0)
            cx, cy = rng.uniform(-half + 1, half - 1, 2)
            if rng.random() < 0.5:
                boxes.append([cx, snap_center(cy), 1.0, L, 0.1, 2.0])
            else:
                boxes.append([snap_center(cx), cy, 1.0, 0.1, L, 2.0])
    return np.asarray(boxes).reshape(-1, 6)


def _occ_grid(boxes, half, res, clearance):
    n = int(np.ceil(2 * half / res))
    occ = np.zeros((n, n), bool)
    xs = -half + (np.arange(n) + 0.5) * res
    for cx, cy, _, sx, sy, _ in boxes:
        x0 = cx - sx / 2 - clearance
        x1 = cx + sx / 2 + clearance
        y0 = cy - sy / 2 - clearance
        y1 = cy + sy / 2 + clearance
        ix = np.nonzero((xs > x0) & (xs < x1))[0]
        iy = np.nonzero((xs > y0) & (xs < y1))[0]
        if len(ix) and len(iy):
            occ[ix[0]:ix[-1] + 1, iy[0]:iy[-1] + 1] = True
    return occ, xs


def _connected(occ, a, b):
    if occ[a] or occ[b]:
        return False
    seen = {a}
    q = deque([a])
    X, Y = occ.shape
    while q:
        x, y = q.popleft()
        if (x, y) == b:
            return True
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nx, ny = x + dx, y + dy
            if 0 <= nx < X and 0 <= ny < Y and not occ[nx, ny] \
                    and (nx, ny) not in seen:
                seen.add((nx, ny))
                q.append((nx, ny))
    return False


def make_mission(rng, A, boxes, half, radius=0.15):
    """Random mission with obstacle-clear, pairwise-separated,
    connectivity-checked starts and goals on the 0.5 m grid (None when
    the draws fail)."""
    res = 0.5
    occ, xs = _occ_grid(boxes, half, res, clearance=radius + 0.2)

    def box_clearance(pt):
        """L2 distance from pt to the nearest box (2-D)."""
        if len(boxes) == 0:
            return np.inf
        b = np.asarray(boxes)
        dx = np.maximum(np.abs(pt[0] - b[:, 0]) - b[:, 3] / 2, 0.0)
        dy = np.maximum(np.abs(pt[1] - b[:, 1]) - b[:, 4] / 2, 0.0)
        return float(np.min(np.hypot(dx, dy)))

    def cell_of(p):
        return (int(np.clip((p[0] + half) / res, 0, len(xs) - 1)),
                int(np.clip((p[1] + half) / res, 0, len(xs) - 1)))

    free_cells = np.argwhere(~occ)
    if len(free_cells) < 4 * A:
        return None

    def sample_set(exclude):
        pts = []
        for _ in range(A):
            for _a in range(3000):
                c = free_cells[rng.integers(len(free_cells))]
                p = np.array([-half + (c[0] + 0.5) * res,
                              -half + (c[1] + 0.5) * res])
                p = np.round(p / res) * res
                # rounding to the 0.5 m lattice can push an edge cell out
                # of the world box (5.85 → 6.0 > half = 5.9): an agent
                # born outside the fine lattice is infeasible from step 0
                if np.max(np.abs(p)) > half - 0.3:
                    continue
                if occ[cell_of(p)]:
                    continue
                # the rounded point must itself be reachable: within
                # radius + 0.25 of a box face the fine lattice's inflation
                # blocks its cell, no SFC can contain it, and a goal there
                # pins the goal LP 0.25 m short forever
                if box_clearance(p) < radius + 0.25:
                    continue
                if all(np.linalg.norm(p - q) >= 0.7 for q in pts + exclude):
                    pts.append(p)
                    break
            else:
                return None
        return pts

    starts = sample_set([])
    if starts is None:
        return None
    goals = sample_set([])
    if goals is None:
        return None
    for s, g in zip(starts, goals):
        if not _connected(occ, cell_of(s), cell_of(g)):
            return None

    m = generate_random_mission(
        A, [-half, -half, 0.0], [half, half, 2.5], radius=radius, seed=0,
        min_separation=0.0,
    )
    m.world_boxes = boxes
    for i, a in enumerate(m.agents):
        a.start = np.array([starts[i][0], starts[i][1], 0.6])
        a.goal = np.array([goals[i][0], goals[i][1], 0.6])
    return m


def case_mission(seed, A=None, amin=8, amax=32):
    """(A, kind, mission or None) of one seed: the fleet size (A, or drawn
    in [amin, amax]), the world kind, and up to 20 draws of world and
    mission."""
    rng = np.random.default_rng(seed)
    A = A if A is not None else int(rng.integers(amin, amax + 1))
    kind = "forest" if rng.random() < 0.5 else "maze"
    # the world is sized for ~1.5× the reference benchmark's agent density
    # (forest10: 10 agents / 100 m²); above ~0.3 agents/m² the DR flow
    # layer wedges (collision-free, frozen), a known limit well outside
    # the reference's envelope and not what this harness guards
    half = max(4.0, 1.3 * np.sqrt(A) + (2.0 if kind == "maze" else 0.0))
    mission = None
    for _try in range(20):
        boxes = random_world(rng, kind, half)
        mission = make_mission(rng, A, boxes, half)
        if mission is not None:
            break
    return A, kind, mission


def run_case(seed, layer, A=None, amin=8, amax=32, device=DEFAULT_DEVICE, log_dir=LOG_DIR):
    A, kind, mission = case_mission(seed, A, amin, amax)
    if mission is None:
        return {"seed": seed, "skip": "generation failed"}

    # a generous upper bound on a deadlock-free mission's duration
    max_iter = 250 + 12 * A
    param = Param(
        world_dimension=2, world_use_octomap=True, communication_range=3.0,
        multisim_max_planner_iteration=max_iter, profile_stages=False,
        mapf_layer=layer,
    )
    sim = MultiSyncSimulator(param, mission, log_dir=log_dir, device=device)
    t0 = time.time()
    r = sim.run()
    r.update(seed=seed, layer=layer, A=A, kind=kind,
             wall_s=round(time.time() - t0, 1),
             n_boxes=int(len(mission.world_boxes)))
    r["clean"] = bool(
        not r["is_collided"] and not r["qp_failed"]
        and np.isfinite(r["total_flight_time"])
        and r["vel_excess_ratio"] == 0.0 and r["acc_excess_ratio"] == 0.0
    )
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--seed0", type=int, default=1000)
    ap.add_argument("--out", default="log/torch_fuzz")
    ap.add_argument("--budget", type=float, default=1e9)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--amin", type=int, default=8)
    ap.add_argument("--amax", type=int, default=32)
    ap.add_argument("--layers", default="hybrid,mcp",
                    help="comma list of forced layer modes per seed")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    label = describe(dev)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "fuzz.jsonl")
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                    done.add((row["seed"], row.get("layer")))
                except (ValueError, KeyError):
                    pass

    t0 = time.time()
    n_run = n_clean = 0
    rows = []
    for i in range(args.n):
        seed = args.seed0 + i
        # each forced layer mode in turn (every one must be deadlock-free)
        layers = tuple(args.layers.split(",")) if not args.smoke else ("auto",)
        for layer in layers:
            if (seed, layer) in done:
                continue
            if time.time() - t0 > args.budget:
                print(f"# budget reached ({n_run} run)", flush=True)
                return rows
            r = run_case(seed, layer, amin=args.amin, amax=args.amax, device=dev)
            r["device"] = label
            with open(path, "a") as f:
                f.write(json.dumps(r) + "\n")
            rows.append(r)
            if "skip" in r:
                print(f"seed {seed}: SKIP ({r['skip']})", flush=True)
                continue
            n_run += 1
            n_clean += int(r["clean"])
            print(
                f"seed {seed} {layer}: A={r['A']} {r['kind']} "
                f"flight={r['total_flight_time']:.1f}s "
                f"{'CLEAN' if r['clean'] else 'DIRTY'}",
                flush=True,
            )
    print(f"# fuzz done: {n_clean}/{n_run} clean", flush=True)
    return rows


if __name__ == "__main__":
    main()
