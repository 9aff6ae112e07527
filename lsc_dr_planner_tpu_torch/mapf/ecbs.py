"""ECBS — Enhanced Conflict-Based Search (w-suboptimal MAPF solver).

True two-queue OPEN/FOCAL focal search at both levels, matching the
vendored mapf-IR ECBS. Reference: src/mapf/ecbs.cpp — high-level
OPEN (by LB) / FOCAL (by conflicts, soc) with rebuild-on-LB-change
:12-110, initial prioritized paths :132-180, invoke/replan :183-206,
low-level focal space-time A* with OPEN (by f1) / FOCAL (by f2, f1, −g)
:208-394; first-conflict constraint extraction:
src/mapf/lib_cbs.cpp:18-49. Sub-optimality factor w = 2.0 (ecbs.cpp:5).

Host-side numpy/python — the coarse grids are tiny and ECBS runs per
communication group once per planning step.

A copy of `lsc_dr_planner_tpu/mapf/ecbs.py`,
with its imports pointed at the port (numpy only).
"""

from __future__ import annotations

import heapq
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from lsc_dr_planner_tpu_torch.mapf.grid import _NBR4, bfs_distances

SUB_OPTIMALITY = 2.0
Cell = Tuple[int, int]


def _pad_get(path: List[Cell], t: int) -> Cell:
    return path[t] if t < len(path) else path[-1]


def _makespan(paths: List[List[Cell]]) -> int:
    return max(len(p) - 1 for p in paths)


def _path_cost(path: List[Cell]) -> int:
    """Cost = last timestep the agent moves (reference Paths::getSOC)."""
    g = path[-1]
    c = len(path) - 1
    while c > 0 and path[c - 1] == g:
        c -= 1
    return c


def _soc(paths: List[List[Cell]]) -> int:
    return sum(_path_cost(p) for p in paths)


def _count_conflicts(paths: List[List[Cell]], only_agent: Optional[int] = None,
                     agent_path: Optional[List[Cell]] = None) -> int:
    """Count vertex+swap conflicts (reference Paths::countConflict)."""
    n = len(paths)
    ms = _makespan(paths)
    if agent_path is not None:
        ms = max(ms, len(agent_path) - 1)
    cnt = 0
    if only_agent is not None:
        i = only_agent
        pi = agent_path
        for j in range(n):
            if j == i:
                continue
            for t in range(1, ms + 1):
                if _pad_get(pi, t) == _pad_get(paths[j], t):
                    cnt += 1
                elif (_pad_get(pi, t) == _pad_get(paths[j], t - 1)
                      and _pad_get(pi, t - 1) == _pad_get(paths[j], t)):
                    cnt += 1
        return cnt
    for t in range(1, ms + 1):
        for i in range(n):
            for j in range(i + 1, n):
                if _pad_get(paths[i], t) == _pad_get(paths[j], t):
                    cnt += 1
                elif (_pad_get(paths[i], t) == _pad_get(paths[j], t - 1)
                      and _pad_get(paths[i], t - 1) == _pad_get(paths[j], t)):
                    cnt += 1
    return cnt


def _first_constraints(paths: List[List[Cell]]):
    """First vertex/swap conflict → pair of constraints (agent, t, v, u).

    Reference: LibCBS::getFirstConstraints, lib_cbs.cpp:18-49.
    """
    n = len(paths)
    ms = _makespan(paths)
    for t in range(1, ms + 1):
        for i in range(n):
            for j in range(i + 1, n):
                vi, vj = _pad_get(paths[i], t), _pad_get(paths[j], t)
                if vi == vj:
                    return [(i, t, vi, None), (j, t, vj, None)]
                if vi == _pad_get(paths[j], t - 1) and vj == _pad_get(paths[i], t - 1):
                    return [
                        (i, t, vi, _pad_get(paths[i], t - 1)),
                        (j, t, vj, _pad_get(paths[j], t - 1)),
                    ]
    return []


class _HLNode:
    __slots__ = ("paths", "constraints", "soc", "f", "LB", "f_mins", "valid")

    def __init__(self, paths, constraints, soc, f, LB, f_mins):
        self.paths = paths
        self.constraints = constraints
        self.soc = soc
        self.f = f
        self.LB = LB
        self.f_mins = f_mins
        self.valid = True


def solve_ecbs(
    occ2d: np.ndarray,
    starts: Sequence[Cell],
    currents: Sequence[Cell],
    goals: Sequence[Cell],
    sub_optimality: float = SUB_OPTIMALITY,
    max_hl_nodes: int = 5000,
    return_lb: bool = False,
    time_limit_s: float = 10.0,
):
    """Run ECBS from the current config; returns per-agent paths
    `[current, cfg(1), …]` with the repeated prefix stripped (the
    simulator-side strip, grid_based_planner.cpp:355-373), or None.
    With `return_lb`, returns `(paths, LB_min)` — the final high-level
    lower bound certifying soc ≤ w·LB_min. `time_limit_s` mirrors the
    reference's Solver::overCompTime wall-clock cutoff
    (solver.hpp:24, checked in both search levels).
    """
    import time as _time

    deadline = _time.perf_counter() + time_limit_s
    n = len(currents)
    occ2d = np.asarray(occ2d, dtype=bool)
    currents = [tuple(c) for c in currents]
    goals = [tuple(g) for g in goals]
    dists = [bfs_distances(occ2d, goals[i]) for i in range(n)]
    for i in range(n):
        if not np.isfinite(dists[i][currents[i]]):
            return (None, 0) if return_lb else None

    X, Y = occ2d.shape

    def neighbors(v: Cell):
        out = []
        for dx, dy in _NBR4:
            u = (v[0] + dx, v[1] + dy)
            if 0 <= u[0] < X and 0 <= u[1] < Y and not occ2d[u]:
                out.append(u)
        return out

    # ---- initial prioritized paths (reference getInitialPath :152-180)
    def initial_path(i: int, paths: List[Optional[List[Cell]]]):
        s, g = currents[i], goals[i]
        ms = max((len(p) - 1 for p in paths if p), default=0)
        path = [s]
        p = s
        t = 1
        goal_cells = set(goals)
        while p != g:
            if len(path) > 4 * (X + Y) + 50:
                return None  # should not happen on reachable goals
            cands = neighbors(p)

            def key(a):
                occupied = 0
                if t <= ms:
                    for j in range(n):
                        if paths[j] and _pad_get(paths[j], t) == a:
                            occupied = 1
                            break
                other_goal = 1 if (a != g and a in goal_cells) else 0
                return (dists[i][a], occupied, other_goal)

            p = min(cands, key=key)
            path.append(p)
            t += 1
        return path

    paths0: List[Optional[List[Cell]]] = [None] * n
    f_mins = []
    for i in range(n):
        pth = initial_path(i, paths0)
        if pth is None:
            return (None, 0) if return_lb else None
        paths0[i] = pth
        f_mins.append(len(pth) - 1)
    root = _HLNode(paths0, [], _soc(paths0), _count_conflicts(paths0),
                   _soc(paths0), f_mins)

    # ---- low-level focal space-time A* (reference getFocalPath :208-394)
    def focal_path(node: _HLNode, aid: int):
        s, g = currents[aid], goals[aid]
        cons = [c for c in node.constraints if c[0] == aid]
        max_con_t = max((c[1] for c in cons if c[2] == g and c[3] is None),
                        default=0)
        base_dist = dists[aid]
        others = [node.paths[j] for j in range(n) if j != aid]
        ms = _makespan(node.paths)
        occ_t = {}  # (t, cell) -> True for t <= ms; parked config at ms
        for pth in others:
            for t in range(ms + 1):
                occ_t[(t, _pad_get(pth, t))] = True

        def f1_of(v, gcost):
            h = base_dist[v]
            if not np.isfinite(h):
                return None
            f = gcost + int(h)
            if base_dist[s] <= max_con_t:
                f = max(max_con_t + 1, f)
            return f

        def f2_step(v, pv, gcost):
            """+1 if node (v, g) conflicts with any other path
            (reference f2Value, ecbs.cpp:243-261): vertex at time g
            (parked config beyond makespan), swap via occupancy."""
            if gcost == 0:
                return 0
            if gcost > ms:
                return 1 if occ_t.get((ms, v)) else 0
            if occ_t.get((gcost, v)):
                return 1
            # swap: someone is at pv at time g and was at v at g−1
            if occ_t.get((gcost, pv)) and occ_t.get((gcost - 1, v)):
                for pth in others:
                    if (_pad_get(pth, gcost) == pv
                            and _pad_get(pth, gcost - 1) == v):
                        return 1
            return 0

        def violates(v, pv, gcost):
            return any(
                gcost == c[1] and v == c[2] and (c[3] is None or c[3] == pv)
                for c in cons
            )

        start_f1 = f1_of(s, 0)
        if start_f1 is None:
            return None, 0

        # node store: idx -> (v, g, f1, f2, moves, parent_idx)
        # `moves` (# of non-wait transitions) is a FOCAL tie-break the
        # reference lacks: SOC costs only the last arrival, so optimal
        # plans may contain cost-free back-and-forth shuffles; preferring
        # fewer moves at equal (f2, f1) yields compact paths that the
        # committed-plan executor then walks physically.
        nodes = [(s, 0, start_f1, 0, 0, -1)]
        tie = itertools.count()
        OPEN = [(start_f1, next(tie), 0)]  # (f1, tie, idx)
        FOCAL = [(0, start_f1, 0, 0, next(tie), 0)]  # (f2,f1,moves,−g,tie,idx)
        CLOSE = set()
        f1_min = start_f1
        goal_idx = -1
        expansions = 0
        limit = 200000

        while OPEN and expansions < limit:
            if expansions % 256 == 0 and _time.perf_counter() > deadline:
                return None, 0
            # drop CLOSEd entries from OPEN's top
            while OPEN and (nodes[OPEN[0][2]][0], nodes[OPEN[0][2]][1]) in CLOSE:
                heapq.heappop(OPEN)
            if not OPEN:
                break
            # rebuild FOCAL when the lower bound advances (ecbs.cpp:334-352)
            if f1_min != OPEN[0][0] or not FOCAL:
                f1_min = OPEN[0][0]
                bound = f1_min * sub_optimality
                FOCAL = []
                for (f1v, tv, idx) in OPEN:
                    v, gc, _f1, f2v, mv, _p = nodes[idx]
                    if (v, gc) in CLOSE or f1v > bound:
                        continue
                    FOCAL.append((f2v, f1v, mv, -gc, tv, idx))
                heapq.heapify(FOCAL)
                if not FOCAL:
                    break

            f2v, f1v, _mv, neg_g, _tv, idx = heapq.heappop(FOCAL)
            v, gcost, _f1, _f2, moves, _p = nodes[idx]
            if (v, gcost) in CLOSE:
                continue
            CLOSE.add((v, gcost))
            expansions += 1

            if v == g and gcost > max_con_t:
                goal_idx = idx
                break

            for u in neighbors(v) + [v]:
                ng = gcost + 1
                if (u, ng) in CLOSE:
                    continue
                if violates(u, v, ng):
                    continue
                nf1 = f1_of(u, ng)
                if nf1 is None:
                    continue
                nf2 = f2v + f2_step(u, v, ng)
                nmv = moves + (1 if u != v else 0)
                nodes.append((u, ng, nf1, nf2, nmv, idx))
                nidx = len(nodes) - 1
                heapq.heappush(OPEN, (nf1, next(tie), nidx))
                if nf1 <= f1_min * sub_optimality:
                    heapq.heappush(
                        FOCAL, (nf2, nf1, nmv, -ng, next(tie), nidx)
                    )

        if goal_idx < 0:
            return None, 0
        path = []
        cur = goal_idx
        while cur >= 0:
            path.append(nodes[cur][0])
            cur = nodes[cur][5]
        path.reverse()
        return path, int(f1_min)

    # ---- high-level two-queue search (ecbs.cpp:12-110)
    tie = itertools.count()
    OPEN = [(root.LB, next(tie), root)]
    FOCAL = [(root.f, root.soc, next(tie), root)]
    LB_min = root.LB
    solved_node = None
    explored = 0
    while OPEN and explored < max_hl_nodes:
        if _time.perf_counter() > deadline:
            break
        while OPEN and not OPEN[0][2].valid:
            heapq.heappop(OPEN)
        if not OPEN:
            break
        # rebuild FOCAL when the global lower bound advances (:48-73)
        if LB_min != OPEN[0][0] or not FOCAL:
            LB_min = OPEN[0][0]
            bound = LB_min * sub_optimality
            FOCAL = [
                (e[2].f, e[2].soc, e[1], e[2])
                for e in OPEN
                if e[2].valid and e[0] <= bound
            ]
            heapq.heapify(FOCAL)
            if not FOCAL:
                break
        node = heapq.heappop(FOCAL)[3]
        if not node.valid:
            continue
        node.valid = False
        explored += 1

        constraints = _first_constraints(node.paths)
        if not constraints:
            solved_node = node
            break
        for c in constraints:
            aid = c[0]
            m = _HLNode([list(p) for p in node.paths],
                        node.constraints + [c], node.soc, node.f,
                        node.LB, list(node.f_mins))
            new_path, f_min = focal_path(m, aid)
            if new_path is None:
                continue
            old = m.paths[aid]
            m.f = (m.f - _count_conflicts(m.paths, aid, old)
                   + _count_conflicts(m.paths, aid, new_path))
            m.paths[aid] = new_path
            m.soc = _soc(m.paths)
            m.LB = m.LB - m.f_mins[aid] + f_min
            m.f_mins[aid] = f_min
            heapq.heappush(OPEN, (m.LB, next(tie), m))
            if m.LB <= LB_min * sub_optimality:
                heapq.heappush(FOCAL, (m.f, m.soc, next(tie), m))

    if solved_node is None:
        return (None, LB_min) if return_lb else None

    ms = _makespan(solved_node.paths)
    paths = [
        [_pad_get(solved_node.paths[i], t) for t in range(ms + 1)]
        for i in range(n)
    ]
    # strip repeated all-agent prefix
    repeated = 0
    for t in range(1, ms + 1):
        if all(paths[i][0] == paths[i][t] for i in range(n)):
            repeated = t
    for i in range(n):
        del paths[i][:repeated]
    return (paths, LB_min) if return_lb else paths
