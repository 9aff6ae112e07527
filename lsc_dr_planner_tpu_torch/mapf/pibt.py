"""PIBT — Priority Inheritance with Backtracking (default MAPF solver).

Behavioral parity with the vendored mapf-IR PIBT (reference:
src/mapf/pibt.cpp — priority ordering :14-20, main loop :13-110,
funcPIBT recursion :112-135, greedy neighbor choice :151-188) driven
through GridBasedPlanner::runMAPF (src/grid_based_planner.cpp:324-376):
the returned per-agent paths start with the *mission-start* config
(solution.add(P->getConfigStart()), pibt.cpp:44) followed by the PIBT
steps from the *current* config, and the all-agents-repeated prefix is
stripped to break deadlocks (:355-373).

Deterministic: candidate shuffles use a seeded RNG (the reference seeds
its mt19937 with DEFAULT_SEED=0 per Problem instance).

Host-side: PIBT is inherently sequential (priority inheritance
recursion) and costs ~0.03 ms/agent in the reference — far off the TPU
critical path. A C++ native implementation is provided in native/
with this module as behavioral reference and fallback.

A copy of `lsc_dr_planner_tpu/mapf/pibt.py`,
with its imports pointed at the port (numpy only).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from lsc_dr_planner_tpu_torch.mapf.grid import _NBR4, bfs_distances

MAX_TIMESTEP = 5000


class Lcg:
    """Tiny deterministic LCG + Fisher–Yates shuffle, implemented
    identically in the native C++ backend (native/mapf.cpp) so both
    backends produce bit-identical plans."""

    def __init__(self, seed: int):
        self.s = (seed * 2654435761 + 1) & 0xFFFFFFFF

    def next(self) -> int:
        self.s = (self.s * 1664525 + 1013904223) & 0xFFFFFFFF
        return self.s

    def shuffle(self, xs) -> None:
        for i in range(len(xs) - 1, 0, -1):
            j = self.next() % (i + 1)
            xs[i], xs[j] = xs[j], xs[i]


class _Agent:
    __slots__ = ("id", "v_now", "v_next", "goal", "elapsed", "init_d", "tie")

    def __init__(self, i, v, g, d, tie):
        self.id = i
        self.v_now = v
        self.v_next = None
        self.goal = g
        self.elapsed = 0
        self.init_d = d
        self.tie = tie


def solve_pibt(
    occ2d: np.ndarray,
    starts: Sequence[Tuple[int, int]],
    currents: Sequence[Tuple[int, int]],
    goals: Sequence[Tuple[int, int]],
    seed: int = 0,
    max_timestep: int = MAX_TIMESTEP,
    init_elapsed: Optional[Sequence[int]] = None,
) -> Optional[List[List[Tuple[int, int]]]]:
    """Run PIBT; returns per-agent paths `[start, cfg(t=1), cfg(t=2), …]`
    with the repeated all-agent prefix already stripped, or None on
    failure. Inputs are (x, y) cells on the z-collapsed coarse grid.

    `init_elapsed`: optional initial priority counters. The reference
    constructs PIBT fresh every replanning step, resetting the elapsed
    priorities; in crowded corridors that can produce waypoint limit
    cycles. Carrying elapsed across the simulator's successive calls
    (blocked agents accumulate priority) restores PIBT's monotone
    pressure and breaks the cycles.
    """
    n = len(currents)
    occ2d = np.asarray(occ2d, dtype=bool)
    rng = Lcg(seed)

    dists = [bfs_distances(occ2d, tuple(goals[i])) for i in range(n)]

    agents = []
    occupied_now = {}
    for i in range(n):
        v = tuple(currents[i])
        d = dists[i][v]
        if not np.isfinite(d):
            return None  # unreachable goal
        a = _Agent(i, v, tuple(goals[i]), int(d), i / n)
        if init_elapsed is not None:
            a.elapsed = int(init_elapsed[i])
        agents.append(a)
        occupied_now[v] = a

    occupied_next = {}

    def prio_key(a: _Agent):
        # max-heap over (elapsed, init_d, tie) — reference pibt.cpp:14-20
        return (a.elapsed, a.init_d, a.tie)

    def choose_node(a: _Agent):
        C = []
        x, y = a.v_now
        X, Y = occ2d.shape
        for dx, dy in _NBR4:
            nx, ny = x + dx, y + dy
            if 0 <= nx < X and 0 <= ny < Y and not occ2d[nx, ny]:
                C.append((nx, ny))
        C.append(a.v_now)
        rng.shuffle(C)
        v = None
        for u in C:
            if u in occupied_next:
                continue
            aj = occupied_now.get(u)
            if aj is not None and aj.v_next == a.v_now:
                continue  # swap conflict
            if u == a.goal:
                return u
            if v is None:
                v = u
            else:
                c_v = dists[a.id][v]
                c_u = dists[a.id][u]
                if (c_u < c_v) or (
                    c_u == c_v and v in occupied_now and u not in occupied_now
                ):
                    v = u
        return v

    def func_pibt(a: _Agent) -> bool:
        # Mirrors funcPIBT (pibt.cpp:112-135): an abandoned reservation
        # stays taken for the remainder of the timestep (chooseNode skips
        # occupied_next cells, so the replan loop terminates); unlike the
        # reference we clear occupied_next between timesteps.
        while True:
            v = choose_node(a)
            if v is None:
                occupied_next[a.v_now] = a
                a.v_next = a.v_now
                return False
            occupied_next[v] = a
            a.v_next = v
            aj = occupied_now.get(v)
            if aj is not None and aj is not a and aj.v_next is None:
                if not func_pibt(aj):
                    a.v_next = None
                    continue
            return True

    solution = [list(tuple(s) for s in starts)]
    for _t in range(max_timestep):
        for a in sorted(agents, key=prio_key, reverse=True):
            if a.v_next is None:
                func_pibt(a)
        config = [None] * n
        all_goal = True
        occupied_now.clear()
        for a in agents:
            config[a.id] = a.v_next
            occupied_now[a.v_next] = a
            all_goal &= a.v_next == a.goal
            a.elapsed = 0 if a.v_next == a.goal else a.elapsed + 1
            a.v_now = a.v_next
            a.v_next = None
        occupied_next.clear()
        solution.append(config)
        if all_goal:
            break
    else:
        return None

    # per-agent paths + repeated-prefix strip (grid_based_planner.cpp:355-373)
    paths = [[solution[t][i] for t in range(len(solution))] for i in range(n)]
    repeated = 0
    for t in range(1, len(solution)):
        if all(paths[i][0] == paths[i][t] for i in range(n)):
            repeated = t
    for i in range(n):
        del paths[i][:repeated]
    return paths
