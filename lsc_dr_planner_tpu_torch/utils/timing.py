"""Hierarchical planning-time statistics.

Capability parity with the reference's timing structs (reference:
include/sp_const.hpp — PlanningTime running min/max/mean :87-106,
PlanningTimeStatistics with 8 named stages :108-128) and the
Timer/ScopedTimer utility (include/timer.hpp:6-35).

A copy of `lsc_dr_planner_tpu/utils/timing.py`,
with its imports pointed at the port (numpy only).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class PlanningTime:
    current: float = 0.0
    min: float = float("inf")
    max: float = 0.0
    average: float = 0.0
    N: int = 0
    # raw per-step samples (bounded) so mission rows can report tail
    # latency (p50/p99) against the 0.2 s replanning budget, not just
    # the running min/max the reference keeps (sp_const.hpp:87-106)
    samples: list = field(default_factory=list)
    _MAX_SAMPLES = 20000

    def update(self, value: float) -> None:
        self.current = value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.N += 1
        self.average += (value - self.average) / self.N
        if len(self.samples) < self._MAX_SAMPLES:
            self.samples.append(value)

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        idx = min(len(s) - 1, int(q / 100.0 * len(s)))
        return s[idx]


@dataclass
class PlanningTimeStatistics:
    """The reference's 8 stages (sp_const.hpp:108-128)."""

    mapf_time: PlanningTime = field(default_factory=PlanningTime)
    initial_traj_planning_time: PlanningTime = field(default_factory=PlanningTime)
    obstacle_prediction_time: PlanningTime = field(default_factory=PlanningTime)
    goal_planning_time: PlanningTime = field(default_factory=PlanningTime)
    lsc_generation_time: PlanningTime = field(default_factory=PlanningTime)
    sfc_generation_time: PlanningTime = field(default_factory=PlanningTime)
    traj_optimization_time: PlanningTime = field(default_factory=PlanningTime)
    total_planning_time: PlanningTime = field(default_factory=PlanningTime)


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._elapsed = 0.0

    def stop(self):
        self._elapsed = time.perf_counter() - self._t0
        return self._elapsed

    def elapsed_seconds(self) -> float:
        return self._elapsed
