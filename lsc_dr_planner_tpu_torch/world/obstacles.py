"""Analytic dynamic-obstacle models + generator.

Capability parity with the reference's obstacle family (reference:
include/obstacle.hpp — spin :83-136, straight trapezoidal profile
:138-214, patrol :216-264, chasing potential-field pursuit :267-364,
gaussian random-acceleration walk with reproducible history :366-469,
real/mocap placeholder :471-492) and ObstacleGenerator
(include/obstacle_generator.hpp:28-62, observation-noise hook :95-108).

Evaluation runs host-side in numpy once per simulation step (obstacle
counts are small and the models are stateful/sequential); the resulting
state arrays feed the batched JAX pipeline. The gaussian model uses a
seeded RNG so runs are reproducible (the reference uses random_device).

A copy of `lsc_dr_planner_tpu/world/obstacles.py`,
with its imports pointed at the port (numpy only).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from lsc_dr_planner_tpu_torch.mission import ObstacleSpec


@dataclasses.dataclass
class ObstacleState:
    position: np.ndarray
    velocity: np.ndarray
    radius: float
    max_acc: float
    downwash: float
    goal: np.ndarray


class _Straight:
    """Trapezoidal (or triangular) velocity profile from start to goal."""

    def __init__(self, start, goal, speed, max_acc):
        self.start = np.asarray(start, dtype=np.float64)
        self.goal = np.asarray(goal, dtype=np.float64)
        self.speed = speed
        self.max_acc = max_acc
        self.dist = np.linalg.norm(self.goal - self.start)
        self.n = (
            (self.goal - self.start) / self.dist if self.dist > 0 else np.zeros(3)
        )
        self.dist_acc = 0.5 * speed * speed / max_acc if max_acc > 0 else 0.0
        if self.dist > 2 * self.dist_acc:
            self.flight_time = (self.dist - 2 * self.dist_acc) / speed + 2 * speed / max_acc
        elif self.dist_acc > 0:
            self.flight_time = 2 * np.sqrt(self.dist / self.dist_acc)
        else:
            self.flight_time = 0.0

    def at(self, t):
        n, a, v = self.n, self.max_acc, self.speed
        if self.dist > 2 * self.dist_acc:
            t1 = v / a
            t2 = t1 + (self.dist - 2 * self.dist_acc) / v
            t3 = t1 + t2
            if t < t1:
                return self.start + n * 0.5 * a * t * t, n * a * t
            if t < t2:
                return self.start + n * (0.5 * a * t1 * t1 + v * (t - t1)), n * v
            if t < t3:
                return self.goal - n * 0.5 * a * (t3 - t) ** 2, n * (v - a * (t - t2))
            return self.goal.copy(), np.zeros(3)
        if self.dist_acc <= 0:
            return self.start.copy(), np.zeros(3)
        t1 = np.sqrt(self.dist / self.dist_acc)
        t2 = 2 * t1
        if t < t1:
            return self.start + n * 0.5 * a * t * t, n * a * t
        if t < t2:
            return self.goal - n * 0.5 * a * (t2 - t) ** 2, n * a * (t2 - t)
        return self.goal.copy(), np.zeros(3)


class ObstacleModel:
    def __init__(self, spec: ObstacleSpec, seed: int = 0):
        self.spec = spec
        t = spec.type
        if t == "straight":
            self._seg = _Straight(spec.start, spec.goal, spec.speed, spec.max_acc)
        elif t == "patrol":
            wps = spec.waypoints
            self._segs = [
                _Straight(wps[i], wps[(i + 1) % len(wps)], spec.speed, spec.max_acc)
                for i in range(len(wps))
            ]
            self._cycle = sum(s.flight_time for s in self._segs)
        elif t == "spin":
            a = np.asarray(spec.start) - np.asarray(spec.axis_position)
            n = np.asarray(spec.axis_ori, dtype=np.float64)
            n = n / np.linalg.norm(n)
            r = a - np.dot(a, n) * n
            self._spin_radius = np.linalg.norm(r)
            self._spin_n = n
            self._spin_a = a
            self._spin_w = spec.speed / self._spin_radius
        elif t == "chasing":
            self._pos = np.asarray(spec.start, dtype=np.float64).copy()
            self._vel = np.zeros(3)
            self._goal = self._pos.copy()
            self._t_last = 0.0
            self._neighbors: List[ObstacleState] = []
        elif t == "gaussian":
            self._rng = np.random.default_rng(seed)
            self._acc_history: List[np.ndarray] = []
            self._acc_horizon = 0.0
            self._extend_acc_history(10.0)
        elif t == "real":
            self._pos = np.zeros(3)
            self._vel = np.zeros(3)
        else:
            raise ValueError(f"unknown obstacle type {t}")

    # -- chasing extras (reference: ChasingObstacle::setGoalPoint/setObstacles)
    def set_goal(self, goal):
        self._goal = np.asarray(goal, dtype=np.float64)

    def set_neighbors(self, states: List[ObstacleState]):
        self._neighbors = states

    def set_real_state(self, pos, vel):
        """External (mocap) state feed for 'real' obstacles."""
        self._pos = np.asarray(pos, dtype=np.float64)
        self._vel = np.asarray(vel, dtype=np.float64)

    # ------------------------------------------------------------------
    def _extend_acc_history(self, horizon):
        s = self.spec
        while self._acc_horizon < horizon:
            acc = self._rng.normal(0.0, s.stddev_acc, size=3)
            if np.linalg.norm(acc) > s.max_acc > 0:
                acc = acc / np.linalg.norm(acc) * s.max_acc
            self._acc_history.append(acc)
            self._acc_horizon += s.acc_update_cycle

    # ------------------------------------------------------------------
    def state_at(self, t: float) -> ObstacleState:
        s = self.spec
        typ = s.type
        if typ == "straight":
            pos, vel = self._seg.at(t)
        elif typ == "patrol":
            tc = t % self._cycle if self._cycle > 0 else 0.0
            for seg in self._segs:
                if tc < seg.flight_time:
                    pos, vel = seg.at(tc)
                    break
                tc -= seg.flight_time
            else:
                pos, vel = self._segs[-1].at(self._segs[-1].flight_time)
        elif typ == "spin":
            theta = self._spin_w * t
            n = self._spin_n
            # Rodrigues rotation of the radial arm about the axis
            a = self._spin_a
            p = (
                a * np.cos(theta)
                + np.cross(n, a) * np.sin(theta)
                + n * np.dot(n, a) * (1 - np.cos(theta))
            )
            pos = np.asarray(self.spec.axis_position) + p
            # velocity = w x r: rotate p by +90° about n and scale by w
            p90 = np.cross(n, p) + n * np.dot(n, p) * 0.0
            vel = self._spin_w * p90
        elif typ == "chasing":
            dt = t - self._t_last
            a = s.gamma_target * (self._goal - self._pos)
            for ob in self._neighbors:
                delta = ob.position - self._pos
                dist = np.linalg.norm(delta)
                if dist < 1e-6:
                    continue
                q_star = 2 * (s.radius + ob.radius)
                if dist < q_star:
                    a += (
                        s.gamma_obs
                        * (1 - dist / q_star)
                        / (dist * q_star)
                        * (-delta / dist)
                    )
            if np.linalg.norm(a) > s.max_acc - 0.01 > 0:
                a = a / np.linalg.norm(a) * (s.max_acc - 0.01)
            self._vel = self._vel + a * dt
            if np.linalg.norm(self._vel) > s.max_vel > 0:
                self._vel = self._vel / np.linalg.norm(self._vel) * s.max_vel
            self._pos = self._pos + self._vel * dt
            self._t_last = t
            pos, vel = self._pos.copy(), self._vel.copy()
        elif typ == "gaussian":
            if t >= self._acc_horizon:
                self._extend_acc_history(self._acc_horizon + 10.0)
            cyc = s.acc_update_cycle
            nseg = int(np.floor((t + 1e-6) / cyc))
            pos = np.asarray(s.start, dtype=np.float64).copy()
            v = np.asarray(s.initial_vel, dtype=np.float64).copy()
            for i in range(nseg + 1):
                dt = cyc if i < nseg else t - nseg * cyc
                acc = self._acc_history[i]
                v_next = v + acc * dt
                if np.linalg.norm(v_next) > s.max_vel > 0:
                    pos += v * dt
                else:
                    pos += v * dt + 0.5 * acc * dt * dt
                    v = v_next
            vel = v
        elif typ == "real":
            pos, vel = self._pos.copy(), self._vel.copy()
        else:
            raise ValueError(typ)

        return ObstacleState(
            position=np.asarray(pos, dtype=np.float64),
            velocity=np.asarray(vel, dtype=np.float64),
            radius=s.radius,
            max_acc=s.max_acc,
            downwash=s.downwash,
            goal=np.asarray(pos, dtype=np.float64),
        )


class ObstacleGenerator:
    """Evaluates all mission obstacles at time t, with optional
    observation noise (reference: include/obstacle_generator.hpp:28-62,
    noise hook :95-108)."""

    def __init__(self, specs: List[ObstacleSpec], seed: int = 0):
        self.models = [ObstacleModel(s, seed=seed + i) for i, s in enumerate(specs)]

    def __len__(self):
        return len(self.models)

    def states_at(self, t: float, noise_std: float = 0.0, rng=None) -> List[ObstacleState]:
        states = [m.state_at(t) for m in self.models]
        if noise_std > 0:
            rng = rng or np.random.default_rng(0)
            for st in states:
                st.position = st.position + rng.normal(0, noise_std, 3)
        return states
