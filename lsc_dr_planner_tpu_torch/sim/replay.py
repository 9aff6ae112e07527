"""Simulation-log replayer and debug frames (port of
lsc_dr_planner_tpu/sim/replay.py).

Capability parity with MultiSyncReplayer (reference:
src/multi_sync_replayer.cpp — wide-CSV parsing :54-110, 50 Hz linear
state interpolation :140-172, RViz rendering :174-...). Instead of RViz
this replayer gives programmatic state access (for regression checks)
and matplotlib rendering to PNG. The reader and the interpolation are
numpy; the rendering imports matplotlib when it is called, and raises
an ImportError that names it on a host without it.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class ReplayLog:
    times: np.ndarray  # [T]
    agent_states: np.ndarray  # [T, A, 9] (pos, vel, acc)
    planning_times: np.ndarray  # [T, A]
    obstacle_states: np.ndarray  # [T, O, 4] (pos, size)

    @property
    def qn(self):
        return self.agent_states.shape[1]

    @property
    def on(self):
        return self.obstacle_states.shape[1]


def read_csv(path: str) -> ReplayLog:
    """Parse the wide per-agent/per-obstacle simulation CSV (the schema
    the simulator and the reference write, multi_sync_simulator.cpp:586-656):
    per agent 12 columns (id, t, position, velocity, acceleration,
    planning time), then per obstacle 6 (obs_id, t, position, size)."""
    with open(path) as f:
        header = f.readline().strip().split(",")
        rows = [line.strip().split(",") for line in f if line.strip()]
    qn = header.count("id")
    on = header.count("obs_id")
    agent_w, obs_w = 12, 6
    T = len(rows)
    vals = np.asarray(rows, dtype=np.float64).reshape(T, qn * agent_w + on * obs_w)
    ag = vals[:, : qn * agent_w].reshape(T, qn, agent_w)
    ob = vals[:, qn * agent_w: qn * agent_w + on * obs_w].reshape(T, on, obs_w)
    return ReplayLog(vals[:, 1].copy(), ag[..., 2:11].copy(), ag[..., 11].copy(),
                     ob[..., 2:6].copy())


def state_at(log: ReplayLog, t: float) -> np.ndarray:
    """Linearly interpolated agent states at time t (reference
    doReplay, multi_sync_replayer.cpp:140-172)."""
    times = log.times
    t = float(np.clip(t, times[0], times[-1]))
    i = int(np.searchsorted(times, t, side="right") - 1)
    i = min(i, len(times) - 2)
    denom = max(times[i + 1] - times[i], 1e-9)
    a = (t - times[i]) / denom
    return (1 - a) * log.agent_states[i] + a * log.agent_states[i + 1]


def replay(log: ReplayLog, rate_hz: float = 50.0):
    """Iterate interpolated states at the given rate (generator)."""
    t = log.times[0]
    while t <= log.times[-1] + 1e-9:
        yield t, state_at(log, t)
        t += 1.0 / rate_hz


def _pyplot():
    """matplotlib's pyplot on the headless backend, or an ImportError that
    says rendering needs matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "rendering a replay or a debug frame needs matplotlib, which is not "
            "installed on this host; read_csv, state_at and replay do not") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_png(log: ReplayLog, out_path: str, world_boxes: Optional[np.ndarray] = None,
               stride: int = 5):
    """Top-down trajectory plot."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 7))
    if world_boxes is not None:
        for cx, cy, cz, sx, sy, sz in world_boxes:
            ax.add_patch(plt.Rectangle((cx - sx / 2, cy - sy / 2), sx, sy,
                                       color="0.3", alpha=0.6))
    cmap = plt.get_cmap("hsv")
    for qi in range(log.qn):
        xy = log.agent_states[::stride, qi, :2]
        c = cmap(qi / max(log.qn, 1))
        ax.plot(xy[:, 0], xy[:, 1], color=c, lw=1)
        ax.plot(*xy[0], marker="o", color=c, ms=5)
        ax.plot(*xy[-1], marker="*", color=c, ms=9)
    ax.set_aspect("equal")
    ax.set_title("trajectory replay")
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def render_debug_frame(sim, out_path: str, segment: Optional[int] = None,
                       focus_agent: Optional[int] = None):
    """Render the planner's internal artifacts for the simulator's
    current state: SFC corridor boxes, LSC half-planes, MAPF waypoints
    and committed grid paths, and communication groups — the debugging
    surface the reference publishes to RViz every step
    (traj_planner.cpp:805-902, multi_sync_simulator.cpp:376-399).

    The constraint tensors come from one planning step in debug mode
    (`FleetPlanner._dbg`); the state its inputs would move on (the
    planner sequence, goals, the observation noise's generator) is
    restored afterwards, so this runs mid-flight."""
    from lsc_dr_planner_tpu_torch.ops import sfc as sfcmod

    plt = _pyplot()
    p = sim.param
    seg = p.M - 1 if segment is None else segment

    snap = {
        "planner_seq": sim.planner_seq,
        "desired_goal": sim.desired_goal.copy(),
        "start_point": sim.start_point.copy(),
        "current_goal": sim.current_goal.copy(),
        "_obs_rng": copy.deepcopy(sim._obs_rng),
    }
    was_debug = sim.planner.debug
    sim.planner.debug = True
    try:
        sim.planner._step_impl(sim.fleet, sim._build_step_inputs())
        dbg = sim.planner._dbg
    finally:
        sim.planner.debug = was_debug
        for k, v in snap.items():
            setattr(sim, k, v)

    A = sim.A
    pos = np.asarray(sim.pos)
    radius = np.asarray(sim.s["radius"])

    fig, ax = plt.subplots(figsize=(9, 9))
    cmap = plt.get_cmap("hsv")
    colors = [cmap(qi / max(A, 1)) for qi in range(A)]

    # world obstacles
    for cx, cy, cz, sx, sy, sz in np.asarray(sim.mission.world_boxes):
        ax.add_patch(plt.Rectangle((cx - sx / 2, cy - sy / 2), sx, sy,
                                   color="0.25", alpha=0.7, zorder=1))

    # communication groups: lines between members
    for group in sim._groups():
        for i in group:
            for j in group:
                if j > i:
                    ax.plot([pos[i, 0], pos[j, 0]], [pos[i, 1], pos[j, 1]],
                            color="0.7", lw=0.5, zorder=2)

    # committed grid-plan paths (the MAPF layer)
    for plan in sim._group_plans.values():
        for pth in plan["paths"]:
            cells = np.array([[c[0], c[1], 0] for c in pth])
            pts = sim.coarse.node_to_point(cells)
            ax.plot(pts[:, 0], pts[:, 1], ":", color="0.4", lw=0.8, zorder=2)

    # SFC boxes (chosen segment), planned trajectories, waypoints, goals
    dev = sim.world.device
    sfc_lo_w, sfc_hi_w = (v.cpu().numpy() for v in sfcmod.sfc_to_world(
        sim.world, torch.as_tensor(np.asarray(sim.sfc_lo), device=dev),
        torch.as_tensor(np.asarray(sim.sfc_hi), device=dev), sim.planner.sfc_margin))
    for qi in range(A):
        c = colors[qi]
        lo, hi = sfc_lo_w[qi, seg], sfc_hi_w[qi, seg]
        if np.all(hi > lo) and sim.sfc_initialized[qi]:
            ax.add_patch(plt.Rectangle((lo[0], lo[1]), hi[0] - lo[0], hi[1] - lo[1],
                                       fill=False, edgecolor=c, lw=0.8, alpha=0.8,
                                       zorder=3))
        ctrl = sim.desired_ctrl[qi].reshape(-1, 3)
        ax.plot(ctrl[:, 0], ctrl[:, 1], "-", color=c, lw=1.0, zorder=4)
        ax.add_patch(plt.Circle((pos[qi, 0], pos[qi, 1]), radius[qi], color=c,
                                alpha=0.5, zorder=5))
        ax.plot(*sim.next_waypoint[qi, :2], marker="x", color=c, ms=8, zorder=6)
        ax.plot(*sim.current_goal[qi, :2], marker="+", color=c, ms=8, zorder=6)
        ax.plot(*sim.desired_goal[qi, :2], marker="*", color=c, ms=7, alpha=0.6,
                zorder=6)

    # LSC half-planes of the focus agent (all agents would be unreadable);
    # by default the agent with the most agents in range
    fa = focus_agent
    if fa is None:
        fa = int(np.argmax([
            np.sum(np.max(np.abs(pos - pos[i]), axis=-1)
                   < max(p.communication_range, 1.0)) for i in range(A)]))
    ls = dbg["ls"]
    valid = dbg["obs_valid"][fa].cpu().numpy()
    normals = ls.normals[fa, :, seg, :].cpu().numpy()  # [O, 3]
    anchors = ls.anchors[fa, :, seg, -1, :].cpu().numpy()  # [O, 3]
    margins = ls.margins[fa, :, seg, -1].cpu().numpy()  # [O]
    span = max(1.0, 0.75 * p.communication_range)
    planes = []  # (n2 [2], b) meaning n·x ≥ b
    for o in range(normals.shape[0]):
        nn = np.linalg.norm(normals[o, :2])
        if not valid[o] or nn < 1e-6:
            continue
        n2 = normals[o, :2] / nn
        # plane n·x = n·anchor + margin: a boundary point and its tangent
        bpt = anchors[o, :2] + n2 * margins[o]
        tang = np.array([-n2[1], n2[0]])
        seg_pts = np.stack([bpt - span * tang, bpt + span * tang])
        ax.plot(seg_pts[:, 0], seg_pts[:, 1], "--", color=colors[fa], lw=0.9, alpha=0.8,
                zorder=3)
        ax.annotate("", xy=tuple(bpt + 0.25 * n2), xytext=tuple(bpt),
                    arrowprops=dict(arrowstyle="->", color=colors[fa], lw=0.8), zorder=3)
        planes.append((normals[o, :2], float(np.dot(normals[o, :2], anchors[o, :2])
                                             + margins[o])))

    # the focus agent's feasible region: its LSC half-planes cut by the
    # segment's SFC box, vertex-enumerated by pairwise boundary
    # intersection (the 2-D analogue of the reference's RViz polytope,
    # collision_constraints.cpp:948-1018)
    lo_f, hi_f = sfc_lo_w[fa, seg], sfc_hi_w[fa, seg]
    if sim.sfc_initialized[fa] and np.all(hi_f > lo_f):
        planes += [(np.array([1.0, 0.0]), float(lo_f[0])),
                   (np.array([-1.0, 0.0]), float(-hi_f[0])),
                   (np.array([0.0, 1.0]), float(lo_f[1])),
                   (np.array([0.0, -1.0]), float(-hi_f[1]))]
    verts = []
    for i in range(len(planes)):
        for j in range(i + 1, len(planes)):
            amat = np.stack([planes[i][0], planes[j][0]])
            if abs(np.linalg.det(amat)) < 1e-9:
                continue
            x = np.linalg.solve(amat, [planes[i][1], planes[j][1]])
            if all(np.dot(n2p, x) >= b - 1e-6 for n2p, b in planes):
                verts.append(x)
    if len(verts) >= 3:
        v = np.asarray(verts)
        ctr = v.mean(axis=0)
        poly = v[np.argsort(np.arctan2(v[:, 1] - ctr[1], v[:, 0] - ctr[0]))]
        ax.add_patch(plt.Polygon(poly, closed=True, facecolor=colors[fa], alpha=0.12,
                                 edgecolor=colors[fa], lw=1.2, zorder=2))

    ax.set_xlim(sim.mission.world_min[0] - 0.5, sim.mission.world_max[0] + 0.5)
    ax.set_ylim(sim.mission.world_min[1] - 0.5, sim.mission.world_max[1] + 0.5)
    ax.set_aspect("equal")
    ax.set_title(f"step {sim.planner_seq}  t={sim.sim_time:.1f}s  "
                 f"SFC/LSC segment {seg}  LSC focus agent {fa}")
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
