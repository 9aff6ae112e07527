"""The step's neighbour, prediction, goal and QP-input stages
(planner/stages.py) and their kernels (csrc/step_stages.cu,
ops/step_cuda.py).

On the CPU: the plain bodies, whose rounding is pinned for the kernels,
against the JAX package on the same inputs (the neighbour slots exactly,
lax.top_k's order among the lattice's ties included; the stages of a
whole step through both packages' debug stashes, at the tolerances
below); a scalar float32 twin of each kernel, in its order of
operations, against the plain bodies bit for bit; CPU tensors take the
plain bodies and the kernels' entries raise on them. The `cuda` tests
hold each kernel to its plain body on the card, element for element;
they import neither jax nor the JAX package, so on the GPU machine they
run with `python -m pytest --noconftest -m cuda
tests/test_torch_step_stages.py` (tests/conftest.py imports jax).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.config import GoalMode, PlannerMode
from lsc_dr_planner_tpu_torch.ops import step_cuda
from lsc_dr_planner_tpu_torch.planner import stages

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

F = np.float32
EPS = F(1e-6)
# Against the JAX package: the same operations in another order (XLA's
# sums, einsums and float32 square roots; its constant-velocity times),
# a few float32 ulps of positions up to ~30 m from the origin
ATOL_PRED = 2e-5
# the rows n·anchor + margin on the same corridor: XLA's einsum sums the
# products in another order (anchors up to ~30 m: a few ulps)
ATOL_ROWS_SAME = 1e-5
# the goal of a whole step: the LP's ratios of rows that the two packages'
# corridors already round differently (tests/test_torch_pipeline.py)
ATOL_GOAL = 1e-4

STATIC = dict(goal_mode=GoalMode.STATIC, communication_range=-1.0)
MODES = {
    "lsc_dr_2d": {},
    "lsc_dr_3d": dict(world_dimension=3),
    "dlsc_substep": dict(planner_mode=PlannerMode.DLSC, multisim_time_step=0.1),
    "bvc": dict(planner_mode=PlannerMode.BVC, **STATIC),
    "rsfc": dict(planner_mode=PlannerMode.RECIPROCAL_RSFC, **STATIC),
    "lsc_right_hand": dict(goal_mode=GoalMode.RIGHT_HAND, communication_range=-1.0),
    "lsc_prior_based": dict(goal_mode=GoalMode.PRIOR_BASED, communication_range=-1.0),
    "no_octomap": dict(world_use_octomap=False),
    "dynobs": dict(STATIC),
    "scenarios2": {},
    "lsc_dr_n8": dict(n=8),  # Bézier degree 8: 9 control points a segment
}
OD = 2


def _dynobs(S):
    """Two obstacles flying at the fleet from either side, one set a
    scenario ([S, OD, ...] for S > 1), as float32 tensors."""
    pos = np.array([[-3.2, 0.3, 0.6], [3.2, -0.9, 0.6]], np.float32)
    vel = np.array([[0.4, 0.0, 0.0], [-0.4, 0.1, 0.0]], np.float32)
    d = dict(dynobs_pos=pos, dynobs_vel=vel, dynobs_radius=np.full(OD, 0.2, np.float32),
             dynobs_downwash=np.full(OD, 1.0, np.float32),
             dynobs_max_acc=np.full(OD, 1.0, np.float32), dynobs_valid=np.array([True, False]))
    if S > 1:
        d = {k: np.stack([v] * S) for k, v in d.items()}
        d["dynobs_pos"][1:] += 0.5
    return {k: torch.as_tensor(v) for k, v in d.items()}


def mode_state(name, A, device="cpu", steps=2):
    """(planner, fleet, inp, scenarios) of mode `name` at the bench layout
    after `steps` evolving steps, with some agents disturbed, some moved
    0.7 m off their plans (the disturbance reset), some stopped (the
    right-hand rule's deadlock test); `scenarios2` stacks two states."""
    ov = MODES[name]
    p, planner, fleet, inp = workload.build_fleet(A, device=device, **ov)
    if name == "dynobs":
        planner = type(planner)(p, planner.world, A, max_dynobs=OD, agent_radius=0.15,
                                max_vel_hint=1.0)
        inp = dataclasses.replace(inp, qp_y0=None,
                                  **{k: v.to(device) for k, v in _dynobs(1).items()})
    step = workload.make_evolve_step(p, planner, fleet)
    states = []
    for _ in range(steps):
        inp, _ = step(inp)
        states.append(inp)
    S = 2 if name == "scenarios2" else 1
    if S == 2:
        inp = dataclasses.replace(inp, **{
            f.name: torch.cat([getattr(states[-2], f.name), getattr(inp, f.name)])
            for f in dataclasses.fields(inp)
            if isinstance(getattr(inp, f.name), torch.Tensor)})
        fleet = dataclasses.replace(fleet, **{f.name: torch.cat([getattr(fleet, f.name)] * 2)
                                              for f in dataclasses.fields(fleet)})
    n = inp.pos.shape[0]
    disturbed = torch.zeros(n, dtype=torch.bool, device=device)
    disturbed[::7] = True
    pos = inp.pos.clone()
    pos[3::11, 0] += 0.7
    vel = inp.vel.clone()
    vel[1::5] = 0.0
    inp = dataclasses.replace(inp, is_disturbed=disturbed, pos=pos, vel=vel,
                              planner_seq=p.deadlock_seq_threshold + 1)
    return planner, fleet, inp, S


class Record:
    """Records the calls of planner/stages.py's four entries."""

    NAMES = ("neighbor_slots", "step_front", "front_with_neighbors", "goal_qp_inputs")

    def __enter__(self):
        self.orig = {n: getattr(stages, n) for n in self.NAMES}
        self.calls = {n: [] for n in self.NAMES}

        def wrap(n):
            def f(*a, **k):
                out = self.orig[n](*a, **k)
                self.calls[n].append((a, k, out))
                return out
            return f

        for n in self.NAMES:
            setattr(stages, n, wrap(n))
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(stages, n, f)


@contextlib.contextmanager
def separate():
    """For the duration, the step's front_with_neighbors as two launches:
    neighbor_slots, then step_front on its slots (looked up at each call,
    so that a Record sees both)."""
    fused = stages.front_with_neighbors

    def front(cfg, fleet, inp, scenarios=1):
        order, valid = stages.neighbor_slots(inp.pos, scenarios, cfg)
        return order, valid, stages.step_front(cfg, fleet, inp, order, valid, None, scenarios)

    stages.front_with_neighbors = front
    try:
        yield
    finally:
        stages.front_with_neighbors = fused


def recorded(name, A, device="cpu", fuse=True):
    """The stage calls of one deferred step of `mode_state(name, A)`: the
    neighbour selection inside the prediction's entry (front_with_neighbors),
    or with `fuse` False neighbor_slots and then step_front (`separate`)."""
    planner, fleet, inp, S = mode_state(name, A, device)
    with Record() as rec, (contextlib.nullcontext() if fuse else separate()):
        planner._step_impl(fleet, inp, defer_qp=True, scenarios=S)
    return planner, rec.calls


def np32(t):
    return None if t is None else t.detach().cpu().numpy()


def assert_equal_by_value(got, want, what):
    """Element for element by value (a NaN equal to a NaN), dtypes equal."""
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype,
                                                               got.shape, want.shape)
    a, b = np.asarray(got), np.asarray(want)
    bad = (a != b) & ~(np.isnan(a) & np.isnan(b)) if a.dtype.kind == "f" else a != b
    assert not bad.any(), (what, int(bad.sum()), np.argwhere(bad)[:5])


# ---- the kernels, in Python -------------------------------------------------
def _sqrt64(x):
    return F(np.sqrt(np.float64(x)))


def _dotn(a, b, d):
    s = F(a[0] * b[0]) + F(a[1] * b[1])
    return s + F(a[2] * b[2]) if d > 2 else s


def _norm(x, d=3):
    return _sqrt64(_dotn(x, x, d))


def _fms(a, b, c, d):
    return F(np.float64(a) * np.float64(b) - np.float64(F(c * d)))


FULL = (1 << 64) - 1  # an exhausted list's key


def twin_neighbors(pos, S, OA, rng, use_range, K=None, threads=step_cuda.BLOCK_THREADS,
                   warp=32):
    """select_nearest, a block an agent: thread t takes candidates t, t +
    threads, ..., a tile of threads·K at a time, sorts each tile's K keys
    (distance bits << 32 | index) and keeps the K smallest of its list and
    them; each warp takes its lanes' OA smallest, a round a key (the
    least head; the lanes that hold it pop); the warps' ascending lists
    are merged by rank. K: the kernel's list_len unless given."""
    SA = pos.shape[0]
    A = SA // S
    K = K or step_cuda.list_len(A, OA)
    tile = threads * K
    order = np.zeros((SA, OA), np.int64)
    valid = np.zeros((SA, OA), bool)
    for agent in range(SA):
        s, i = divmod(agent, A)
        p = pos[s * A:(s + 1) * A]
        d = np.abs(p[i] - p).max(axis=1)
        d[i] = d[i] + F(1e9)
        if use_range:
            d = np.where(d < rng, d, F(1e9)).astype(F)
        keys = [(int(b) << 32) | j for j, b in enumerate(d.view(np.uint32))]
        lists = []
        for t in range(threads):
            best = None
            for t0 in range(0, A, tile):
                c = sorted(keys[t0 + t:min(A, t0 + tile):threads] + [FULL] * K)[:K]
                best = c if best is None else sorted(best + c)[:K]
            lists.append(best)
        tops = []
        for w in range(threads // warp):
            lanes = [list(x) for x in lists[w * warp:(w + 1) * warp]]
            top = []
            for _ in range(OA):
                m = min(lane[0] if lane else FULL for lane in lanes)
                top.append(m)
                for lane in lanes:
                    if lane and lane[0] == m:
                        lane.pop(0)
            tops.append(top)
        out = [None] * OA
        for w, top in enumerate(tops):
            for r, x in enumerate(top):
                rank = r + sum(y < x for v, other in enumerate(tops) if v != w for y in other)
                if rank < OA:
                    out[rank] = x
        order[agent] = [(x & 0xFFFFFFFF) + s * A for x in out]
        valid[agent] = [np.uint32(x >> 32).view(F) < F(1e8) for x in out]
    return order, valid


def _cv_time(m, i, n, dt):
    return F(F(m) + F(F(i) / F(n))) * dt


KIND_ROW, KIND_CV, KIND_PAD = 0, 1, 2  # the kernel's Kind


def _row_value(row, sub, N, MN3, r, m, i, d):
    """row_value: element r = (m*N + i)*3 + d of the prediction from a
    source's flat row: shifted one segment, the last point held; or (sub)
    segment 0 re-parameterised left to right."""
    if sub is None:
        return row[r + 3 * N] if r < MN3 - 3 * N else row[MN3 - 3 + d]
    if m > 0:
        return row[r]
    acc = F(sub[0, i] * row[d])
    for k in range(1, N):
        acc = acc + F(sub[k, i] * row[3 * k + d])
    return acc


def twin_front(cfg, sc, fleet, inp, order, valid, nd, S):
    """step_front_kernel, an agent at a time: each slot's kind and
    (position, velocity) and the agent's own (slot O), the disturbance
    reset from each row's first point, then every output element, in
    flat order, from pred(slot, r) (the kernel writes them four at a
    time)."""
    A, O, OA, OD, M, N = inp.pos.shape[0], cfg.O, cfg.OA, cfg.OD, cfg.M, cfg.n + 1
    N3, MN3 = 3 * N, cfg.M * 3 * N
    sub = np32(cfg.sub)
    tt = np.array([_cv_time(m, i, cfg.n, sc["dt"]) for m in range(M) for i in range(N)], F)
    if nd is not None:
        src = {k: np32(getattr(nd, k)).reshape(A * OA, *getattr(nd, k).shape[2:])
               for k in ("prev_ctrl", "has_prev", "pos", "vel", "radius", "downwash", "goal")}
        order = np.arange(A * OA).reshape(A, OA)
        valid = np32(nd.valid)
    else:
        src = dict(prev_ctrl=np32(inp.prev_ctrl), has_prev=np32(inp.has_prev), pos=np32(inp.pos),
                   vel=np32(inp.vel), radius=np32(fleet.radius), downwash=np32(fleet.downwash),
                   goal=np32(inp.current_goal))
        order, valid = np32(order), np32(valid)
    dyn = {}
    if OD:
        dyn = {k: np32(getattr(inp, "dynobs_" + k)).reshape(S * OD, *((3,) if w else ()))
               for k, w in (("pos", 1), ("vel", 1), ("radius", 0), ("downwash", 0),
                            ("max_acc", 0), ("valid", 0))}
    out = dict(obs_pred=np.zeros((A, O, M, N, 3), F), obs_valid=np.zeros((A, O), bool),
               obs_is_agent=np.zeros((A, O), bool), obs_radius=np.zeros((A, O), F),
               obs_downwash=np.zeros((A, O), F), obs_max_acc=np.zeros((A, O), F),
               obs_pos_now=np.zeros((A, O, 3), F), obs_goal=np.zeros((A, O, 3), F),
               initial_ctrl=np.zeros((A, M, N, 3), F))
    if cfg.sizes:
        out["obs_pred_sizes"] = np.zeros((A, O, M, N), F)
    pos, vel, prev = np32(inp.pos), np32(inp.vel), np32(inp.prev_ctrl)
    has_prev, disturbed, max_acc = np32(inp.has_prev), np32(inp.is_disturbed), np32(fleet.max_acc)
    growth = np32(cfg.growth).reshape(-1)
    zero = np.zeros(3, F)
    for a in range(A):
        s = a // (A // S)
        kind, P, V, rows = {}, {}, {}, {}
        for o in range(O + 1):
            kind[o], P[o], V[o] = KIND_CV, zero, zero
            if o == O or o < OA:
                r = order[a, o] if o < O else None
                p3, v3, hp, row = ((pos[a], vel[a], has_prev[a], prev[a]) if o == O else
                                   (src["pos"][r], src["vel"][r], src["has_prev"][r],
                                    src["prev_ctrl"][r]))
                P[o], rows[o] = p3, row.reshape(-1)
                if (o == O and disturbed[a]) or cfg.mode == stages.MODE_BVC:
                    pass  # const_vel_ctrl(pos, 0)
                elif cfg.mode == stages.MODE_RSFC or not hp:
                    V[o] = v3
                else:
                    kind[o] = KIND_ROW
                if o < O:
                    out["obs_valid"][a, o], out["obs_is_agent"][a, o] = valid[a, o], True
                    out["obs_radius"][a, o] = src["radius"][r]
                    out["obs_downwash"][a, o] = src["downwash"][r]
                    out["obs_pos_now"][a, o], out["obs_goal"][a, o] = p3, src["goal"][r]
            elif OD:
                k = s * OD + o - OA
                P[o], V[o] = dyn["pos"][k], dyn["vel"][k]
                out["obs_valid"][a, o] = dyn["valid"][k]
                out["obs_radius"][a, o], out["obs_downwash"][a, o] = (dyn["radius"][k],
                                                                      dyn["downwash"][k])
                out["obs_max_acc"][a, o] = dyn["max_acc"][k]
                out["obs_pos_now"][a, o] = out["obs_goal"][a, o] = dyn["pos"][k]
            else:
                kind[o] = KIND_PAD
                out["obs_radius"][a, o], out["obs_downwash"][a, o] = F(0.1), F(1.0)
        for o in range(OA):  # the disturbance reset
            if kind[o] == KIND_ROW:
                e = [_row_value(rows[o], sub, N, MN3, d, 0, 0, d) - P[o][d] for d in range(3)]
                if _norm(e) > sc["reset"]:
                    kind[o], V[o] = KIND_CV, zero

        def pred(o, r):
            m = r // N3
            i = (r - m * N3) // 3
            d = r - m * N3 - 3 * i
            if kind[o] == KIND_ROW:
                return _row_value(rows[o], sub, N, MN3, r, m, i, d)
            if kind[o] == KIND_CV:
                return P[o][d] + F(V[o][d] * tt[m * N + i])
            return F(0)

        flat = out["obs_pred"][a].reshape(-1)
        for f in range(O * MN3):
            flat[f] = pred(f // MN3, f % MN3)
        flat = out["initial_ctrl"][a].reshape(-1)
        for f in range(MN3):
            flat[f] = pred(O, f)
        if cfg.sizes:
            guard = F(0)
            if cfg.velocity_guard is not None:
                guard = F(F(sc["guard"] * _dotn(vel[a], vel[a], 3)) / max_acc[a, 0])
            flat = out["obs_pred_sizes"][a].reshape(-1)
            for f in range(O * M * N):
                o, mi = divmod(f, M * N)
                x = out["obs_radius"][a, o]
                if cfg.size_growth and (not out["obs_is_agent"][a, o]
                                        or cfg.mode == stages.MODE_RSFC):
                    x = F(x + guard) + F(out["obs_max_acc"][a, o] * growth[mi])
                flat[f] = x
    return out


def twin_fused(cfg, sc, fleet, inp, S):
    """step_front_kernel with its own selection: select_nearest's slots,
    then the prediction from them."""
    order, valid = twin_neighbors(np32(inp.pos), S, cfg.OA, F(sc["range"]), cfg.comm_range > 0)
    return order, valid, twin_front(cfg, sc, fleet, inp, torch.as_tensor(order),
                                    torch.as_tensor(valid), None, S)


def twin_goal(cfg, sc, fleet, inp, normals, anchors, margins, obs_valid, sfc_lo_w, sfc_hi_w,
              planner_seq):
    """goal_qp_inputs_kernel, an agent at a time."""
    A, O, M, N, dim, phi = inp.pos.shape[0], cfg.O, cfg.M, cfg.n + 1, cfg.dim, cfg.phi
    g = {k: np32(getattr(inp, k)) for k in ("pos", "vel", "current_goal", "desired_goal",
                                             "next_waypoint", "is_disturbed", "has_prev")}
    nrm, anc, mg, ov = np32(normals), np32(anchors), np32(margins), np32(obs_valid)
    lo_w, hi_w = (np32(sfc_lo_w), np32(sfc_hi_w)) if cfg.use_sfc else (None, None)
    wlo, whi, nom, rad = np32(cfg.world_lo), np32(cfg.world_hi), np32(fleet.nominal_velocity), \
        np32(fleet.radius)
    y0_in = np32(inp.qp_y0) if inp.qp_y0 is not None and cfg.warm_duals else None
    out = dict(new_goal=np.zeros((A, 3), F), terminal_mask=np.zeros((A, M), F),
               lsc_rhs=np.zeros((A, O, M, N), F), lsc_active=np.zeros((A, O, M, N), bool),
               lb=np.zeros((A, dim, M, N), F), ub=np.zeros((A, dim, M, N), F),
               comm_halfrange=np.zeros(A, F))
    if y0_in is not None:
        out["y0"] = np.zeros_like(y0_in)
    for a in range(A):
        p3 = g["pos"][a]
        if cfg.goal == stages.GOAL_LP:
            w = g["next_waypoint"][a]
            gw = g["current_goal"][a] - w
            lower, upper, infeas = F(-np.inf), F(np.inf), False
            for o in range(O):
                n3, c3 = nrm[a, o, M - 1], anc[a, o, M - 1, N - 1]
                al = _dotn(n3, gw, dim)
                bl = mg[a, o, M - 1, N - 1] + _dotn(n3, c3 - w, dim)
                vl = ov[a, o] and _norm(n3, dim) > EPS
                if vl and al > EPS:
                    lower = max(lower, F(bl / al))
                if vl and al < -EPS:
                    upper = min(upper, F(bl / al))
                if vl and abs(al) <= EPS and bl > EPS:
                    infeas = True
            if cfg.use_sfc:
                for k in range(dim):
                    for a_s, b_s in ((gw[k], lo_w[a, M - 1, k] - w[k]),
                                     (-gw[k], -(hi_w[a, M - 1, k] - w[k]))):
                        if a_s > EPS:
                            lower = max(lower, F(b_s / a_s))
                        if a_s < -EPS:
                            upper = min(upper, F(b_s / a_s))
            t = min(max(lower, F(0)), F(1.0 + 1e-6))
            if t > upper + F(1e-5) or infeas:
                t = F(1)
            goal = [F(gw[k] * t) + w[k] for k in range(dim)]
            if dim == 2:
                goal.append(g["current_goal"][a, 2])
        elif cfg.goal == stages.GOAL_RIGHT_HAND:
            dg = g["desired_goal"][a]
            dl = (planner_seq > cfg.deadlock_seq and _norm(g["vel"][a]) < sc["dl_vel"]
                  and _norm(p3 - dg) > F(0.2))
            u = dg - p3
            c = (_fms(u[1], 1, u[2], 0), _fms(u[2], 0, u[0], 1), _fms(u[0], 0, u[1], 0))
            goal = [p3[k] + c[k] if dl else dg[k] for k in range(3)]
        else:
            goal = list((g["current_goal"] if cfg.goal == stages.GOAL_HOST
                         else g["desired_goal"])[a])
        if g["is_disturbed"][a]:
            goal = list(p3)
        out["new_goal"][a] = goal
        ift = F(_norm(np.asarray(goal, F) - p3) / nom[a])
        tseg = max(int(np.floor(F(F(F(sc["Mdt"]) - ift) + F(sc["tiny"])) / F(sc["dt"]))), 1)
        out["terminal_mask"][a] = [F(m >= M - tseg) for m in range(M)]
        for o in range(O):
            for m in range(M):
                live = ov[a, o] and _norm(nrm[a, o, m]) > EPS
                for i in range(N):
                    out["lsc_rhs"][a, o, m, i] = F(_dotn(nrm[a, o, m], anc[a, o, m, i], dim)
                                                   + mg[a, o, m, i]) + F(sc["qp_margin"])
                    out["lsc_active"][a, o, m, i] = live and not (m == 0 and i < phi)
        for k in range(dim):
            for m in range(M):
                for i in range(N):
                    lo, hi = wlo[k], whi[k]
                    if cfg.use_sfc:
                        lo, hi = max(lo, lo_w[a, m, k]), min(hi, hi_w[a, m, k])
                    if cfg.comm_range > 0 and i == N - 1:
                        wp = g["next_waypoint"][a, k]
                        lo, hi = max(lo, wp - F(sc["comm_box"])), min(hi, wp + F(sc["comm_box"]))
                    out["lb"][a, k, m, i], out["ub"][a, k, m, i] = lo, hi
        out["comm_halfrange"][a] = (F(sc["comm_half"]) - rad[a] if cfg.comm_range > 0
                                    else F(1e19))
        if y0_in is not None:
            keep = F(1.0 if g["has_prev"][a] and not g["is_disturbed"][a] else 0.0)
            out["y0"][a] = y0_in[a] * keep
    return out


# ---- twins against the plain bodies ------------------------------------------
def lattice(A, S=1):
    """A square lattice of 0.75 m (exact in binary, so its L∞ distances
    tie exactly; build_fleet's lattice is jittered), S copies, each moved
    by a lattice step along x."""
    side = int(np.ceil(np.sqrt(A)))
    ij = np.stack(np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), -1)
    pos = np.concatenate([ij.reshape(-1, 2)[:A] * 0.75, np.full((A, 1), 0.6)], 1)
    return torch.as_tensor(np.concatenate([pos + [0.75 * s, 0.0, 0.0] for s in range(S)]),
                           dtype=torch.float32)


@pytest.mark.parametrize("A,S,OA,rng", [(24, 1, 16, 3.0), (72, 1, 20, 3.0), (40, 2, 16, 3.0),
                                         (30, 1, 8, -1.0), (17, 1, 16, 3.0)])
def test_neighbor_twin_equals_plain(A, S, OA, rng):
    pos = lattice(A, S)
    order, valid = stages._neighbor_slots_plain(pos, S, OA, rng)
    t_order, t_valid = twin_neighbors(pos.numpy(), S, OA, F(rng), rng > 0)
    np.testing.assert_array_equal(t_order, order.numpy())
    np.testing.assert_array_equal(t_valid, valid.numpy())
    # the lattice has ties: the lower index comes first among them
    d = (pos[order] - pos[:, None]).abs().amax(-1)
    assert (d[:, 1:] == d[:, :-1]).any()


@pytest.mark.parametrize("A,S,OA,rng,K,threads,warp", [
    (72, 1, 20, 3.0, 32, 128, 32),  # the <32> lists, one tile
    (40, 2, 16, -1.0, 16, 128, 32),  # the <16> lists, two scenarios, no range
    (24, 1, 5, 3.0, 2, 8, 4),  # tiles of 16: a list merged with each tile's sorted keys
    (37, 2, 7, -1.0, 4, 4, 2),  # tiles of 16, ragged; warps that run out of keys
])
def test_neighbor_twin_lists(A, S, OA, rng, K, threads, warp):
    """The selection's algorithm with other lists and block shapes (the
    kernel's K is list_len's; these reach its merges of tiles and warps
    at A <= 72) equals the plain body on the tied lattice."""
    pos = lattice(A, S)
    order, valid = stages._neighbor_slots_plain(pos, S, OA, rng)
    t_order, t_valid = twin_neighbors(pos.numpy(), S, OA, F(rng), rng > 0, K, threads, warp)
    np.testing.assert_array_equal(t_order, order.numpy())
    np.testing.assert_array_equal(t_valid, valid.numpy())


@pytest.mark.parametrize("A,OA,K", [(2, 1, 8), (72, 20, 8), (1024, 32, 8), (1025, 8, 8),
                                    (1025, 16, 16), (2048, 16, 16), (2049, 20, 32),
                                    (8192, 32, 32)])
def test_list_len(A, OA, K):
    """A thread's list holds min(OA, its candidates): 8 up to A = 1,024."""
    assert step_cuda.list_len(A, OA) == K


@pytest.mark.parametrize("name", list(MODES))
def test_front_twin_equals_plain(name):
    planner, calls = recorded(name, 12, fuse=False)
    (a, _, got), = calls["step_front"]
    cfg, fleet, inp, order, valid, nd, S = a
    want = twin_front(cfg, stages.stage_scalars(cfg), fleet, inp, order, valid, nd, S)
    for field, v in want.items():
        assert_equal_by_value(v, np32(getattr(got, field)), f"{name} {field}")
    assert (got.obs_pred_sizes is not None) == cfg.sizes


@pytest.mark.parametrize("name", list(MODES))
def test_fused_twin_equals_plain(name):
    """The prediction kernel with its own selection, in Python, equals
    the plain neighbour selection and prediction of the step."""
    planner, calls = recorded(name, 12)
    assert not calls["neighbor_slots"] and not calls["step_front"]
    (a, _, (order, valid, got)), = calls["front_with_neighbors"]
    cfg, fleet, inp, S = a
    t_order, t_valid, want = twin_fused(cfg, stages.stage_scalars(cfg), fleet, inp, S)
    assert_equal_by_value(t_order, np32(order), f"{name} order")
    assert_equal_by_value(t_valid, np32(valid), f"{name} valid")
    for field, v in want.items():
        assert_equal_by_value(v, np32(getattr(got, field)), f"{name} {field}")


@pytest.mark.parametrize("name", list(MODES))
def test_goal_twin_equals_plain(name):
    planner, calls = recorded(name, 12)
    (a, k, got), = calls["goal_qp_inputs"]
    cfg = a[0]
    want = twin_goal(cfg, stages.stage_scalars(cfg), *a[1:])
    for field, v in want.items():
        assert_equal_by_value(v, np32(getattr(got, field)), f"{name} {field}")
    assert (got.y0 is None) == ("y0" not in want)


def test_cases_reach_every_branch():
    """The recorded states reset predictions, hold disturbed agents, find
    deadlocks and cut goals short on LSC rows and SFC faces."""
    _, calls = recorded("lsc_dr_2d", 12)
    (a, _, (_, _, fr)), = calls["front_with_neighbors"]
    inp = a[2]
    # a held slot stays at the neighbour's position; the 0.7 m moves reset
    held = (fr.obs_pred - fr.obs_pos_now[..., None, None, :]).abs().amax((-1, -2, -3)) == 0
    assert held[:, :a[0].OA].any() and (~held[:, :a[0].OA]).any()
    (a, _, gq), = calls["goal_qp_inputs"]
    t_goal = (gq.new_goal - inp.next_waypoint)[:, :2].norm(dim=-1)
    assert (t_goal > 0).any()
    assert (gq.new_goal == inp.pos).all(-1)[inp.is_disturbed].all()
    _, calls = recorded("lsc_right_hand", 12)
    (a, _, gq), = calls["goal_qp_inputs"]
    inp = a[2]
    moved = (gq.new_goal != inp.desired_goal).any(-1) & ~inp.is_disturbed
    assert moved.any()


# ---- the plain bodies against the JAX package --------------------------------
def _jax_planner(name, A, plan_t):
    from lsc_dr_planner_tpu.config import GoalMode as GoalModeJ
    from lsc_dr_planner_tpu.config import Param as ParamJ
    from lsc_dr_planner_tpu.config import PlannerMode as PlannerModeJ
    from lsc_dr_planner_tpu.planner import pipeline as jpipe
    from lsc_dr_planner_tpu.world.grid import build_grid_world as jbuild

    kw = {}
    for key, v in {**dict(goal_mode=GoalMode.GRID_BASED_PLANNER, world_use_octomap=True,
                          world_dimension=2, communication_range=3.0, max_obstacles=16),
                   **MODES[name]}.items():
        if isinstance(v, PlannerMode):
            v = PlannerModeJ[v.name]
        elif isinstance(v, GoalMode):
            v = GoalModeJ[v.name]
        kw[key] = v
    pj = ParamJ(**kw)
    _, _, boxes, wmin, wmax = workload.fleet_layout(A)
    od = OD if name == "dynobs" else 0
    plan_j = jpipe.FleetPlanner(pj, jbuild(boxes, wmin, wmax, pj.world_resolution, 0.15), A,
                                max_dynobs=od, agent_radius=0.15, max_vel_hint=1.0)
    assert plan_j.O == plan_t.O and plan_j.sfc_expand_cells == plan_t.sfc_expand_cells
    return jpipe, plan_j


def _jax_step(jpipe, plan_j, fleet, inp):
    """The JAX package's deferred step in debug mode on the port's state:
    (its DeferredQP, its debug stash)."""
    import jax.numpy as jnp

    def j(v):
        return v if v is None or isinstance(v, int) else jnp.asarray(v.numpy())

    fleet_j = jpipe.FleetArrays(**{f.name: j(getattr(fleet, f.name))
                                   for f in dataclasses.fields(fleet)})
    inp_j = jpipe.StepInputs(**{f.name: j(getattr(inp, f.name))
                                for f in dataclasses.fields(inp)})
    plan_j.debug = True
    d = plan_j._step_impl(fleet_j, inp_j, defer_qp=True)
    return d, plan_j._dbg


def _split(x, S):
    return None if x is None else torch.chunk(x, S)


@pytest.mark.parametrize("name", list(MODES))
def test_stages_match_jax(name):
    """One deferred step of both packages on the same state, through their
    debug stashes: the neighbour slots exactly, stages 1 and 2 at
    ATOL_PRED and the goal at ATOL_GOAL; then the port's goal and QP-input
    body on the JAX package's own corridor, slots and SFC boxes against
    the JAX package's goal and assembled QP inputs: the goal at 1e-5, the
    rows at ATOL_ROWS_SAME, the masks, bounds, comm half-range and warm
    start exactly."""
    A = 12
    planner, fleet, inp, S = mode_state(name, A)
    planner.debug = True
    d_t = planner._step_impl(fleet, inp, defer_qp=True, scenarios=S)
    dbg_t = planner._dbg
    jpipe, plan_j = _jax_planner(name, A, planner)
    per = []
    for s in range(S):
        sl = slice(s * A, (s + 1) * A)
        fl = dataclasses.replace(fleet, **{f.name: getattr(fleet, f.name)[sl]
                                           for f in dataclasses.fields(fleet)})
        ins = {f.name: getattr(inp, f.name) for f in dataclasses.fields(inp)}
        ins = type(inp)(**{k: (v[sl] if isinstance(v, torch.Tensor) and not k.startswith("dynobs")
                               else v) for k, v in ins.items()})
        d, g = _jax_step(jpipe, plan_j, fl, ins)
        t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
        mine = stages._goal_qp_plain(planner.stage_cfg, fl, ins, t(g["ls"].normals),
                                     t(g["ls"].anchors), t(g["ls"].margins), t(g["obs_valid"]),
                                     t(g["sfc_lo_w"]), t(g["sfc_hi_w"]), inp.planner_seq)
        per.append((d, g, mine))

    def jcat(get):
        return np.concatenate([np.asarray(get(*x)) for x in per])

    # the neighbour slots (lax.top_k against the stable sort): exact
    for f in ("pos", "vel", "radius", "downwash", "goal", "has_prev", "valid"):
        np.testing.assert_array_equal(np32(getattr(dbg_t["nd"], f)),
                                      jcat(lambda d, g, m: getattr(g["nd"], f)), err_msg=f)
    # stages 1 and 2
    for f in ("obs_pred", "initial_ctrl"):
        np.testing.assert_allclose(np32(dbg_t[f]), jcat(lambda d, g, m: g[f]), rtol=0,
                                   atol=ATOL_PRED, err_msg=f)
    np.testing.assert_array_equal(np32(dbg_t["obs_valid"]),
                                  jcat(lambda d, g, m: g["obs_valid"]))
    np.testing.assert_allclose(np32(d_t.new_goal), jcat(lambda d, g, m: d.new_goal), rtol=0,
                               atol=ATOL_GOAL)
    # stage 5 and the assembly of stage 6 on the JAX package's corridor
    np.testing.assert_allclose(jcat(lambda d, g, m: m.new_goal),
                               jcat(lambda d, g, m: d.new_goal), rtol=0, atol=1e-5)
    for f in ("terminal_mask", "lsc_active", "comm_halfrange", "lb", "ub"):
        np.testing.assert_array_equal(jcat(lambda d, g, m: getattr(m, f)),
                                      jcat(lambda d, g, m: getattr(d.qp_inp, f)), err_msg=f)
    np.testing.assert_allclose(jcat(lambda d, g, m: m.lsc_rhs),
                               jcat(lambda d, g, m: d.qp_inp.lsc_rhs), rtol=0, atol=ATOL_ROWS_SAME)
    if per[0][2].y0 is None:
        assert all(d.qp_inp.y0 is None for d, _, _ in per)
    else:
        np.testing.assert_array_equal(jcat(lambda d, g, m: m.y0),
                                      jcat(lambda d, g, m: d.qp_inp.y0))
    # the port's own step assembled the same way from its corridor
    assert_equal_by_value(np32(d_t.qp_inp.lsc_rhs), np32(dbg_t["rhs"]), "rhs")


@pytest.mark.parametrize("A,rng", [(72, 3.0), (40, -1.0)])
def test_neighbor_slots_match_lax_top_k(A, rng):
    """The plain neighbour selection against the JAX package's
    _neighbor_slots (lax.top_k) on an exact lattice, ties included: the
    same order and validity, exactly."""
    import types

    import bench
    import jax.numpy as jnp

    pj, plan_j, fleet_j, _ = bench.build_fleet(A)
    plan_j.param = dataclasses.replace(pj, communication_range=rng)
    pos = lattice(A)
    order_j, valid_j, _ = plan_j._neighbor_slots(types.SimpleNamespace(pos=jnp.asarray(pos)),
                                                 fleet_j)
    order, valid = stages._neighbor_slots_plain(pos, 1, plan_j.O_agents, rng)
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))


# ---- dispatch ------------------------------------------------------------------
def _counts():
    return (step_cuda.neighbor_launches, step_cuda.front_launches, step_cuda.fused_launches,
            step_cuda.goal_launches, stages.neighbor_plain_on_cuda, stages.front_plain_on_cuda,
            stages.fused_plain_on_cuda, stages.goal_plain_on_cuda)


def test_cpu_tensors_take_the_plain_bodies():
    """One call of the fused entry and of the goal's a step (or of each
    separate entry), all through the plain bodies: no launch, no plain
    body counted as run on the card."""
    counts = _counts()
    _, calls = recorded("lsc_dr_2d", 12)
    assert [len(calls[n]) for n in Record.NAMES] == [0, 0, 1, 1]
    _, calls = recorded("lsc_dr_2d", 12, fuse=False)
    assert [len(calls[n]) for n in Record.NAMES] == [1, 1, 0, 1]
    assert counts == _counts()


def test_kernel_entries_raise_on_cpu_tensors():
    planner, calls = recorded("lsc_dr_2d", 12)
    cfg = planner.stage_cfg
    sc = stages.stage_scalars(cfg)
    (a, _, (order, valid, _)), = calls["front_with_neighbors"]
    (g, _, _), = calls["goal_qp_inputs"]
    launches = _counts()
    with pytest.raises(ValueError, match="CUDA"):
        step_cuda.neighbor_slots_cuda(cfg, sc, a[2].pos, 1)
    with pytest.raises(ValueError, match="CUDA"):
        step_cuda.step_front_cuda(cfg, sc, a[1], a[2], order, valid, None, 1)
    with pytest.raises(ValueError, match="CUDA"):
        step_cuda.front_with_neighbors_cuda(cfg, sc, a[1], a[2], 1)
    with pytest.raises(ValueError, match="CUDA"):
        step_cuda.goal_qp_inputs_cuda(cfg, sc, *g[1:])
    assert launches == _counts()


def test_outputs_have_their_shapes_and_types():
    out = step_cuda._outputs(torch.device("cpu"), [("a", (3, 5), torch.float32),
                                                   ("b", (7,), torch.bool),
                                                   ("c", (2, 2), torch.int64)])
    assert [(t.shape, t.dtype, t.is_contiguous()) for t in out.values()] == [
        ((3, 5), torch.float32, True), ((7,), torch.bool, True), ((2, 2), torch.int64, True)]


def test_ptrs_copy_a_view_once():
    """A non-contiguous input (3-D's prev_ctrl, a permuted view, passed as
    the sources and as the agents' own) is copied once; contiguous ones
    and None pass as they are."""
    view = torch.arange(24.0).reshape(2, 3, 4).permute(0, 2, 1)
    flat = torch.zeros(5)
    ptrs, keep = step_cuda._ptrs([view, flat, None, view])
    assert keep[0] is keep[3] and keep[0].is_contiguous() and keep[1] is flat and keep[2] is None
    assert torch.equal(keep[0], view)
    assert [ptrs[i] for i in range(4)] == [keep[0].data_ptr(), flat.data_ptr(), None,
                                           keep[0].data_ptr()]


# ---- on the card -----------------------------------------------------------------
@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage kernels have no CPU mode")
    return torch.device("cuda", 0)


def _fields(entry, out):
    """(name, tensor) of an entry's outputs."""
    if entry == "neighbor_slots":
        return list(zip(("order", "valid"), out))
    if entry == "front_with_neighbors":
        return [("order", out[0]), ("valid", out[1])] + _fields("step_front", out[2])
    return [(f.name, getattr(out, f.name)) for f in dataclasses.fields(out)]


def kernels_vs_plain(calls):
    """Each recorded call (made on the card, through the kernels) against
    its plain body on the same inputs: {entry: elements compared}."""
    n = {}
    for entry, cs in calls.items():
        for a, k, got in cs:
            want = getattr(stages, entry)(*a, **k, plain=True)
            pairs = ((name, x, y) for (name, x), (_, y) in zip(_fields(entry, got),
                                                               _fields(entry, want)))
            for field, x, y in pairs:
                assert (x is None) == (y is None), (entry, field)
                if x is not None:
                    assert_equal_by_value(np32(x), np32(y), f"{entry} {field}")
                    n[entry] = n.get(entry, 0) + x.numel()
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODES))
def test_kernels_equal_plain_on_card(cuda_dev, name):
    """The step's stage calls, fused and then separate, each one launch,
    equal to their plain bodies."""
    planner, fleet, inp, S = mode_state(name, 64, cuda_dev)
    with Record() as rec:
        for route, added in ((contextlib.nullcontext(), (0, 0, 1, 1)), (separate(), (1, 1, 0, 1))):
            counts = _counts()
            with route:
                planner._step_impl(fleet, inp, defer_qp=True, scenarios=S)
            torch.cuda.synchronize()
            assert _counts() == tuple(c + d for c, d in zip(counts, added + (0,) * 4))
    n = kernels_vs_plain(rec.calls)
    assert sorted(n) == sorted(Record.NAMES) and all(v > 0 for v in n.values()), n


@pytest.mark.cuda
@pytest.mark.parametrize("A,S,OA,rng", [(1024, 1, 16, 3.0), (72, 1, 20, 3.0), (64, 8, 16, 3.0),
                                         (30, 1, 8, -1.0),
                                         # tiles: 3 of 1,024 (K 8), 3 of 2,048 (K 16)
                                         (3000, 2, 8, 3.0), (5000, 1, 16, -1.0),
                                         (2100, 1, 20, -1.0)])  # lists of 32
def test_neighbor_kernel_on_lattice(cuda_dev, A, S, OA, rng):
    pos = lattice(A, S).to(cuda_dev)
    cfg = dataclasses.replace(recorded("lsc_dr_2d", 12)[0].stage_cfg, OA=OA, comm_range=rng,
                              cache={})
    got = step_cuda.neighbor_slots_cuda(cfg, stages.stage_scalars(cfg), pos, S)
    want = stages._neighbor_slots_plain(pos, S, OA, rng)
    for x, y in zip(got, want):
        assert_equal_by_value(np32(x), np32(y), "neighbor_slots")


@pytest.mark.cuda
def test_kernels_on_main_path_state(cuda_dev):
    _, calls = recorded("lsc_dr_2d", 1024, cuda_dev)
    n = kernels_vs_plain(calls)
    assert n["front_with_neighbors"] > 1024 * 16 * 180
