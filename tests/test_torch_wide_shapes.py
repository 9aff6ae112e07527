"""The port at the shapes above its narrow kernels' builds, on the CPU:
3-D at M = 12 and above (dim·K 102 to 246), neighbour sets of more than
32 agents and more than 64 obstacle slots, as the reference plans them
(every agent within communication range is an obstacle).

- Teacher-forced steps of the port's plain path against the JAX package
  at those shapes, with test_torch_pipeline.py's assertions (SFC boxes
  equal, convergence equal, goal within 1e-4, control points within 0.1
  m where both converged). The JAX side takes its Param overrides from
  a patched `lsc_dr_planner_tpu.config.Param` (bench.build_fleet builds
  its Param in-process).
- The plain `qp.solve` against the JAX `solve` at dim·K 138 and 246.
- Python twins of the wide builds of csrc/step_stages.cu (the radix
  selection of any OA over distance bits computed once, the prediction
  with its slot tables sized by O and its outputs a store stream, the
  shifted rows read from the source rows) against the plain bodies
  `stages._neighbor_slots_plain` and `stages._front_plain`, bit for bit.

The kernels themselves run on the card: tests/test_torch_cuda.py and
tests/test_torch_step_stages.py (marked `cuda`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import bench
from lsc_dr_planner_tpu_torch import convert, workload
from lsc_dr_planner_tpu_torch.config import Param, PlannerMode
from lsc_dr_planner_tpu_torch.ops import qp as tqp
from lsc_dr_planner_tpu_torch.ops import step_cuda, trajectory
from lsc_dr_planner_tpu_torch.planner import stages
from test_torch_step_stages import (
    FULL, KIND_CV, KIND_PAD, KIND_ROW, F, _cv_time, _dotn, _norm, _row_value,
    assert_equal_by_value, lattice, np32,
)

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

STEPS = 2
# (agents, Param overrides): 3-D at M = 12 (K = 34, dim·K 102) with 40
# slots; with every agent within 5 m an obstacle (66 slots); DLSC in 3-D
# (K = 36, dim·K 108); Bézier degree 8 (N = 9 control points: the hull
# kernels' run-time build) in 2-D (K = 58, dim·K 116) and in DLSC sub-step
# (its subSegment re-parameterisation depends on n)
CASES = {
    "A48_3d_M12_40": (48, dict(world_dimension=3, M=12, max_obstacles=40)),
    "A72_3d_M12_5m_66": (72, dict(world_dimension=3, M=12, communication_range=5.0,
                                  max_obstacles=66)),
    "dlsc_3d_M12": (24, dict(world_dimension=3, M=12, planner_mode=PlannerMode.DLSC)),
    "n8_2d": (32, dict(n=8)),
    "n8_dlsc_substep": (24, dict(n=8, planner_mode=PlannerMode.DLSC, multisim_time_step=0.1)),
}


def _fields(obj):
    return obj._asdict() if hasattr(obj, "_asdict") else vars(obj)


def _jax_overrides(overrides):
    """The overrides with the JAX package's enums."""
    from lsc_dr_planner_tpu import config as jconfig

    out = {}
    for k, v in overrides.items():
        if isinstance(v, PlannerMode):
            v = jconfig.PlannerMode[v.name]
        out[k] = v
    return out


def _jax_fleet(monkeypatch, A, overrides):
    """bench.build_fleet(A) with the overrides set over its Param."""
    from lsc_dr_planner_tpu import config as jconfig

    base = jconfig.Param
    over = _jax_overrides(overrides)
    monkeypatch.setattr(jconfig, "Param", lambda **kw: base(**{**kw, **over}))
    return bench.build_fleet(A)


# Degree 8's QPs are ill-conditioned for float32 ADMM: on the same QP inputs
# (equal to ~1e-6 here) the JAX package's float32 solve lies up to 0.65 m from
# the float64 solve (qp_check.solve_f64) and the port's up to 0.14 m (2-D, 32
# agents, step 0; in DLSC sub-step 0.41 m and 0.21 m, and each float32 solve
# leaves ~1 in 5 agents unconverged that float64 converges), and agent by agent
# either may be the nearer, so two float32 solves cannot agree to 0.1 m. In
# these cases the QP inputs are held to the JAX package's, the step's control
# points to its QP's solution, and that float32 solve must be no less exact
# than the JAX package's: its farthest agent from the float64 solve no
# farther than the JAX solve's farthest (or within 0.1 m), over the agents
# both converged; and the converged set may lose one straggler a step
# (test_torch_qp.py's contract).
F64_CASES = ("n8_2d", "n8_dlsc_substep")


def _no_less_exact(plan_j, fleet_j, inp_j, qt, both):
    """Asserts that the port's QP inputs `qt` are the JAX package's (rtol
    1e-6, atol 1e-5); then the port's float32 solve of `qt` and the JAX
    package's float32 solve against the float64 solve of the JAX
    package's QP: (the port's farthest agent within 0.1 m or no farther
    than the JAX solve's, over the agents `both`; the two distances; the
    float64 solve's converged share; the port's solution [A, dim, M, N])."""
    from lsc_dr_planner_tpu.ops import qp as jqp
    from lsc_dr_planner_tpu_torch.ops import qp_check
    from test_torch_qp import port_cfg, port_inputs

    qj = plan_j._step_impl(fleet_j, inp_j, defer_qp=True).qp_inp
    for k, v in qj._asdict().items():
        if v is not None:
            np.testing.assert_allclose(getattr(qt, k).numpy(), np.asarray(v), rtol=1e-6,
                                       atol=1e-5, err_msg=k)
    cfg, feas_tol = port_cfg(plan_j.qp_cfg), plan_j.feas_tol
    exact = qp_check.solve_f64(cfg, port_inputs(qj), feas_tol)
    x64 = exact.x.numpy()
    A = len(both)
    xt = tqp.solve(cfg, qt, feas_tol).x.numpy().astype(np.float64)
    xj = np.asarray(jqp.solve(plan_j.qp_cfg, qj, feas_tol=feas_tol).x, np.float64)
    d_t, d_j = (np.abs(x - x64).reshape(A, -1).max(1)[both].max(initial=0.0)
                for x in (xt, xj))
    return d_t <= max(0.1, d_j), (d_t, d_j), float(exact.converged.float().mean()), xt


@pytest.mark.parametrize("case", list(CASES))
def test_teacher_forced_steps_match_jax(monkeypatch, case):
    A, overrides = CASES[case]
    pj, plan_j, fleet_j, inp_j = _jax_fleet(monkeypatch, A, overrides)
    step_j = bench.make_evolve_step(pj, plan_j, fleet_j)
    p, plan_t, fleet_t, inp_t = workload.build_fleet(A, device="cpu", **overrides)
    want = Param(**overrides)
    assert plan_t.O == plan_j.O and plan_t.qp_cfg.M == p.M == plan_j.qp_cfg.M == want.M
    assert plan_t.qp_cfg.n == p.n == plan_j.qp_cfg.n == want.n
    K = tqp.torch_statics(plan_t.qp_cfg, torch.device("cpu"))["K"]
    assert 3 * K > 96, K  # above the register builds of the ADMM kernel
    np.testing.assert_array_equal(inp_t.pos.numpy(), np.asarray(inp_j.pos))
    fleet = convert.fleet_from_numpy(_fields(fleet_j), "cpu")
    for s in range(STEPS):
        out_j = plan_j.step(fleet_j, inp_j)
        out_t = convert.outputs_to_numpy(
            plan_t.step(fleet, convert.inputs_from_numpy(_fields(inp_j), "cpu")))
        np.testing.assert_array_equal(out_t["sfc_lo"], np.asarray(out_j.sfc_lo))
        np.testing.assert_array_equal(out_t["sfc_hi"], np.asarray(out_j.sfc_hi))
        conv_j, conv_t = np.asarray(out_j.qp_converged), out_t["qp_converged"]
        if case in F64_CASES:
            assert conv_t.sum() >= conv_j.sum() - 1, (s, conv_t.mean(), conv_j.mean())
        else:
            np.testing.assert_array_equal(conv_t, conv_j, err_msg=f"step {s}")
        np.testing.assert_allclose(out_t["current_goal"], np.asarray(out_j.current_goal),
                                   rtol=0, atol=1e-4)
        both = conv_t & conv_j
        if case in F64_CASES:
            qt = plan_t._step_impl(fleet, convert.inputs_from_numpy(_fields(inp_j), "cpu"),
                                   defer_qp=True).qp_inp
            ok, dists, conv64, xt = _no_less_exact(plan_j, fleet_j, inp_j, qt, both)
            assert ok, (s, dists)
            assert conv64 > 0.9, (s, conv64)
            # the step's control points are its QP's solution
            got = out_t["desired_ctrl"][..., :p.world_dimension]
            np.testing.assert_array_equal(got[both], np.moveaxis(xt, 1, -1)[both])
        else:
            dctrl = np.abs(out_t["desired_ctrl"] - np.asarray(out_j.desired_ctrl))[conv_j]
            assert dctrl.max(initial=0.0) < 0.1, (s, dctrl.max())
        inp_j, _ = step_j(inp_j)
    if case not in F64_CASES:
        assert conv_j.mean() > 0.9


@pytest.mark.parametrize("M,dk", [(16, 138), (28, 246)])
def test_plain_solve_matches_jax(monkeypatch, M, dk):
    """The port's plain QP (its preparation body and loop) against the JAX
    solve on the same QP of a 3-D fleet of 4 after 2 evolving steps, with
    test_torch_qp.py's contract."""
    from lsc_dr_planner_tpu.ops import qp as jqp
    from test_torch_qp import check_contract, port_cfg, port_inputs

    p, planner, fleet, inp = _jax_fleet(monkeypatch, 4, dict(world_dimension=3, M=M))
    step = bench.make_evolve_step(p, planner, fleet)
    for _ in range(2):
        inp, _ = step(inp)
    cfg, feas_tol = planner.qp_cfg, planner.feas_tol
    qp_inp = planner._step_impl(fleet, inp, defer_qp=True).qp_inp
    pcfg = port_cfg(cfg)
    assert pcfg.dim * tqp.torch_statics(pcfg, torch.device("cpu"))["K"] == dk
    ref = jqp.solve(cfg, qp_inp, feas_tol=feas_tol)
    out = tqp.solve(pcfg, port_inputs(qp_inp), feas_tol=feas_tol)
    check_contract(out, ref, feas_tol, full_convergence=False)


def test_jax_plans_degree_8_and_pins_3_points(monkeypatch):
    """What the JAX package plans, for the port's kernels: Bézier segments
    of degree 8 (N = 9 points; the hull kernels' run-time build takes
    them, test_teacher_forced_steps_match_jax's n8 cases) and no pin count
    but 3 (the preparation kernel's phi = 3 is its own)."""
    from lsc_dr_planner_tpu import config as jconfig

    base = jconfig.Param
    p, planner, fleet, inp = _jax_fleet(monkeypatch, 8, dict(n=8))
    step = bench.make_evolve_step(p, planner, fleet)
    inp, conv = step(inp)
    assert np.isfinite(np.asarray(inp.prev_ctrl)).all() and np.asarray(conv).mean() > 0.5
    monkeypatch.setattr(jconfig, "Param", base)
    p, planner, fleet, inp = _jax_fleet(monkeypatch, 8, dict(phi=2))
    with pytest.raises(ValueError):
        bench.make_evolve_step(p, planner, fleet)(inp)


# ---- the wide selection, in Python ------------------------------------------
THREADS, WARP = step_cuda.BLOCK_THREADS, 32


def sort_len(OA):
    P = 1
    while P < OA:
        P <<= 1
    return P


def bitonic(keys):
    """The kernel's block-wide bitonic sort: pair e of a step is (lo, lo +
    stride), lo = 2·stride·(e // stride) + e % stride, ascending where lo
    & size is 0."""
    P = len(keys)
    size = 2
    while size <= P:
        stride = size >> 1
        while stride > 0:
            for e in range(P // 2):
                lo = 2 * stride * (e // stride) + e % stride
                hi = lo + stride
                if (keys[lo] > keys[hi]) == ((lo & size) == 0):
                    keys[lo], keys[hi] = keys[hi], keys[lo]
            stride >>= 1
        size <<= 1
    return keys


RANK_SORT_MAX = 256  # the kernel's kRankSortMax: a sort by rank up to it, bitonic above


def radix_digit(hist, need):
    """hist_digit: (the digit whose bins hold the need-th key, the key's
    rank among the digit's, the digit's count)."""
    below, digit = 0, 0
    while below + hist[digit] < need:
        below += hist[digit]
        digit += 1
    return digit, need - below, int(hist[digit])


def twin_select_wide(pos, S, OA, rng, use_range):
    """select_wide, a block an agent: each candidate's distance bits once;
    the OA-th smallest by radix passes of 8 bits over them (a histogram
    each, the digit whose bins hold the need-th key), stopped where the
    chosen bin holds exactly the keys still needed or where every
    candidate of the pass's prefix has one distance (its least and largest
    bits equal: then that distance); the keys below the threshold and the
    `need` lowest indices at it placed a tile of THREADS candidates at a
    time in index order by the tiles' ballot ranks, stopped once all are
    placed; then sorted by rank (up to RANK_SORT_MAX keys; where the
    threshold is one distance, only the keys below it) or by the bitonic
    sort of the sort_len(OA) keys."""
    SA = pos.shape[0]
    A = SA // S
    order = np.zeros((SA, OA), np.int64)
    valid = np.zeros((SA, OA), bool)
    for agent in range(SA):
        s, i = divmod(agent, A)
        p = pos[s * A:(s + 1) * A]
        d = np.abs(p[i] - p).max(axis=1)
        d[i] = d[i] + F(1e9)
        if use_range:
            d = np.where(d < rng, d, F(1e9)).astype(F)
        bits = [int(b) for b in d.view(np.uint32)]
        prefix, mask, need = 0, 0, OA
        for shift in (24, 16, 8, 0):
            inside = [b for b in bits if b & mask == prefix]
            if min(inside) == max(inside):
                prefix, mask = inside[0], 0xFFFFFFFF
                break
            digit, need, count = radix_digit(
                np.bincount([(b >> shift) & 255 for b in inside], minlength=256), need)
            prefix |= digit << shift
            mask |= 255 << shift
            if count == need:
                break
        keys = [FULL] * OA
        n_less = n_tie = 0
        for t0 in range(0, A, THREADS):
            tile = [bits[j] & mask if j < A else None for j in range(t0, t0 + THREADS)]
            less = [t is not None and t < prefix for t in tile]
            tie = [t == prefix for t in tile]
            # a thread's ballot rank plus the counts of the warps before it:
            # the tile's keys before it
            less_at = n_less + np.cumsum(less) - less
            tie_at = n_tie + np.cumsum(tie) - tie
            for t in range(THREADS):
                if less[t]:
                    keys[less_at[t]] = (bits[t0 + t] << 32) | (t0 + t)
                elif tie[t] and tie_at[t] < need:
                    keys[OA - need + tie_at[t]] = (bits[t0 + t] << 32) | (t0 + t)
            n_less += sum(less)
            n_tie += sum(tie)
            if n_less == OA - need and n_tie >= need:
                break
        assert FULL not in keys
        # a threshold of one distance: its ties in place, the keys below it sorted
        n_sort = OA - need if mask == 0xFFFFFFFF else OA
        if n_sort <= RANK_SORT_MAX:
            out = keys[:]
            for key in keys[:n_sort]:
                out[sum(k < key for k in keys[:n_sort])] = key
        else:
            out = bitonic(keys + [FULL] * (sort_len(OA) - OA))[:OA]
        order[agent] = [(x & 0xFFFFFFFF) + s * A for x in out]
        valid[agent] = [np.uint32(x >> 32).view(F) < F(1e8) for x in out]
    return order, valid


@pytest.mark.parametrize("A,S,OA,rng", [(34, 1, 33, 3.0), (120, 1, 33, -1.0), (81, 1, 80, 3.0),
                                         (300, 1, 80, 4.0), (129, 1, 128, -1.0),
                                         (200, 1, 128, 5.0), (90, 2, 40, 3.0),
                                         (300, 1, 257, -1.0), (600, 1, 300, 30.0)])
def test_wide_selection_twin_equals_plain(A, S, OA, rng):
    """On the tied lattice (its L∞ distances tie exactly: the lower index
    first), ties at the OA-th distance included; the rank sort and, at OA
    = 257 and 300 (past it unless the threshold is one distance), the
    bitonic sort."""
    pos = lattice(A, S)
    order, valid = stages._neighbor_slots_plain(pos, S, OA, rng)
    t_order, t_valid = twin_select_wide(pos.numpy(), S, OA, F(rng), rng > 0)
    np.testing.assert_array_equal(t_order, order.numpy())
    np.testing.assert_array_equal(t_valid, valid.numpy())


def test_bitonic_sorts_every_length():
    rs = np.random.default_rng(0)
    for P in (1, 2, 4, 64, 256):
        keys = [int(x) for x in rs.integers(0, 1 << 62, P)]
        assert bitonic(list(keys)) == sorted(keys)


# ---- the wide prediction, in Python -----------------------------------------
WIDE_LIMIT = 232448 - 1024  # the kernel's kWideLimit: kMaxSmem less the static arrays
UNROLL = 2  # the kernel's kUnroll: runs of four a thread in flight
FILL_BLOCKS, MAX_PARTS = 8, 16  # the kernel's kFillBlocks and kMaxParts
H100_SMS = 132


def front_parts(A, sms=H100_SMS):
    """front_parts: the wide prediction's blocks an agent."""
    return max(1, min(MAX_PARTS, FILL_BLOCKS * sms // A))


def part_range(n, part, parts):
    """part_range: [first, last) of part `part` of n floats, a multiple of
    4 apart."""
    chunk = (-(-n // parts) + 3) & ~3
    first = min(n, part * chunk)
    return first, min(n, first + chunk)


def r4(f):
    return (f + 3) & ~3


def select_wide_floats(A, OA):
    """select_wide_layout(A, OA).floats: the distance bits, the keys (the
    rank sort's output beside them, or the bitonic sort's padding), two
    histograms, the warps' counts of two tiles, the pass's digit, rank and
    count, and two (min, max) pairs."""
    out = r4(A) + 2 * (OA if OA <= RANK_SORT_MAX else sort_len(OA))
    return r4(r4(out + 2 * OA) + 2 * 256 + 4 * (THREADS // WARP) + 8)


def wide_smem(M, N, O, OA, A, select):
    """front_wide_smem(...).floats: the times, the sub-step matrix, the
    slot tables sized by O and the selection's shared memory."""
    tables = (r4(M * N) + r4(N * N) + r4(2 * OA) + r4(O + 1) + 2 * r4(3 * (O + 1)) + r4(3 * O)
              + 3 * r4(O) + 2 * r4((O + 3) // 4))
    return tables + (select_wide_floats(A, OA) if select and OA > 0 else 0)


def stream_runs(first, last, span, threads=THREADS, unroll=UNROLL):
    """stream_runs' runs (f, row, r) of [first, last), thread by thread and
    round by round, as the kernel takes them: f0 = first + 4·tid +
    4·threads·unroll·k, and its unroll runs f0 + 4·threads·u below
    `last`, (row, r) advanced by additions (held to f's quotient and
    remainder by span)."""
    step = 4 * threads
    step_rows, step_r = divmod(step, span)
    for tid in range(threads):
        row, r = divmod(first + 4 * tid, span)
        for f0 in range(first + 4 * tid, last, step * unroll):
            for u in range(unroll):
                f = f0 + step * u
                if f < last:
                    assert (row, r) == divmod(f, span)
                    yield f, row, r
                row, r = row + step_rows, r + step_r
                if r >= span:
                    row, r = row + 1, r - span


def twin_front_stream(cfg, sc, fleet, inp, order, valid, agents, threads=THREADS,
                      unroll=UNROLL, parts=1):
    """step_front_wide_kernel for `agents`, one at a time (the outputs of
    the others stay 0): one pass over the slots (slot O the agent's own)
    for each slot's kind, (position, velocity) and attributes, an agent
    slot's disturbance reset from its source row; then the outputs as a
    stream of runs of four (`stream_runs`, each element written once):
    the attributes from the tables, and a slot's prediction by `copied`
    (four floats of the source row: the shift or the last point held, or
    in the sub-step the segments past the first) or element by element,
    the predictions split over `parts` blocks (`part_range`)."""
    A, O, OA, M, N = inp.pos.shape[0], cfg.O, cfg.OA, cfg.M, cfg.n + 1
    N3, MN3 = 3 * N, M * 3 * N
    sub = np32(cfg.sub)
    tt = np.array([_cv_time(m, i, cfg.n, sc["dt"]) for m in range(M) for i in range(N)], F)
    prev, pos, vel = np32(inp.prev_ctrl), np32(inp.pos), np32(inp.vel)
    has_prev, disturbed = np32(inp.has_prev), np32(inp.is_disturbed)
    order, valid = np32(order), np32(valid)
    radius, downwash = np32(fleet.radius), np32(fleet.downwash)
    goal = np32(inp.current_goal)
    out = dict(obs_pred=np.zeros((A, O, M, N, 3), F), obs_valid=np.zeros((A, O), bool),
               obs_is_agent=np.zeros((A, O), bool), obs_radius=np.zeros((A, O), F),
               obs_downwash=np.zeros((A, O), F), obs_max_acc=np.zeros((A, O), F),
               obs_pos_now=np.zeros((A, O, 3), F), obs_goal=np.zeros((A, O, 3), F),
               initial_ctrl=np.zeros((A, M, N, 3), F))
    zero = np.zeros(3, F)
    for a in agents:
        kind, P, V = [KIND_CV] * (O + 1), [zero] * (O + 1), [zero] * (O + 1)
        tables = dict(obs_valid=np.zeros(O, bool), obs_is_agent=np.zeros(O, bool),
                      obs_radius=np.full(O, F(0.1)), obs_downwash=np.ones(O, F),
                      obs_max_acc=np.zeros(O, F), obs_pos_now=np.zeros((O, 3), F),
                      obs_goal=np.zeros((O, 3), F))
        rows = [(prev[order[a, o]] if o < OA else prev[a]).reshape(-1) for o in range(O + 1)]
        for o in range(O + 1):
            if o == O or o < OA:
                r = order[a, o] if o < O else a
                P[o] = pos[r]
                if (o == O and disturbed[a]) or cfg.mode == stages.MODE_BVC:
                    pass
                elif cfg.mode == stages.MODE_RSFC or not has_prev[r]:
                    V[o] = vel[r]
                else:
                    kind[o] = KIND_ROW
                if o < O:
                    for name, v in (("obs_valid", valid[a, o]), ("obs_is_agent", True),
                                    ("obs_radius", radius[r]), ("obs_downwash", downwash[r]),
                                    ("obs_pos_now", pos[r]), ("obs_goal", goal[r])):
                        tables[name][o] = v
                if kind[o] == KIND_ROW and o < OA:
                    e = [_row_value(rows[o], sub, N, MN3, d, 0, 0, d) - P[o][d] for d in range(3)]
                    if _norm(e) > sc["reset"]:
                        kind[o], V[o] = KIND_CV, zero
            else:
                kind[o] = KIND_PAD

        def pred(o, r):
            m = r // N3
            i = (r - m * N3) // 3
            d = r - m * N3 - 3 * i
            if kind[o] == KIND_ROW:
                return _row_value(rows[o], sub, N, MN3, r, m, i, d)
            if kind[o] == KIND_CV:
                return P[o][d] + F(V[o][d] * tt[m * N + i])
            return F(0)

        def copied(o, r):
            if kind[o] != KIND_ROW or (sub is not None and r < N3):
                return None
            if sub is not None or r + 4 <= MN3 - N3:
                at = r if sub is not None else r + N3
                return rows[o][at:at + 4]
            if r < MN3 - N3:  # straddles the last segment
                return None
            return [rows[o][MN3 - 3 + (r + q) % 3] for q in range(4)]  # its point held

        def stream(flat, span, value, run, runs=unroll, n_parts=1):
            written = np.zeros(flat.size, int)
            runs_of = (run for part in range(n_parts)
                       for run in stream_runs(*part_range(flat.size, part, n_parts), span,
                                              threads, runs))
            for f, row, r in runs_of:
                v = run(row, r) if f + 4 <= flat.size and r + 4 <= span else None
                if v is None:
                    v = [value(*divmod(g, span)) for g in range(f, min(f + 4, flat.size))]
                flat[f:f + len(v)] = v
                written[f:f + len(v)] += 1
            assert (written == 1).all()

        for name, t in tables.items():
            if t.dtype == bool:  # a byte a thread
                out[name][a] = t
            else:
                flat = t.reshape(-1)
                stream(out[name][a].reshape(-1), flat.size, lambda _, e: flat[e],
                       lambda *_: None, 1)
        stream(out["obs_pred"][a].reshape(-1), MN3, pred, copied, n_parts=parts)
        stream(out["initial_ctrl"][a].reshape(-1), MN3, lambda _, r: pred(O, r),
               lambda _, r: copied(O, r))
    return out


def wide_front_state(O, dim, substep=False, seed=0, device="cpu"):
    """(planner, fleet, inp) of a fleet of O + 6 agents whose neighbour set
    is every other agent within 20 m (O slots), with previous solutions:
    constant-velocity plans from jittered positions, some agents without
    one, some disturbed, some moved 0.7 m off their plans (the reset)."""
    A = O + 6
    over = dict(world_dimension=dim, max_obstacles=O, communication_range=20.0)
    if substep:
        over.update(planner_mode=PlannerMode.DLSC, multisim_time_step=0.1)
    p, planner, fleet, inp = workload.build_fleet(A, device=device, **over)
    rs = np.random.default_rng(seed)
    vel = torch.as_tensor(rs.uniform(-0.5, 0.5, (A, 3)), dtype=torch.float32, device=device)
    start = inp.pos + torch.as_tensor(rs.uniform(-0.05, 0.05, (A, 3)), dtype=torch.float32,
                                      device=device)
    prev = trajectory.const_vel_ctrl(start, vel, p.M, p.n, p.dt)
    has_prev = torch.as_tensor(rs.random(A) < 0.8, device=device)
    disturbed = torch.zeros(A, dtype=torch.bool, device=device)
    disturbed[::9] = True
    pos = inp.pos.clone()
    pos[3::7, 0] += 0.7
    inp = dataclasses.replace(inp, prev_ctrl=prev, has_prev=has_prev, is_disturbed=disturbed,
                              pos=pos, vel=vel)
    assert planner.O == O and planner.O_agents == O
    return planner, fleet, inp


@pytest.mark.parametrize("O,dim,substep,blocks", [
    (65, 2, False, ((THREADS, UNROLL, front_parts(71)), (THREADS, UNROLL, 1), (7, 3, 5))),
    (160, 3, False, ((THREADS, UNROLL, front_parts(166)), (THREADS, UNROLL, 1), (32, 1, 3))),
    (70, 2, True, ((THREADS, UNROLL, front_parts(76)), (THREADS, UNROLL, 1)))])
def test_wide_front_twin_equals_plain(O, dim, substep, blocks):
    """The wide prediction, its outputs a stream of runs of four taken by
    (threads, unroll, blocks an agent) of `blocks` (the first the kernel's
    at this fleet's O + 6 agents on the H100's 132 SMs, the second the
    kernel's on a fleet that fills the card; each element written once),
    equals the plain selection's slots predicted by the plain body; and
    the fused wide build (the radix selection, then the prediction)
    equals the plain fused entry."""
    planner, fleet, inp = wide_front_state(O, dim, substep)
    cfg = planner.stage_cfg
    sc = stages.stage_scalars(cfg)
    order, valid, want = stages.front_with_neighbors(cfg, fleet, inp)
    t_order, t_valid = twin_select_wide(np32(inp.pos), 1, cfg.OA, F(sc["range"]),
                                        cfg.comm_range > 0)
    np.testing.assert_array_equal(t_order, order.numpy())
    np.testing.assert_array_equal(t_valid, valid.numpy())
    # agents with and without a plan, disturbed, moved off their plans
    agents = [0, 3, 5, 9, 10, O // 2, O + 5]
    for threads, unroll, parts in blocks:
        got = twin_front_stream(cfg, sc, fleet, inp, order, valid, agents, threads, unroll,
                                parts)
        for field, v in got.items():
            assert_equal_by_value(v[agents], np32(getattr(want, field))[agents],
                                  f"O={O} {threads}x{unroll}x{parts} {field}")
    assert blocks[0] == (THREADS, UNROLL, front_parts(O + 6)) and front_parts(O + 6) > 1


def test_wide_tables_fit_eight_blocks_an_sm():
    """The wide prediction's shared memory: 8f's fused launch (1,024
    agents, O = OA = 80, M = 12, N = 6) takes its tables (~62 B a slot)
    and its selection (4 B a candidate) in 12,960 B, so 8 blocks an SM
    fit (1 KB reserved a block: ≤ 28,160 B each) and its 1,024 blocks run
    in one wave on 132 SMs; at 160 slots of 166 agents (M = 10) 15,728 B;
    the prediction alone at 80 slots 5,440 B; and 4,000 slots of 5,000
    agents pass the block's 227 KB (no build takes them)."""
    assert 4 * wide_smem(12, 6, 80, 80, 1024, True) == 12960
    assert 8 * (4 * wide_smem(12, 6, 80, 80, 1024, True) + 1024) <= 233472
    assert 4 * wide_smem(10, 6, 160, 160, 166, True) == 15728
    assert 4 * wide_smem(12, 6, 80, 80, 1024, False) == 5440
    assert 4 * wide_smem(10, 6, 4000, 4000, 5000, True) > WIDE_LIMIT


# ---- the wide builds on the card ---------------------------------------------
@pytest.fixture(scope="module")
def lattice_cfg():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage kernels have no CPU mode")
    _, planner, _, _ = workload.build_fleet(12, device="cpu")
    return planner.stage_cfg


@pytest.mark.cuda
@pytest.mark.parametrize("A", [256, 1024, 5000])
@pytest.mark.parametrize("OA", [32, 33, 80, 128, 255])
def test_wide_neighbor_kernel_on_lattice(lattice_cfg, A, OA):
    """OA at the narrow build's 32 and above it (the wide build), on the
    tied lattice with and without a range: equal to the plain body."""
    pos = lattice(A).to("cuda")
    assert (step_cuda.selection_build(A, OA) == 0) == (OA > 32)
    for rng in (3.0, -1.0):
        cfg = dataclasses.replace(lattice_cfg, OA=OA, comm_range=rng, cache={})
        before = dict(step_cuda.wide_launches)
        got = step_cuda.neighbor_slots_cuda(cfg, stages.stage_scalars(cfg), pos, 1)
        want = stages._neighbor_slots_plain(pos, 1, OA, rng)
        for x, y in zip(got, want):
            assert_equal_by_value(np32(x), np32(y), f"A={A} OA={OA} range {rng}")
        assert step_cuda.wide_launches["neighbor_slots"] - before["neighbor_slots"] == (OA > 32)


def _fronts_equal(got, want, what):
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        assert (x is None) == (y is None), (what, f.name)
        if x is not None:
            assert_equal_by_value(np32(x), np32(y), f"{what} {f.name}")


@pytest.mark.cuda
@pytest.mark.parametrize("O,dim,substep", [(64, 2, False), (65, 2, False), (80, 3, False),
                                           (70, 2, True), (160, 2, False), (256, 2, False)])
def test_wide_front_kernels_equal_plain_on_card(O, dim, substep):
    """O slots, every one an agent: the fused entry and the selection alone
    (wide builds: OA > 32), the prediction on its slots and on the
    gathered slots (the multi-device steps' entry; wide above 64 slots),
    each one launch, equal to their plain bodies; the kernel's shared
    memory a block is wide_smem's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage kernels have no CPU mode")
    planner, fleet, inp = wide_front_state(O, dim, substep, device="cuda")
    cfg = planner.stage_cfg
    before = dict(step_cuda.wide_launches)
    order, valid, got = stages.front_with_neighbors(cfg, fleet, inp)
    p_order, p_valid, want = stages.front_with_neighbors(cfg, fleet, inp, plain=True)
    assert_equal_by_value(np32(order), np32(p_order), "order")
    assert_equal_by_value(np32(valid), np32(p_valid), "valid")
    _fronts_equal(got, want, f"fused O={O}")
    n_order, n_valid = stages.neighbor_slots(inp.pos, 1, cfg)
    assert_equal_by_value(np32(n_order), np32(p_order), "neighbor_slots")
    _fronts_equal(stages.step_front(cfg, fleet, inp, order, valid),
                  stages.step_front(cfg, fleet, inp, order, valid, plain=True), "step_front")
    nd = stages.gather_neighbors(fleet, inp, order, valid)
    _fronts_equal(stages.step_front(cfg, fleet, inp, neighbors=nd),
                  stages.step_front(cfg, fleet, inp, neighbors=nd, plain=True), "gathered")
    torch.cuda.synchronize()
    # the prediction on given slots stays narrow up to 64 slots
    assert {k: v - before[k] for k, v in step_cuda.wide_launches.items()} == {
        "neighbor_slots": 1, "step_front": 2 * (O > 64), "front_with_neighbors": 1}
    lib = step_cuda.build()
    A = inp.pos.shape[0]
    if O > 64:
        for select in (0, 1):
            assert lib.step_front_smem_bytes(A, 1, O, cfg.OA, cfg.M, cfg.n, cfg.mode, select) \
                == 4 * wide_smem(cfg.M, cfg.n + 1, O, cfg.OA, A, select)


# ---- Bézier degree 8 on the card ---------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_degree_8_step_on_card(monkeypatch, dim):
    """One step of `build_fleet(64, n=8)` on the card after two evolving
    steps, each kernel of the step launched and each call held to its
    plain body: build_clsc (the hull kernels' run-time build, N = 9) and
    the 'hull' SFC update element for element, the stage entries
    (front_with_neighbors, goal_qp_inputs) element for element, the QP
    preparation by chip_smoke.py's prepare_check contract
    (qp_check.prepare_agreement), the ADMM loop's cluster build (dim·K 116
    in 2-D, 174 in 3-D) for one chunk against the plain chunk
    (test_torch_cuda.py's _chunk_held); every output finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from lsc_dr_planner_tpu_torch.ops import hull_cuda, lsc, qp_check, qp_cuda, sfc
    from test_torch_cuda import _chunk_held, _shape
    from test_torch_step_stages import Record, kernels_vs_plain

    p, planner, fleet, inp = workload.build_fleet(64, device="cuda", n=8, world_dimension=dim)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(2):
        inp, _ = step(inp)
    seen = {}

    def record(module, name):
        orig = getattr(module, name)

        def f(*a, **k):
            out = orig(*a, **k)
            seen.setdefault(name, []).append((a, k, out))
            return out

        monkeypatch.setattr(module, name, f)

    for module, name in ((lsc, "build_clsc"), (sfc, "update_sfc"), (tqp, "prepare"),
                         (tqp, "run_loop")):
        record(module, name)
    rt = hull_cuda.rt_launches["clsc_build"]
    with Record() as stage_calls:
        inp, conv = step(inp)
    torch.cuda.synchronize()
    monkeypatch.undo()
    for name in ("pos", "vel", "acc", "prev_ctrl", "current_goal", "qp_y0"):
        assert torch.isfinite(getattr(inp, name)).all(), name
    assert hull_cuda.rt_launches["clsc_build"] == rt + 1
    ((a, k, got),) = seen["build_clsc"]
    assert a[1].shape[-2] == 9 and not k.get("plain")
    want = lsc.build_clsc(*a, **k, plain=True)
    for name in ("normals", "anchors", "margins"):
        assert_equal_by_value(np32(getattr(got, name)), np32(getattr(want, name)), name)
    ((a, k, got),) = seen["update_sfc"]
    want = sfc.update_sfc(*a, **{**k, "plain": True})
    for x, y in zip(got, want):
        assert_equal_by_value(np32(x), np32(y), "update_sfc")
    n = kernels_vs_plain(stage_calls.calls)
    assert sorted(n) == ["front_with_neighbors", "goal_qp_inputs"], n
    ((a, k, pr),) = seen["prepare"]
    cfg, qp_inp = a[:2]
    rec = qp_check.prepare_agreement(cfg, qp_inp, pr, tqp.prepare(cfg, qp_inp, plain=True))
    assert all(v == 0 for v in rec["differing"].values()), rec
    assert all(v <= 1.0 for v in rec["share_of_tolerance"].values()), rec
    li = seen["run_loop"][0][0][1]
    shape = _shape(cfg, li)
    assert cfg.dim * shape[4] == {2: 116, 3: 174}[dim]
    assert qp_cuda.build_name(qp_cuda.build(), *shape, li.xi.shape[0]) == qp_cuda.CLUSTER_BUILD
    feas_tol = planner.feas_tol
    out = tqp.run_loop(cfg, li, 8, feas_tol)
    _chunk_held(cfg, li, out, tqp.admm_loop_plain(cfg, li, 8, feas_tol), feas_tol)
