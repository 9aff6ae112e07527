"""The SFC kernels' warp-per-lane expansion (csrc/sfc_expand.cu: a
chain of growths, shared by sfc_expand and sfc_update_hull) and the
fused 'hull'-mode update (ops/sfc_cuda.py::update_sfc_hull_cuda) with
its dispatch in ops/sfc.py::update_sfc.

On the CPU: a Python twin of the warp's expansion (the 32 threads'
states, the ballot, the round's resolution, the broadcast) is held to
the plain loop `expand_box_plain`, lane for lane, on the shared image
and on per-agent images, with r = 0 and r > 0; a scalar twin of the
fused update's block (the float32 seeds, three lanes, the containment
tests, the selection, the world boxes) is held to the plain body
(`update_sfc` on CPU tensors) bit for bit and to the JAX package's
update_sfc_fused; the entries raise on CPU tensors. The `cuda` tests
hold the kernels to the plain versions on the card; they import neither
jax nor the JAX package, so on the GPU machine they run with `python -m
pytest --noconftest -m cuda tests/test_torch_sfc_update_kernel.py`
(tests/conftest.py imports jax).
"""

import math

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu_torch.ops import sfc, sfc_cuda
from lsc_dr_planner_tpu_torch.world import grid as tgrid
from test_torch_sfc_kernel import CASE_IDS, CASES, RADIUS, RES, WMAX, WMIN, _case, _max_trips
from test_torch_sfc_kernel import _world

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

F = np.float32
DEFAULT_ORDER = (0, 1, 2, 3, 4, 5)


# ---- the warp's expansion, in Python ------------------------------------------
def _count(S, b):
    """box_count: unsigned 32-bit, with box_blocked_count's clamps."""
    x0, y0, z0 = (min(max(v, 0), e - 2) for v, e in zip(b[:3], S.shape))
    x1, y1, z1 = (min(max(v + 1, 0), e - 1) for v, e in zip(b[3:], S.shape))
    s = (int(S[x1, y1, z1]) - int(S[x0, y1, z1]) - int(S[x1, y0, z1]) - int(S[x1, y1, z0])
         + int(S[x0, y0, z1]) + int(S[x0, y1, z0]) + int(S[x1, y0, z0]) - int(S[x0, y0, z0]))
    return s & 0xFFFFFFFF


def _next_slot(active, ptr):
    rot = ((active >> ptr) | (active << (6 - ptr))) & 0x3F
    s = ptr + ((rot & -rot).bit_length() - 1)
    return s - 6 if s >= 6 else s


def _live(st, max_trips):
    return st[1] != 0 and st[3] < max_trips


def _step(st, order, grow):
    b, active, ptr, trips = st
    slot = _next_slot(active, ptr)
    if grow:
        d = order[slot]
        b = list(b)
        b[d] += -1 if d < 3 else 1
        ptr = 0 if slot == 5 else slot + 1
    else:
        active &= ~(1 << slot)
        ptr = slot
    return (tuple(b), active, ptr, trips + 1)


def _query(S, lim, order, t):
    """A node's query: one more cell along its next slot's direction."""
    d = order[_next_slot(t[1], t[2])]
    cur = t[0][d]
    if (cur > lim[d]) if d < 3 else (cur < lim[d]):
        nb = list(t[0])
        nb[d] += -1 if d < 3 else 1
        return _count(S, nb) == 0
    return False


def _chain_round(S, lim, order, st, max_trips):
    """One round of expand_lane_chain: every thread's node (the state after
    j growths, from the rank of each active slot, not by replaying), the
    ballot, the first trip that fails or ends the lane."""
    b, active, ptr, trips = st
    n = bin(active).count("1")
    ranked = [s_ for p in range(6) for s_ in [(ptr + p) % 6] if (active >> s_) & 1]
    ok_m, sel = 0, []
    for j in range(32):
        q, rem = divmod(j, n)
        nb = list(b)
        for rank, slot in enumerate(ranked):
            d = order[slot]
            c = q + (rank < rem)
            nb[d] += -c if d < 3 else c
        t_ptr = ptr if j == 0 else (ranked[(j - 1) % n] + 1) % 6
        t = (tuple(nb), active, t_ptr, trips + j)
        on = _live(t, max_trips)
        ok = on and _query(S, lim, order, t)
        ok_m |= ok << j
        sel.append(_step(t, order, ok) if on else t)
    src = 31 if ok_m == (1 << 32) - 1 else (~ok_m & -~ok_m).bit_length() - 1
    return sel[src]


def twin_warp_lane(S, dims, lo, hi, order, r, max_trips):
    """The warp's expansion of one lane (seed_lane, then
    expand_lane_chain): S its integral image [SX, SY, SZ] (numpy).
    Returns (lo, hi, seed_free, trips, rounds)."""
    lo, hi, order = [int(v) for v in lo], [int(v) for v in hi], [int(v) for v in order]
    lim = ([max(0, v - r) if r > 0 else 0 for v in lo]
           + [min(d, v + r) if r > 0 else d for v, d in zip(hi, dims)])
    b = tuple(lo + hi)
    seed_ok = (_count(S, b) == 0 and all(v >= 0 for v in lo)
               and all(v <= d for v, d in zip(hi, dims)))
    st = (b, 0x3F if seed_ok else 0, 0, 0)
    rounds = 0
    while _live(st, max_trips):
        rounds += 1
        st = _chain_round(S, lim, order, st, max_trips)
    return list(st[0][:3]), list(st[0][3:]), seed_ok, st[3], rounds


def _twin_lanes(view, lo, hi, order, agent, r):
    S = view.blocked_cumsum.cpu().numpy()
    out = [twin_warp_lane(S if agent is None else S[agent[i]], view.dims, lo[i], hi[i],
                          order[i], r, _max_trips(r)) for i in range(len(lo))]
    return [np.asarray(v) for v in zip(*out)]


@pytest.mark.parametrize("seed,per_agent,r", CASES, ids=CASE_IDS)
def test_chain_twin_equals_plain_loop(seed, per_agent, r):
    """The chain of growths, lane by lane, equals the masked
    plain loop, and each round resolves a run of growths and the trip
    after it: a lane takes at most its 6 retirements plus one round per
    32 growths."""
    view, lo, hi, order, agent, _, _ = _case(seed, per_agent)
    t_lo, t_hi, t_ok, t_trips, t_rounds = _twin_lanes(view, lo, hi, order, agent, r)
    p_lo, p_hi, p_ok = sfc.expand_box(
        view, torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(order),
        max_radius_cells=r, agent=None if agent is None else torch.as_tensor(agent))
    for g, w in zip((t_lo, t_hi, t_ok), (p_lo, p_hi, p_ok)):
        np.testing.assert_array_equal(w.numpy(), g)
    live = sfc.lane_trips(*sfc.last_lanes).clamp(max=_max_trips(r)).numpy()
    np.testing.assert_array_equal(live, t_trips)
    grown = t_trips - 6
    assert (t_rounds[t_ok] <= 6 + 1 + grown[t_ok] // 32).all()


def test_twin_trip_cap():
    """A lane cut by max_trips stops at the cap inside a round."""
    view, lo, hi, order, agent, _, _ = _case(1, False)
    S = view.blocked_cumsum.numpy()
    full = [twin_warp_lane(S, view.dims, lo[i], hi[i], order[i], 0, 4096)
            for i in range(48)]
    i = int(np.argmax([f[3] for f in full]))
    cap = full[i][3] - 3
    got = twin_warp_lane(S, view.dims, lo[i], hi[i], order[i], 0, cap)
    want = sfc.expand_box_plain(view, torch.as_tensor(lo[i:i + 1]), torch.as_tensor(hi[i:i + 1]),
                                torch.as_tensor(order[i:i + 1]), 0, None, cap)
    assert got[3] == cap
    assert got[0] == want[0][0].tolist() and got[1] == want[1][0].tolist()


# ---- the fused 'hull' update, in Python ----------------------------------------
def _face_delta(margin):
    return F(margin - math.floor(margin / RES + 1e-9) * RES)


def twin_update_hull(view, sfc_lo, sfc_hi, init_done, last_pt, cgoal, wpt, pos, init_ctrl,
                     margin, r):
    """The fused kernel's block for every agent ('hull' mode reads no
    init_ctrl): (lo, hi, lo_w, hi_w) [A, M, 3] and the lanes' trips [A,
    3]."""
    S = view.blocked_cumsum.numpy()
    dims, org = view.dims, [int(v) for v in view.origin_idx]
    res = F(RES)
    d_sup, d_world = _face_delta(view.radius), _face_delta(margin)
    A, M = sfc_lo.shape[:2]

    def l2p(v, c):
        return (F(v) + F(org[c])) * res

    def world(lo, hi, delta):
        return ([l2p(v, c) - delta if v > 0 else l2p(v, c) for c, v in enumerate(lo)],
                [l2p(v, c) + delta if v < dims[c] else l2p(v, c) for c, v in enumerate(hi)])

    def superset(lo, hi, pts):
        lw, hw = world(lo, hi, d_sup)
        return all(lw[c] - F(1e-6) <= p[c] <= hw[c] + F(1e-6) for p in pts for c in range(3))

    out = np.zeros((4, A, M, 3), np.float64)
    trips = np.zeros((A, 3), np.int64)
    for a in range(A):
        pts = [tuple(F(v) for v in p[a]) for p in (pos, last_pt, cgoal, wpt)]
        seeds = []
        for w, group in enumerate(([pts[0]], pts[1:], pts[1:3])):
            q_lo = [min(p[c] for p in group) / res for c in range(3)]
            q_hi = [max(p[c] for p in group) / res for c in range(3)]
            if w == 1:
                lo = [int(np.rint(q)) - o for q, o in zip(q_lo, org)]
                hi = [int(np.rint(q)) - o for q, o in zip(q_hi, org)]
            else:
                lo = [int(np.floor(q + F(1e-6))) - o for q, o in zip(q_lo, org)]
                hi = [int(np.ceil(q - F(1e-6))) - o for q, o in zip(q_hi, org)]
            if w == 2:
                plo, phi = list(sfc_lo[a, -1]), list(sfc_hi[a, -1])
                if not (all(x >= y for x, y in zip(lo, plo))
                        and all(x <= y for x, y in zip(hi, phi))):
                    lo = [max(x, y) for x, y in zip(lo, plo)]
                    hi = [min(x, y) for x, y in zip(hi, phi)]
            Sa = S[a] if S.ndim == 4 else S
            e_lo, e_hi, ok, n, _ = twin_warp_lane(Sa, dims, lo, hi, DEFAULT_ORDER, r,
                                                  _max_trips(r))
            seeds.append((e_lo, e_hi, ok))
            trips[a, w] = n
        if not init_done[a]:
            boxes = [seeds[0][:2]] * M
        else:
            if seeds[1][2] and superset(*seeds[1][:2], pts[1:]):
                new = seeds[1][:2]
            elif seeds[2][2] and superset(*seeds[2][:2], pts[1:3]):
                new = seeds[2][:2]
            else:
                new = (list(sfc_lo[a, -1]), list(sfc_hi[a, -1]))
            boxes = [(list(sfc_lo[a, m + 1]), list(sfc_hi[a, m + 1])) for m in range(M - 1)]
            boxes.append(new)
        for m, (lo, hi) in enumerate(boxes):
            out[0, a, m], out[1, a, m] = lo, hi
            out[2, a, m], out[3, a, m] = world(lo, hi, d_world)
    return (out[0].astype(np.int32), out[1].astype(np.int32), out[2].astype(F),
            out[3].astype(F), trips)


def update_cases(seed, per_agent, A=24, M=10, dim=2):
    """(view, numpy arguments of update_sfc after the world, occupancy):
    agents scattered over the test world, their goals and waypoints
    around them, previous boxes near them, some not yet initialised; in
    per-agent mode each knows a random half of the boxes."""
    rng, boxes, gt, occ = _world(seed, A if per_agent else 0)
    view = gt
    if per_agent:
        view = tgrid.local_grid_world(gt, tgrid.blocked_cumsum(torch.as_tensor(occ), RES,
                                                               RADIUS)[1])
    z = rng.uniform(0.3, 1.2, A) if dim == 3 else np.full(A, 0.6)
    pos = np.column_stack([rng.uniform(-1.7, 1.7, (A, 2)), z]).astype(F)

    def near(s):
        d = rng.uniform(-s, s, (A, 3)) * ([1, 1, 1] if dim == 3 else [1, 1, 0])
        return (pos + d).astype(F)

    last_pt, cgoal, wpt = near(0.3), near(0.8), near(0.5)
    pos[0] = np.round(pos[0] / RES) * RES  # on a lattice point: floor and ceil meet
    cgoal[1] = (np.round(cgoal[1] / RES - 0.5) + 0.5) * RES  # a rounding tie
    g = gt.point_to_lattice_floor(torch.as_tensor(pos)).numpy()
    drift = rng.integers(-3, 4, (A, 1, 3)) * np.arange(M)[None, :, None] // M
    slo = (g[:, None] - 3 + drift).astype(np.int32)
    shi = (g[:, None] + 3 + drift).astype(np.int32)
    init = rng.random(A) < 0.75
    init_ctrl = np.zeros((A, M, 6, 3), F)
    return view, (slo, shi, init, last_pt, cgoal, wpt, pos, init_ctrl)


UPDATE_CASES = [(0, False, 20, 2), (1, False, 0, 3), (2, True, 20, 2), (3, True, 0, 3)]
UPDATE_IDS = ["shared-r20-2d", "shared-r0-3d", "per_agent-r20-2d", "per_agent-r0-3d"]


@pytest.mark.parametrize("seed,per_agent,r,dim", UPDATE_CASES, ids=UPDATE_IDS)
def test_update_twin_equals_plain(seed, per_agent, r, dim):
    """The fused block's twin equals the plain body on the CPU (lattice
    and world boxes) bit for bit, its longest lane is what
    read_lane_trips() adds, and both lanes 1 and 2 and the previous box
    are chosen somewhere."""
    view, args = update_cases(seed, per_agent, dim=dim)
    t = twin_update_hull(view, *args, 0.15, r)
    sfc.reset_counts()
    got = sfc.update_sfc(view, "hull", *map(torch.as_tensor, args), 0.15, max_radius_cells=r)
    for g, w in zip(got, t[:4]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert sfc.read_lane_trips() == t[4].max()
    assert sfc.plain_cuda_calls == 0
    lanes = sfc.last_lanes
    e_lo = lanes[2].view(-1, 3, 3).numpy()
    last = got[0][:, -1].numpy()
    done = args[2]
    picked = [(last[done] == e_lo[done, k]).all(-1) for k in (1, 2)]
    assert picked[0].any() and (~picked[0]).any()


@pytest.mark.parametrize("per_agent", [False, True], ids=["shared", "per_agent"])
def test_update_plain_matches_jax(per_agent):
    """The plain body (the twin's reference) against the JAX package's
    update_sfc_fused, agent by agent, lattice boxes exactly."""
    import jax
    import jax.numpy as jnp

    from lsc_dr_planner_tpu.ops import sfc as jsfc
    from lsc_dr_planner_tpu.world import grid as jgrid

    seed = 4
    view, args = update_cases(seed, per_agent)
    _, boxes, _, occ = _world(seed, len(args[0]) if per_agent else 0)
    got = sfc.update_sfc(view, "hull", *map(torch.as_tensor, args), 0.15, max_radius_cells=20)
    gj = jgrid.build_grid_world(boxes, WMIN, WMAX, RES, RADIUS)

    def one(a, occ_a):
        w = gj
        if per_agent:
            w = jgrid.local_grid_world(gj, occ_a, *jgrid.blocked_cumsum_jnp(occ_a, RES, RADIUS))
        return jsfc.update_sfc_fused(w, "hull", *a, 0.15, max_radius_cells=20)

    occ_j = jnp.asarray(occ if per_agent else np.zeros((len(args[0]), 1), bool))
    j_lo, j_hi = jax.jit(jax.vmap(one))(tuple(map(jnp.asarray, args)), occ_j)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(j_lo))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(j_hi))


def test_update_sfc_world_boxes_are_sfc_to_world():
    """update_sfc's world boxes are sfc_to_world's of its lattice boxes
    (the CPU path)."""
    view, args = update_cases(5, False)
    t = list(map(torch.as_tensor, args))
    lo, hi, lo_w, hi_w = sfc.update_sfc(view, "hull", *t, 0.2, max_radius_cells=20)
    w = sfc.sfc_to_world(view, lo, hi, 0.2)
    assert torch.equal(lo_w, w[0]) and torch.equal(hi_w, w[1])


def test_entries_raise_without_cuda_tensors():
    """No silent fallback: the fused entry and the expansion entry refuse
    CPU tensors before they build anything, and update_sfc refuses a
    device it has no path for."""
    view, args = update_cases(6, False, A=3)
    t = list(map(torch.as_tensor, args))
    launches = (sfc_cuda.launches, sfc_cuda.hull_launches)
    scratch = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sfc_cuda.update_sfc_hull_cuda(view.blocked_cumsum, view.dims, [0, 0, 0], RES, t[0],
                                      t[1], t[2], *t[3:7], 0.05, 0.05, 20, 126,
                                      torch.zeros(1, dtype=torch.int64), scratch)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sfc_cuda.expand_box_cuda(view.blocked_cumsum, view.dims, t[0][:, 0].contiguous(),
                                 t[1][:, 0].contiguous(),
                                 sfc.default_axis_order(3, "cpu").contiguous(), 20, 126, None)
    assert (sfc_cuda.launches, sfc_cuda.hull_launches) == launches
    with pytest.raises(ValueError, match="no SFC update for device meta"):
        sfc.update_sfc(view, "hull", *(x.to("meta") for x in t), 0.15, max_radius_cells=20)


# ---- on the card ------------------------------------------------------------
@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _on_card(view, dev):
    return tgrid.local_grid_world(view, view.blocked_cumsum.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,per_agent,r,dim", UPDATE_CASES, ids=UPDATE_IDS)
def test_update_kernel_equals_plain_on_card(cuda_dev, seed, per_agent, r, dim):
    """The fused update on the card: one launch, no plain body, no host
    sync; its boxes, world boxes and lanes equal the plain body's on the
    card and the CPU's, and its trip count the twin's longest lane."""
    view, args = update_cases(seed, per_agent, dim=dim)
    gv = _on_card(view, cuda_dev)
    t = [torch.as_tensor(a).to(cuda_dev) for a in args]
    sfc.reset_counts()
    launches = (sfc_cuda.launches, sfc_cuda.hull_launches)
    got = sfc.update_sfc(gv, "hull", *t, 0.15, max_radius_cells=r)
    lanes = sfc.last_lanes
    torch.cuda.synchronize()
    assert (sfc_cuda.launches, sfc_cuda.hull_launches) == (launches[0], launches[1] + 1)
    assert sfc.trips == sfc.syncs == sfc.plain_cuda_calls == 0
    twin = twin_update_hull(view, *args, 0.15, r)
    assert sfc.read_lane_trips() == twin[4].max()
    want = sfc.update_sfc(gv, "hull", *t, 0.15, max_radius_cells=r, plain=True)
    assert sfc.plain_cuda_calls == 1
    for g, w, c in zip(got, want, twin[:4]):
        assert torch.equal(g, w)
        np.testing.assert_array_equal(g.cpu().numpy(), c)
    for g, w in zip(lanes, sfc.last_lanes):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_update_kernel_empty_and_nan(cuda_dev):
    """No agent: empty outputs, no launch. NaN points: the kernel equals
    the plain body on the card (NaN seeds convert to int32 alike)."""
    view, args = update_cases(7, True, A=6, dim=3)
    gv = _on_card(view, cuda_dev)
    t = [torch.as_tensor(a).to(cuda_dev) for a in args]
    launches = sfc_cuda.hull_launches
    empty = sfc.update_sfc(_on_card(update_cases(7, False)[0], cuda_dev), "hull",
                           *(x[:0] for x in t), 0.15, max_radius_cells=20)
    assert sfc_cuda.hull_launches == launches and empty[0].shape == (0, 10, 3)
    t[4][2, 0] = float("nan")  # a current goal
    t[6][3, 1] = float("nan")  # a position
    got = sfc.update_sfc(gv, "hull", *t, 0.15, max_radius_cells=20)
    want = sfc.update_sfc(gv, "hull", *t, 0.15, max_radius_cells=20, plain=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w) or torch.equal(g.nan_to_num(), w.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("seed,per_agent,r", CASES, ids=CASE_IDS)
def test_expand_kernel_equals_plain(cuda_dev, seed, per_agent, r):
    """The standalone expansion equals the plain loop on the card."""
    view, lo, hi, order, agent, _, _ = _case(seed, per_agent)
    gv = _on_card(view, cuda_dev)
    args = [torch.as_tensor(x).to(cuda_dev) for x in (lo, hi, order)]
    ag = None if agent is None else torch.as_tensor(agent).to(cuda_dev)
    got = sfc_cuda.expand_box_cuda(gv.blocked_cumsum, gv.dims, *args, r, _max_trips(r), ag)
    want = sfc.expand_box(gv, *args, max_radius_cells=r, agent=ag, plain=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_query_chase_runs(cuda_dev):
    """The measurement chases return a positive latency."""
    view, *_ = _case(0, False)
    assert sfc_cuda.l2_round_trip_ns(cuda_dev, n=1 << 16, hops=2000) > 0
    assert sfc_cuda.query_round_trip_ns(view.blocked_cumsum.to(cuda_dev), hops=2000) > 0
