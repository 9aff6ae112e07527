"""The SFC box expansion kernel (csrc/sfc_expand.cu, ops/sfc_cuda.py) and
its dispatch in ops/sfc.py::expand_box.

On the CPU: CPU tensors take the plain masked loop, the kernel's entry
raises on them, and a scalar Python twin of the kernel's per-thread
algorithm (one lane at a time, to the lane's own end, no masking) is
held to the plain loop and to the JAX package's expand_box, exactly, on
numpy-seeded lanes. The `cuda` tests hold the kernel to the plain loop
on the card, exactly; they import neither jax nor the JAX package, so on
the GPU machine they run with `python -m pytest --noconftest -m cuda
tests/test_torch_sfc_kernel.py` (tests/conftest.py imports jax).
"""

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu_torch.ops import sfc, sfc_cuda
from lsc_dr_planner_tpu_torch.world import grid as tgrid

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

RES, RADIUS = 0.1, 0.15
WMIN, WMAX = [-2.0, -2.0, 0.0], [2.0, 2.0, 1.5]  # 40 x 40 x 15 cells


def _boxes(rng, n=10):
    """Columns and floating blocks at random heights: a 3-D world."""
    return np.asarray([[*rng.uniform(-1.8, 1.8, 2), rng.uniform(0.2, 1.3),
                        *rng.uniform(0.2, 0.5, 2), rng.uniform(0.2, 1.0)] for _ in range(n)])


def _world(seed, n_agents=0):
    """(rng, boxes, shared world, per-agent occupancy [n_agents, X, Y, Z]
    or None): each agent knows a random half of the boxes."""
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng)
    gt = tgrid.build_grid_world(boxes, WMIN, WMAX, RES, RADIUS, "cpu")
    occ = None
    if n_agents:
        occ = np.stack([tgrid.rasterize_boxes(boxes[rng.random(len(boxes)) < 0.5], WMIN, WMAX,
                                              RES)[0] for _ in range(n_agents)])
    return rng, boxes, gt, occ


def _lanes(rng, dims, n=48):
    """Seeds [n, 3] int32 and orders [n, 6] int64: mostly one-cell boxes
    anywhere in the world, some of them blocked; lanes 0-5 touch the
    world's low faces (lo = 0), 6-11 its high faces (hi = dims), 12-15
    lie partly outside it (lo = -1 or hi = dims + 1: the gather clamps)."""
    dims = np.asarray(dims)
    lo = rng.integers(0, dims, (n, 3))
    hi = np.minimum(lo + rng.integers(0, 2, (n, 3)), dims)
    for i in range(6):
        lo[i, i % 3] = 0
        hi[6 + i, i % 3] = dims[i % 3]
        lo[6 + i, i % 3] = dims[i % 3] - 1
    lo[12:14, 0] = -1
    hi[14:16, 1] = dims[1] + 1
    order = np.stack([rng.permutation(6) for _ in range(n)])
    return lo.astype(np.int32), hi.astype(np.int32), order.astype(np.int64)


def twin_lane(S, dims, lo, hi, order, r, max_trips):
    """The kernel's per-thread algorithm (csrc/sfc_expand.cu) for one
    lane, in Python: S its integral image [SX, SY, SZ] (numpy). Returns
    (lo, hi, seed_free, trips)."""
    shape = S.shape

    def count(lo, hi):  # unsigned 32-bit, with box_blocked_count's clamps
        x0, y0, z0 = (min(max(v, 0), e - 2) for v, e in zip(lo, shape))
        x1, y1, z1 = (min(max(v + 1, 0), e - 1) for v, e in zip(hi, shape))
        s = (int(S[x1, y1, z1]) - int(S[x0, y1, z1]) - int(S[x1, y0, z1]) - int(S[x1, y1, z0])
             + int(S[x0, y0, z1]) + int(S[x0, y1, z0]) + int(S[x1, y0, z0]) - int(S[x0, y0, z0]))
        return s & 0xFFFFFFFF

    lo, hi = [int(v) for v in lo], [int(v) for v in hi]
    seed_ok = (count(lo, hi) == 0 and all(v >= 0 for v in lo)
               and all(v <= d for v, d in zip(hi, dims)))
    big = 1 << 30
    lmin = [v - r for v in lo] if r > 0 else [-big] * 3
    hmax = [v + r for v in hi] if r > 0 else [big] * 3
    packed = 0
    for k, d in enumerate(order):
        packed |= int(d) << (3 * k)
    active, ptr, trips = (0x3F if seed_ok else 0), 0, 0
    while active and trips < max_trips:
        trips += 1
        slot = ptr
        while not (active >> slot) & 1:
            slot = 0 if slot == 5 else slot + 1
        d = (packed >> (3 * slot)) & 7
        nlo, nhi = lo[:], hi[:]
        if d < 3:
            nlo[d] -= 1
        else:
            nhi[d - 3] += 1
        ok = (all(v >= 0 for v in nlo) and all(v <= e for v, e in zip(nhi, dims))
              and all(v >= m for v, m in zip(nlo, lmin))
              and all(v <= m for v, m in zip(nhi, hmax)) and count(nlo, nhi) == 0)
        if ok:
            lo, hi = nlo, nhi
            ptr = 0 if slot == 5 else slot + 1
        else:
            active &= ~(1 << slot)
            ptr = slot
    return lo, hi, seed_ok, trips


def _max_trips(r):
    return min(4096, 6 * r + 6) if r > 0 else 4096


def _case(seed, per_agent, n=48):
    """A world and its lanes: (view, lo, hi, order, agent, occ, boxes)."""
    n_agents = 4 if per_agent else 0
    rng, boxes, gt, occ = _world(seed, n_agents)
    lo, hi, order = _lanes(rng, gt.dims, n)
    agent = None
    view = gt
    if per_agent:
        agent = rng.integers(0, n_agents, n)
        view = tgrid.local_grid_world(
            gt, tgrid.blocked_cumsum(torch.as_tensor(occ), RES, RADIUS)[1])
    return view, lo, hi, order, agent, occ, boxes


def _twin_all(view, lo, hi, order, agent, r):
    S = view.blocked_cumsum.cpu().numpy()
    out = [twin_lane(S if agent is None else S[agent[i]], view.dims, lo[i], hi[i], order[i], r,
                     _max_trips(r)) for i in range(len(lo))]
    t_lo, t_hi, t_ok, t_trips = (np.asarray(v) for v in zip(*out))
    return t_lo, t_hi, t_ok, t_trips


def _jax_expand(boxes, lo, hi, order, r, occ=None, agent=None):
    """The JAX package's expand_box per lane (vmapped, per agent's view)."""
    import jax
    import jax.numpy as jnp

    from lsc_dr_planner_tpu.ops import sfc as jsfc
    from lsc_dr_planner_tpu.world import grid as jgrid

    gj = jgrid.build_grid_world(boxes, WMIN, WMAX, RES, RADIUS)
    out_lo, out_hi, out_ok = np.empty_like(lo), np.empty_like(hi), np.empty(len(lo), bool)
    groups = [(gj, np.arange(len(lo)))]
    if occ is not None:
        groups = []
        for a in np.unique(agent):
            o = jnp.asarray(occ[a])
            groups.append((jgrid.local_grid_world(gj, o, *jgrid.blocked_cumsum_jnp(o, RES, RADIUS)),
                           np.nonzero(agent == a)[0]))
    for world, idx in groups:
        fn = jax.jit(jax.vmap(lambda l, h, o, w=world: jsfc.expand_box(
            w, l, h, o, max_radius_cells=r)))
        jl, jh, jo = fn(jnp.asarray(lo[idx]), jnp.asarray(hi[idx]),
                        jnp.asarray(order[idx].astype(np.int32)))
        out_lo[idx], out_hi[idx], out_ok[idx] = np.asarray(jl), np.asarray(jh), np.asarray(jo)
    return out_lo, out_hi, out_ok


CASES = [(0, False, 5), (1, False, 0), (2, True, 5), (3, True, 0)]
CASE_IDS = ["shared-r5", "shared-r0", "per_agent-r5", "per_agent-r0"]


@pytest.mark.parametrize("seed,per_agent,r", CASES, ids=CASE_IDS)
def test_twin_matches_plain_loop_and_jax(seed, per_agent, r):
    """The kernel's algorithm, lane by lane, against the masked plain
    loop (all lanes at once) and the JAX while_loop: identical boxes and
    seed-free flags; its trips are each lane's live trips."""
    view, lo, hi, order, agent, occ, boxes = _case(seed, per_agent)
    t_lo, t_hi, t_ok, t_trips = _twin_all(view, lo, hi, order, agent, r)
    # the lanes cover what the kernel must get right
    assert t_ok.any() and not t_ok.all() and (t_trips > 12).any()
    assert (lo < 0).any() and (hi > np.asarray(view.dims)).any()

    p_lo, p_hi, p_ok = sfc.expand_box(
        view, torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(order),
        max_radius_cells=r, agent=None if agent is None else torch.as_tensor(agent))
    np.testing.assert_array_equal(p_lo.numpy(), t_lo)
    np.testing.assert_array_equal(p_hi.numpy(), t_hi)
    np.testing.assert_array_equal(p_ok.numpy(), t_ok)
    live = sfc.lane_trips(*sfc.last_lanes).clamp(max=_max_trips(r)).numpy()
    np.testing.assert_array_equal(live, t_trips)

    j_lo, j_hi, j_ok = _jax_expand(boxes, lo, hi, order, r, occ, agent)
    np.testing.assert_array_equal(j_lo, t_lo)
    np.testing.assert_array_equal(j_hi, t_hi)
    np.testing.assert_array_equal(j_ok, t_ok)


def test_cpu_tensors_take_the_plain_loop():
    """CPU tensors run the masked loop (its trips and host reads count,
    no kernel launch), and plain=True gives the same result."""
    view, lo, hi, order, _, _, _ = _case(4, False)
    args = (view, torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(order))
    sfc.reset_counts()
    launches = sfc_cuda.launches
    got = sfc.expand_box(*args, max_radius_cells=5)
    assert sfc.trips > 0 and sfc.syncs > 0 and sfc_cuda.launches == launches
    again = sfc.expand_box(*args, max_radius_cells=5, plain=True)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_kernel_entry_raises_without_cuda_tensors():
    """No silent fallback: the kernel's entry refuses CPU tensors before
    it builds anything, and expand_box refuses a device it has no path
    for."""
    view, lo, hi, order, _, _, _ = _case(5, False)
    launches = sfc_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        sfc_cuda.expand_box_cuda(view.blocked_cumsum, view.dims, torch.as_tensor(lo),
                                 torch.as_tensor(hi), torch.as_tensor(order), 5, 36, None)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sfc.expand_box_kernel(view, torch.as_tensor(lo), torch.as_tensor(hi),
                              torch.as_tensor(order), 5)
    assert sfc_cuda.launches == launches
    meta = [torch.as_tensor(t).to("meta") for t in (lo, hi, order)]
    with pytest.raises(ValueError, match="no SFC expansion for device meta"):
        sfc.expand_box(view, *meta, max_radius_cells=5)


def test_lane_trip_reader_on_cpu():
    """read_lane_trips() sums each call's longest lane: the twin's
    longest, and sfc_bench's lane_trips(*last_lanes).max()."""
    from lsc_dr_planner_tpu_torch.tools import sfc_bench

    sfc.reset_counts()
    assert sfc.read_lane_trips() == 0
    want = []
    for seed, per_agent, r in CASES[:3]:
        view, lo, hi, order, agent, _, _ = _case(seed, per_agent)
        sfc.expand_box(view, torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(order),
                       max_radius_cells=r, agent=None if agent is None else torch.as_tensor(agent))
        longest = int(sfc_bench.lane_trips(*sfc.last_lanes).max())
        assert longest == _twin_all(view, lo, hi, order, agent, r)[3].max()
        want.append(longest)
        assert sfc.read_lane_trips() == sum(want)
    sfc.reset_counts()
    assert sfc.read_lane_trips() == 0


# ---- on the card -----------------------------------------------------------
@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _on(t, dev):
    return None if t is None else torch.as_tensor(t).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,per_agent,r", CASES, ids=CASE_IDS)
def test_kernel_equals_plain_loop_on_card(cuda_dev, seed, per_agent, r):
    """Lanes with blocked seeds, edge seeds, r = 0 and per-agent images:
    the kernel's boxes, seed-free flags and longest lane equal the plain
    loop's on the card and the twin's, exactly, in one launch."""
    view, lo, hi, order, agent, _, _ = _case(seed, per_agent)
    gv = tgrid.local_grid_world(view, view.blocked_cumsum.to(cuda_dev))
    args = (gv, _on(lo, cuda_dev), _on(hi, cuda_dev), _on(order, cuda_dev))
    sfc.reset_counts()
    launches = sfc_cuda.launches
    got = sfc.expand_box(*args, max_radius_cells=r, agent=_on(agent, cuda_dev))
    torch.cuda.synchronize()
    assert sfc_cuda.launches == launches + 1 and sfc.trips == 0 and sfc.syncs == 0
    t_lo, t_hi, t_ok, t_trips = _twin_all(view, lo, hi, order, agent, r)
    assert sfc.read_lane_trips() == t_trips.max()
    want = sfc.expand_box(*args, max_radius_cells=r, agent=_on(agent, cuda_dev), plain=True)
    for a, b, t in zip(got, want, (t_lo, t_hi, t_ok)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.cpu().numpy(), t)


@pytest.mark.cuda
@pytest.mark.parametrize("per_agent", [False, True], ids=["shared", "per_agent"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["hull", "point", "substep"])
def test_update_sfc_fused_kernel_equals_plain(cuda_dev, monkeypatch, mode, dim, per_agent):
    """update_sfc on the card in each mode: 'point' and 'substep'
    through expand_box's kernel, equal to the plain loop on the same
    lanes; 'hull' as one launch of the fused kernel (no expand_box call),
    equal to the plain body on the card; the boxes equal the CPU path's."""
    A, M, N = 24, 10, 6
    rng, boxes, gt, occ = _world(10 + dim, A if per_agent else 0)
    views = []  # (device, world view): the CPU's, then the card's
    for dev in ("cpu", cuda_dev):
        g = tgrid.build_grid_world(boxes, WMIN, WMAX, RES, RADIUS, dev)
        if per_agent:
            g = tgrid.local_grid_world(
                g, tgrid.blocked_cumsum(torch.as_tensor(occ, device=dev), RES, RADIUS)[1])
        views.append((dev, g))
    z = rng.uniform(0.3, 1.2, A) if dim == 3 else np.full(A, 0.6)
    pos = np.column_stack([rng.uniform(-1.6, 1.6, (A, 2)), z]).astype(np.float32)

    def near(s):
        d = rng.uniform(-s, s, (A, 3)) * ([1, 1, 1] if dim == 3 else [1, 1, 0])
        return (pos + d).astype(np.float32)

    last_pt, cgoal, wpt = near(0.5), near(1.5), near(1.0)
    g0 = views[0][1]
    slo = (g0.point_to_lattice_floor(torch.as_tensor(pos)) - 2)[:, None].expand(A, M, 3)
    shi = (g0.point_to_lattice_ceil(torch.as_tensor(pos)) + 2)[:, None].expand(A, M, 3)
    init = torch.as_tensor(rng.random(A) < 0.7)
    ictrl = torch.as_tensor(np.linspace(pos, last_pt, M * N, axis=1).reshape(A, M, N, 3))
    cpu_args = [slo.contiguous(), shi.contiguous(), init,
                *map(torch.as_tensor, (last_pt, cgoal, wpt, pos)), ictrl]
    calls = []
    kernel_expand = sfc.expand_box

    def record(*a, **k):
        out = kernel_expand(*a, **k)
        calls.append((a, k, out))
        return out

    monkeypatch.setattr(sfc, "expand_box", record)
    fused = sfc_cuda.hull_launches
    out = [sfc.update_sfc(view, mode, *(t.to(dev) for t in cpu_args), 0.15,
                          max_radius_cells=20) for dev, view in views]
    if mode == "hull":
        assert len(calls) == 1 and sfc_cuda.hull_launches == fused + 1  # the CPU call only
        card_args = (views[1][1], mode, *(t.to(cuda_dev) for t in cpu_args), 0.15)
        want = sfc.update_sfc(*card_args, max_radius_cells=20, plain=True)
        for x, y in zip(out[1], want):
            assert torch.equal(x, y), mode
    else:
        _, (a, k, got) = calls  # the CPU call, then the card's
        assert got[0].device.type == "cuda"
        want = kernel_expand(*a, **{**k, "plain": True})
        for x, y in zip(got, want):
            assert torch.equal(x, y), mode
    for x, y in zip(*out):
        assert torch.equal(x, y.cpu()), mode
