"""The ADMM kernel's cluster build (`csrc/admm.cu`, `<256,cluster>`) on the CPU.

The kernel itself runs only on the card (its `cuda` tests are in
tests/test_torch_cuda.py, which imports no jax). Here:

- `qp_cuda.cluster_plan`, the pure-Python choice of the cluster size C
  and each CTA's shared bytes, at every shape the cluster build takes in
  tests/test_torch_cuda.py's WIDE table and at phases 8f's and 8h's, for
  the main batch (A = 1024) and the compacted rescue (A = 64);
- the fixed row groups: every C cuts an agent's LSC slots, static rows
  and stencil columns into the same 8 groups, each held by one CTA;
- `cluster_twin`, a torch twin of the build's order of operations on
  the CPU (float32 state, the adjoint's partial sums in double per group
  and added in group order, rhs, Kinv·rhs and the control points in
  double, each row rounded once), against the plain loop at dim·K 102
  (3-D, M = 12) and 116 (Bézier degree 8), and, with the port's plain
  preparation before it and its finish after it (`qp.solve` with the
  twin as its loop), against the JAX package's `solve` on the same QP
  inputs, with tests/test_torch_qp.py's contract.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.ops import qp, qp_check, qp_cuda

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

H100_SMEM_OPTIN = 232448  # bytes a block may opt in to on the H100 (227 KB)
# (dim, O, M, N, K, R_stat) of the shapes the cluster build takes: the WIDE
# QPs of tests/test_torch_cuda.py (their fleets' slots) and 8f / 8h
SHAPES = {
    "8f": (3, 80, 12, 6, 34, 774),
    "8h": (2, 16, 10, 9, 58, 590),
    "dk102": (3, 40, 12, 6, 34, 774),
    "dk108": (3, 16, 12, 6, 36, 774),
    "dk138": (3, 16, 16, 6, 46, 1128),
    "dk246": (3, 16, 28, 6, 82, 2478),
    "dk246_O160": (3, 160, 28, 6, 82, 2478),
    "dk116_n8": (2, 16, 10, 9, 58, 590),
    "dk174_n8_3d": (3, 16, 10, 9, 58, 885),
    "O256_2d": (2, 256, 10, 6, 28, 410),  # chip_smoke.py 8g: 2-D rows past a block
}
# clusters of C CTAs an H100 holds at once at two CTAs an SM
# (cudaOccupancyMaxActiveClusters on an H100 80GB HBM3)
H100_RESIDENT = {2: 132, 4: 62, 8: 30}
# (C, N3k staged, bytes a CTA) at A = 1024 and at A = 64 (the rescue) with
# the H100's residency, and at A = 64 by the batch alone (no residency)
PLANS = {
    "8f": ((2, False, 111888), (2, False, 111888), (4, True, 69736)),
    "8h": ((2, True, 92280), (2, True, 92280), (4, True, 60264)),
    "dk102": ((2, True, 95896), (2, True, 95896), (4, True, 56776)),
    "dk108": ((2, True, 83616), (2, True, 83616), (4, True, 50808)),
    "dk138": ((2, False, 106992), (2, False, 106992), (4, True, 76480)),
    "dk246": ((8, False, 77112), (8, False, 77112), (8, False, 77112)),
    "dk246_O160": ((8, True, 186976), (8, True, 186976), (8, True, 186976)),
    "dk116_n8": ((2, True, 92280), (2, True, 92280), (4, True, 60264)),
    "dk174_n8_3d": ((4, True, 87076), (4, True, 87076), (4, True, 87076)),
    "O256_2d": ((4, True, 89424), (4, True, 89424), (4, True, 89424)),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cluster_plan(name):
    """C and a CTA's bytes at A = 1024 and A = 64: the smallest C of 2, 4,
    8 at which two CTAs fit an SM (8 where none does), doubled while the
    batch has fewer than 132 CTAs, keeps at most 264 and, given the
    device's residency, while its clusters all stay resident (62 clusters
    of 4 on the H100: the 64-agent rescue keeps C = 2); every CTA within
    the device's 227 KB; N3k staged only where two CTAs (one, where two
    never fit) still fit an SM with it."""
    shape = SHAPES[name]
    for A, resident, want in zip((1024, 64, 64), (H100_RESIDENT.get, H100_RESIDENT.get, None),
                                 PLANS[name]):
        C, n3k, nbytes = qp_cuda.cluster_plan(shape, A, H100_SMEM_OPTIN, resident=resident)
        assert (C, n3k, nbytes) == want, (name, A, C, n3k, nbytes)
        assert nbytes == qp_cuda.cluster_cta_bytes(*shape, C, n3k) <= H100_SMEM_OPTIN
        fits = [c for c in qp_cuda.CLUSTER_SIZES
                if qp_cuda.ctas_per_sm(qp_cuda.cluster_cta_bytes(*shape, c, False),
                                       H100_SMEM_OPTIN) >= 2]
        base = fits[0] if fits else 8
        assert C == base or (A * base < qp_cuda.SMS and A * C <= 2 * qp_cuda.SMS)
        assert resident is None or A <= resident(C) or C == base
        two = qp_cuda.ctas_per_sm(qp_cuda.cluster_cta_bytes(*shape, C, False),
                                  H100_SMEM_OPTIN) >= 2
        assert qp_cuda.ctas_per_sm(nbytes, H100_SMEM_OPTIN) >= (2 if two else 1)


@pytest.mark.parametrize("name,A,build", [
    ("8h", 1024, qp_cuda.MEMORY_BUILD), ("8h", 264, qp_cuda.MEMORY_BUILD),
    ("8h", 263, qp_cuda.CLUSTER_BUILD), ("8h", 64, qp_cuda.CLUSTER_BUILD),
    ("dk108", 1024, qp_cuda.MEMORY_BUILD), ("8f", 1024, qp_cuda.CLUSTER_BUILD),
    ("dk138", 1024, qp_cuda.CLUSTER_BUILD), ("dk246_O160", 1024, qp_cuda.CLUSTER_BUILD)])
def test_loop_plan_memory_or_cluster(name, A, build):
    """Past the register builds: the memory build (one agent a block, C =
    1) where two of its blocks fit an SM and the batch fills every SM
    twice; else the cluster build at cluster_plan's C."""
    shape = SHAPES[name]
    got = qp_cuda.loop_plan(shape, A, H100_SMEM_OPTIN, resident=H100_RESIDENT.get)
    assert got[0] == build, got
    if build == qp_cuda.MEMORY_BUILD:
        assert got[1:] == (1, False, qp_cuda.memory_block_bytes(*shape))
        assert qp_cuda.ctas_per_sm(got[3], H100_SMEM_OPTIN) >= 2
    else:
        assert got[1:] == qp_cuda.cluster_plan(shape, A, H100_SMEM_OPTIN,
                                               resident=H100_RESIDENT.get)


def test_cluster_plan_small_batches_and_reach():
    """A batch of 10 agents takes C = 8 (80 CTAs), 100 agents C = 2 (200
    CTAs: 4 would pass 264); a shape whose CTA passes the device even at C
    = 8 is refused, not planned."""
    shape = SHAPES["8f"]
    for resident in (None, H100_RESIDENT.get):
        assert qp_cuda.cluster_plan(shape, 10, H100_SMEM_OPTIN, resident=resident)[0] == 8
        assert qp_cuda.cluster_plan(shape, 100, H100_SMEM_OPTIN, resident=resident)[0] == 2
        assert qp_cuda.cluster_plan(shape, 33, H100_SMEM_OPTIN, resident=resident)[0] == 4
    with pytest.raises(ValueError, match="cluster build's reach"):
        qp_cuda.cluster_plan((3, 640, 28, 6, 82, 2478), 1024, H100_SMEM_OPTIN)


# (dim, O, M, N, K, R_stat) of shapes the cluster build cannot take: ROADMAP's
# 640 slots at M = 28 in 3-D and chip_smoke.py 8g's 480 (rows and Kinv past 8
# CTAs), 3-D at M = 110 (K = 328: 23,265 static rows, past 16-bit stencil
# indices and past 8 CTAs), and static rows past 16-bit indices alone
# (a made-up R_stat on 8f's horizon: 180 KB a CTA at C = 8)
PAST_CLUSTER = {"O640_M28": (3, 640, 28, 6, 82, 2478), "O480_M28": (3, 480, 28, 6, 82, 2478),
                "M110": (3, 1, 110, 6, 328, 23265), "stencil16": (3, 1, 12, 6, 34, 22000)}


@pytest.mark.parametrize("name", sorted(PAST_CLUSTER))
def test_loop_plan_global_past_the_cluster_reach(name):
    """Where `cluster_plan` refuses a shape (for every batch), `loop_plan`
    returns the global build (C = 0, one agent a block, rows and Kinv in
    global memory, streamed through a ring of GLOBAL_STAGES stages: a
    block's shared memory what it keeps and the ring,
    `qp_cuda.global_tile_plan`) and raises for no batch; `cluster_reach`
    tells those shapes, and every shape the cluster build takes (SHAPES)
    stays in its reach."""
    shape = PAST_CLUSTER[name]
    dim, O, M, N, K, R_stat = shape
    assert (3 * R_stat >= 1 << 16
            or qp_cuda.cluster_cta_bytes(*shape, 8, False) > H100_SMEM_OPTIN)
    assert not qp_cuda.cluster_reach(shape, H100_SMEM_OPTIN)
    for A in (1, 4, 64, 481, 1024):
        with pytest.raises(ValueError, match="cluster build's reach"):
            qp_cuda.cluster_plan(shape, A, H100_SMEM_OPTIN, resident=H100_RESIDENT.get)
        got = qp_cuda.loop_plan(shape, A, H100_SMEM_OPTIN, resident=H100_RESIDENT.get)
        assert got == (qp_cuda.GLOBAL_BUILD, 0, False, qp_cuda.global_block_bytes(*shape))
    MN, dk, nv = M * N, dim * K, dim * M * N
    plan = qp_cuda.global_tile_plan(*shape)
    # doubles: 4 dim·MN-vectors, 2 dk-vectors, 3 a thread-item of the LSC
    # partials, an mbarrier a stage; floats: 3 dk-vectors, the group's static
    # rows, the reductions, the segments, the groups' tile table; the ring
    resident = (2 * (4 * nv + 2 * dk + 3 * 256 * plan["ntrips"] + 3) + 3 * dk + plan["GS"] + 64
                + MN + 17)
    assert plan["resident"] == (resident + 3) & ~3
    assert qp_cuda.global_block_bytes(*shape) == 4 * (plan["resident"] + 3 * plan["stage"])
    assert qp_cuda.global_block_bytes(*shape) < qp_cuda.memory_block_bytes(*shape)
    assert qp_cuda.global_block_bytes(*shape) <= H100_SMEM_OPTIN
    assert all(qp_cuda.cluster_reach(s, H100_SMEM_OPTIN) for s in SHAPES.values())


@pytest.mark.parametrize("O,R_stat", [(80, 774), (16, 590), (160, 2478), (9, 410), (5, 30)])
def test_groups_partition_the_rows_at_every_C(O, R_stat):
    """At C = 2, 4, 8 the CTAs' slots and static rows are disjoint,
    contiguous and cover the agent's, and every group holds the same
    slots and rows whichever CTA holds it."""
    by_group = {}
    for C in qp_cuda.CLUSTER_SIZES:
        cut = qp_cuda.group_rows(O, R_stat, C)
        assert [g for groups, _, _ in cut for g in groups] == list(range(qp_cuda.GROUPS))
        assert cut[0][1][0] == 0 and cut[-1][1][1] == O
        assert cut[0][2][0] == 0 and cut[-1][2][1] == R_stat
        for (_, (_, o1), (_, s1)), (_, (o0, _), (s0, _)) in zip(cut, cut[1:]):
            assert (o1, s1) == (o0, s0)
        G, GS = -(-O // qp_cuda.GROUPS), -(-R_stat // qp_cuda.GROUPS)
        for groups, (o0, o1), (s0, s1) in cut:
            slots = {g: (min(O, g * G), min(O, (g + 1) * G)) for g in groups}
            rows = {g: (min(R_stat, g * GS), min(R_stat, (g + 1) * GS)) for g in groups}
            for (a, b), (lo, hi) in ((zip(*slots.values()), (o0, o1)),
                                     (zip(*rows.values()), (s0, s1))):
                assert (min(a), max(b)) == (lo, hi)
            for g in groups:
                assert by_group.setdefault(g, (slots[g], rows[g])) == (slots[g], rows[g])


@pytest.mark.parametrize("dim,M,n", [(3, 12, 5), (2, 10, 8), (2, 10, 5)])
def test_group_ptr_cuts_the_stencil_columns(dim, M, n):
    """`group_ptr` cuts each transposed-stencil column into the groups'
    entries, in order: group j's entries are exactly the column's static
    rows in group j."""
    cfg = _cfg(dim, M, n)
    tab = qp.stencil_table(cfg)
    ptr, rows, gp = tab["adj_ptr"], tab["adj_row"], tab["grp_ptr"]
    R_stat = tab["idx"].shape[0]
    nv = len(ptr) - 1
    GS = -(-R_stat // qp_cuda.GROUPS)
    gp = gp.reshape(qp_cuda.GROUPS + 1, nv)
    assert gp.dtype == np.int32
    assert np.array_equal(gp[0], ptr[:-1]) and np.array_equal(gp[-1], ptr[1:])
    for i in range(nv):
        for j in range(qp_cuda.GROUPS):
            got = rows[gp[j, i]:gp[j + 1, i]]
            col = rows[ptr[i]:ptr[i + 1]]
            assert np.array_equal(got, col[(col >= j * GS) & (col < (j + 1) * GS)])


def _cfg(dim, M, n, O=16):
    return qp.QPConfig(dim=dim, M=M, n=n, phi=3, n_obs=O, use_comm=True, stop_at_horizon=True,
                       dt=0.2, control_input_weight=1.0, terminal_weight=10.0, rho=1.0,
                       sigma=1e-6, alpha=1.6, max_iter=200, eps_abs=1e-3)


# ---- the twin -----------------------------------------------------------


def _group_stencils(tab, nv, R_stat):
    """[8, dim·MN, R_stat] double: group j's transposed stencils, read off
    its entries of each column (`grp_ptr`) and zero elsewhere."""
    gp = tab["grp_ptr"].reshape(qp_cuda.GROUPS + 1, nv)
    out = torch.zeros(qp_cuda.GROUPS, nv, R_stat, dtype=torch.float64)
    for j in range(qp_cuda.GROUPS):
        for i in range(nv):
            e = slice(gp[j, i], gp[j + 1, i])
            out[j, i, torch.as_tensor(tab["adj_row"][e]).long()] = torch.as_tensor(
                tab["adj_coef"][e]).float().double()
    return out


def _group_partials(cfg, li, stencils, wl, ws, C):
    """[B, 8, dim·MN] double: each group's part of Aᵀw, formed by the CTA of
    a cluster of C that holds the group from that CTA's own rows only (its
    slots through the normals, its static rows through the group's
    stencils)."""
    B, O, M, dim = li.normals.shape
    MN, R_stat = cfg.M * cfg.N, ws.shape[1]
    G = -(-O // qp_cuda.GROUPS)
    mof = torch.arange(MN) // cfg.N
    out = torch.zeros(B, qp_cuda.GROUPS, dim * MN, dtype=torch.float64)
    for groups, (o0, o1), (s0, s1) in qp_cuda.group_rows(O, R_stat, C):
        nrm = li.normals[:, o0:o1].double()[:, :, mof, :]  # this CTA's slots [B, o, MN, dim]
        w_own, ws_own = wl[:, o0:o1].double(), ws[:, s0:s1].double()
        for g in groups:
            a, b = min(O, g * G) - o0, min(O, (g + 1) * G) - o0
            out[:, g] = (torch.einsum("bomd,bom->bdm", nrm[:, a:b], w_own[:, a:b]).reshape(B, -1)
                         + ws_own @ stencils[g][:, s0:s1].T)
    return out


def _adjoint(cfg, ts, li, stencils, wl, ws, C):
    """Aᵀw by the cluster's order: the group partials added in group order,
    rounded to float32 (VA), then the N3k product in double."""
    B, dim, K = li.xi.shape
    P = _group_partials(cfg, li, stencils, wl, ws, C)
    va = P[:, 0]
    for j in range(1, qp_cuda.GROUPS):
        va = va + P[:, j]
    va = va.float().double().view(B, dim, cfg.M * cfg.N)
    return torch.einsum("km,bdm->bdk", ts["N3k"].double(), va)


def cluster_twin(cfg, li, max_iter, feas_tol, C=2):
    """The cluster build's loop on CPU tensors (float32 LoopInputs): the
    kernel's order of operations, its exit gates every qp.CHUNK
    iterations and its global exit; returns what qp.admm_loop_plain
    returns. The result does not depend on C (each group's partial is
    formed from its own rows whichever CTA holds it)."""
    ts = qp.torch_statics(cfg, li.xi.device)
    tab = qp.stencil_table(cfg)
    B, O, M, dim = li.normals.shape
    K, MN, N = ts["K"], cfg.M * cfg.N, cfg.N
    R_lsc = O * MN
    f32 = torch.float32
    rho_lsc = torch.tensor(cfg.rho * qp._RHO_SCALE["lsc"], dtype=f32)
    rho_stat = ts["stencil"]["rho"]
    sigma, alpha = torch.tensor(cfg.sigma, dtype=f32), torch.tensor(cfg.alpha, dtype=f32)
    beta = torch.tensor(1 - cfg.alpha, dtype=f32)
    N3k = ts["N3k"].double()
    idx = torch.as_tensor(tab["idx"]).long()
    coef = torch.as_tensor(tab["coef"]).float().double()
    mof = torch.arange(MN) // N
    nrm = li.normals[:, :, mof, :].double()  # [B, O, MN, dim]
    stencils = _group_stencils(tab, dim * MN, li.z.shape[1] - R_lsc)
    lo = li.ln
    hi = torch.cat([torch.full((B, R_lsc), float("inf")), li.un[:, R_lsc:]], 1)
    rho = torch.cat([rho_lsc.expand(B, R_lsc), rho_stat.expand(B, -1)], 1)
    Kinv = li.Kinv.double()
    stop_tol = torch.tensor(0.6 * feas_tol, dtype=f32)

    def rows(vd):  # [B, dim, MN] double → float32 rows, each rounded once
        r_lsc = torch.einsum("bomd,bdm->bom", nrm, vd).reshape(B, R_lsc)
        r_st = (coef * vd.reshape(B, -1)[:, idx]).sum(-1)
        return torch.cat([r_lsc, r_st], 1).float()

    def points(x):  # control points in double
        return torch.einsum("bdk,km->bdm", x.double(), N3k)

    def split(w):
        return w[:, :R_lsc].view(B, O, MN), w[:, R_lsc:]

    xi, z, y = li.xi, li.z, li.y
    ax = rows(points(xi))
    itdone = torch.full((B,), max_iter, dtype=torch.int32)
    best = torch.full((B,), float("inf"))
    noimp = torch.zeros(B, dtype=torch.int32)
    n_chunks = max(1, -(-max_iter // qp.CHUNK))
    ck = 0
    while ck < n_chunks:
        xip = xi
        for _ in range(qp.CHUNK):
            g = _adjoint(cfg, ts, li, stencils, *split(rho * z - y), C)
            rhs = (sigma.double() * xi.double() - li.qn.double()) + g
            xt = torch.einsum("bij,bj->bi", Kinv, rhs.reshape(B, -1)).view(B, dim, K)
            zt = rows(points(xt))
            xi = alpha * xt.float() + beta * xi
            zmix = alpha * zt + beta * z
            zn = torch.minimum(torch.maximum(zmix + y / rho, lo), hi)
            y = y + rho * (zmix - zn)
            z = zn
            ax = alpha * zt + beta * ax
        ck += 1
        viol = torch.clamp(torch.maximum(lo - ax, ax - hi), min=0.0)
        feas = (viol / li.scale).amax(-1) < stop_tol
        aty = _adjoint(cfg, ts, li, stencils, *split(y), C).float()
        px = torch.einsum("akl,adl->adk", li.Pn, xi)
        rd = (px + li.qn + aty).abs().reshape(B, -1).amax(-1)
        dmag = torch.maximum(px.abs().reshape(B, -1).amax(-1),
                             torch.maximum(aty.abs().reshape(B, -1).amax(-1),
                                           li.qn.abs().reshape(B, -1).amax(-1)))
        opt = rd < cfg.eps_abs + 1e-3 * dmag
        stalled = (xi - xip).abs().reshape(B, -1).amax(-1) < 1e-4 * torch.clamp(
            xi.abs().reshape(B, -1).amax(-1), min=1.0)
        obj = torch.einsum("adk,adk->a", 0.5 * px + li.qn, xi)
        improved = obj < best - 2e-4 * torch.clamp(obj.abs(), min=1.0)
        best = torch.where(feas & improved, obj, best)
        noimp = torch.where(feas & ~improved, noimp + 1, 0).to(torch.int32)
        done = feas & (opt | stalled | (noimp >= 2))
        itdone = torch.where(done & (itdone == max_iter), ck * qp.CHUNK, itdone).to(torch.int32)
        if bool(done.all()):
            break
    return xi, z, y, itdone, torch.tensor(ck * qp.CHUNK, dtype=torch.int32)


# (build_fleet overrides, agents): dim·K 102 (3-D, M = 12) and 116 (Bézier
# degree 8, 2-D), 15 slots each (2 a group)
TWIN_CASES = {102: (dict(world_dimension=3, M=12), 16), 116: (dict(n=8), 16)}


@pytest.fixture(scope="module", params=sorted(TWIN_CASES))
def twin_qp(request):
    """The port's QP (plain body, CPU) of a fleet after 2 evolving steps."""
    over, A = TWIN_CASES[request.param]
    p, planner, fleet, inp = workload.build_fleet(A, device="cpu", **over)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(2):
        inp, _ = step(inp)
    cfg = planner.qp_cfg
    assert cfg.dim * qp.torch_statics(cfg, torch.device("cpu"))["K"] == request.param
    qp_inp = planner._step_impl(fleet, inp, defer_qp=True).qp_inp
    return request.param, cfg, qp.prepare(cfg, qp_inp).loop, planner.feas_tol


def _per_agent_close(a, b):
    """|a − b| within rtol 1e-4 of the agent's largest |b| / atol 1e-5
    (tests/test_torch_cuda.py's loop tolerance)."""
    d, m = (a - b).abs().flatten(1), b.abs().flatten(1)
    return bool((d.amax(1) <= 1e-5 + 1e-4 * m.amax(1)).all())


def test_twin_does_not_depend_on_C(twin_qp):
    """One chunk of the twin at C = 2, 4 and 8: the same bits."""
    _, cfg, li, feas_tol = twin_qp
    runs = [cluster_twin(cfg, li, qp.CHUNK, feas_tol, C) for C in qp_cuda.CLUSTER_SIZES]
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def _plain_exits(cfg, li, feas_tol, seed=0):
    """The float32 plain loop's exit iteration from `li` and from li with
    every entry of xi, z and y moved one ulp up or down at random (seeded),
    qp_check.ENVELOPE_RUNS runs in all: where float32 rounding alone puts
    the global exit."""
    g = torch.Generator().manual_seed(seed)

    def nudge(v):
        up = torch.rand(v.shape, generator=g) < 0.5
        return torch.nextafter(v, torch.where(up, torch.inf, -torch.inf).to(v.dtype))

    exits = {int(qp.admm_loop_plain(cfg, li, cfg.max_iter, feas_tol)[4])}
    for _ in range(qp_check.ENVELOPE_RUNS - 1):
        moved = dataclasses.replace(li, xi=nudge(li.xi), z=nudge(li.z), y=nudge(li.y))
        exits.add(int(qp.admm_loop_plain(cfg, moved, cfg.max_iter, feas_tol)[4]))
    return exits


def test_twin_matches_plain_loop(twin_qp):
    """The twin's run to its exit against the plain loop's. The exit chunk:
    the float32 plain loop's own exit moves by up to four chunks when its
    inputs move by one ulp (88–104 at dim·K 102, 104–136 at 116, CPU
    run), so the twin's exit must lie within the plain loop's exits over
    qp_check.ENVELOPE_RUNS such runs. Every chunk of the twin, from the
    twin's state, per agent within the loop tolerance of the plain chunk
    from the same state, or, where float32 ADMM is ill-conditioned
    (Bézier degree 8), held by tests/test_torch_cuda.py's float64 clause
    (`_chunk_held`); the run is its chain of single chunks, bit for bit."""
    from test_torch_cuda import _chunk_held

    dk, cfg, li, feas_tol = twin_qp
    got = cluster_twin(cfg, li, cfg.max_iter, feas_tol)
    exits = _plain_exits(cfg, li, feas_tol)
    assert min(exits) <= int(got[4]) <= max(exits), (int(got[4]), sorted(exits))
    state = li
    for _ in range(int(got[4]) // qp.CHUNK):
        k = cluster_twin(cfg, state, qp.CHUNK, feas_tol)
        p = qp.admm_loop_plain(cfg, state, qp.CHUNK, feas_tol)
        if dk == 116:
            _chunk_held(cfg, state, k, p, feas_tol)
        else:
            assert all(_per_agent_close(a, b) for a, b in zip(k[:3], p[:3]))
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)


def test_twin_solve_matches_jax(monkeypatch):
    """`qp.solve` on the CPU with the twin as its loop (the port's plain
    preparation before it, its rescue and finish after it) against the
    JAX package's `solve` on the same QP inputs (a 3-D fleet of 8 at M =
    12, dim·K 102, after 2 evolving steps of the JAX pipeline), with
    tests/test_torch_qp.py's contract: as many agents converged less one,
    objectives within rtol/atol 2e-2 and control points within 0.1 m where
    both converged."""
    import bench
    from lsc_dr_planner_tpu.ops import qp as jqp
    from test_torch_qp import check_contract, port_cfg, port_inputs
    from test_torch_wide_shapes import _jax_fleet

    p, planner, fleet, inp = _jax_fleet(monkeypatch, 8, dict(world_dimension=3, M=12))
    step = bench.make_evolve_step(p, planner, fleet)
    for _ in range(2):
        inp, _ = step(inp)
    cfg, feas_tol = planner.qp_cfg, planner.feas_tol
    qp_inp = planner._step_impl(fleet, inp, defer_qp=True).qp_inp
    pcfg = port_cfg(cfg)
    assert pcfg.dim * qp.torch_statics(pcfg, torch.device("cpu"))["K"] == 102
    ref = jqp.solve(cfg, qp_inp, feas_tol=feas_tol)
    calls = []

    def twin_loop(cfg_, li, max_iter, feas_tol_, plain=False):
        calls.append(max_iter)
        return cluster_twin(cfg_, li, max_iter, feas_tol_)

    monkeypatch.setattr(qp, "run_loop", twin_loop)
    out = qp.solve(pcfg, port_inputs(qp_inp), feas_tol=feas_tol)
    assert calls[0] == pcfg.max_iter
    check_contract(out, ref, feas_tol, full_convergence=False)
