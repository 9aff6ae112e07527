"""The fused CLSC kernel (csrc/hull_closest.cu's clsc_build entry,
ops/hull_cuda.py::build_clsc_cuda) and its dispatch in
ops/lsc.py::build_clsc.

On the CPU: CPU tensors take the plain torch body, the kernel's entry
raises on them, a scalar float32 twin of the kernel's thread (one
(agent, neighbour, segment) hull at a time, in the kernel's order of
operations) is held to the plain body bit for bit, and the plain body,
whose rounding is pinned for the kernel, is held to the JAX package's
build_clsc at ATOL; the cases include segments of 9 to 12 control
points (the run-time build) and an evolving fleet of degree 8 (N = 9).
The `cuda` tests hold the kernel to the plain body on the card, bit for
bit, for every N from 1 to 16 and at stages past 48 KB of shared
memory; they import neither jax nor the JAX package, so on the GPU
machine they run with `python -m pytest --noconftest -m cuda
tests/test_torch_clsc_kernel.py` (tests/conftest.py imports jax).
"""

import functools

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu_torch.ops import hull_cuda, lsc
from test_torch_hull_kernel import _axpy, _clamp_min, _cross, _dot3, _sub, _triangle
from test_torch_hull_kernel import EPS, VOL_EPS, _segment, assert_equal_by_value, f32

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

F = np.float32
EPS_F, GUARD = F(1e-6), F(1e-4)  # lsc.py's _EPS_F and the guard's slack, as float32
ATOL = 1e-5  # against the JAX package: its dot products are XLA's einsum and sums
NAMES = ("initial_ctrl", "obs_ctrl", "obs_goal", "agent_radius", "agent_downwash",
         "obs_radius", "obs_downwash", "obs_is_agent", "current_goal", "obs_mask")


# ---- the kernel's thread, in Python ------------------------------------------
def _clamp01(x):
    return x if np.isnan(x) else min(max(x, F(0)), F(1))


def _unit(v, n):
    d = _clamp_min(n, EPS_F)
    return (v[0] / d, v[1] / d, v[2] / d)


def _signed_vol(p0, p1, p2, p3):
    return _dot3(_sub(p1, p0), _cross(_sub(p2, p0), _sub(p3, p0)))


def _in_tetra(a, b, c, d):
    """Each volume only if every test before it passed, as the kernel."""
    o = (F(0),) * 3
    v0 = _signed_vol(a, b, c, d)
    if not abs(v0) > VOL_EPS:
        return False
    for p in ((o, b, c, d), (a, o, c, d), (a, b, o, d), (a, b, c, o)):
        v = _signed_vol(*p)
        if not (v >= -VOL_EPS if v0 > 0 else v <= VOL_EPS):
            return False
    return True


def _hull(p):
    """hull_query: (closest, dist) of conv(p) to the origin."""
    K = len(p)
    best, bd = p[0], _dot3(p[0], p[0])
    cands = [p[i] for i in range(1, K)]
    cands += [_segment(p[i], p[j]) for i in range(K) for j in range(i + 1, K)]
    cands += [_triangle(p[i], p[j], p[k]) for i in range(K) for j in range(i + 1, K)
              for k in range(j + 1, K)]
    for q in cands:
        d = _dot3(q, q)
        if d < bd or (np.isnan(d) and not np.isnan(bd)):
            best, bd = q, d
    if any(_in_tetra(p[i], p[j], p[k], p[m]) for i in range(K) for j in range(i + 1, K)
           for k in range(j + 1, K) for m in range(k + 1, K)):
        return (F(0),) * 3, F(0)
    return best, np.sqrt(bd)


def _segments(p1, p2, q1, q2):
    """segments_closest: (cp, cq, |cq − cp|)."""
    d1, d2, r = _sub(p2, p1), _sub(q2, q1), _sub(p1, q1)
    a, e, f, c, b = _dot3(d1, d1), _dot3(d2, d2), _dot3(d2, r), _dot3(d1, r), _dot3(d1, d2)
    denom = a * e - b * b
    s_gen = _clamp01((b * f - c * e) / _clamp_min(denom, EPS))
    s = s_gen if denom > EPS * _clamp_min(a * e, F(1)) else F(0)
    s = F(0) if a <= EPS else s
    t = (b * s + f) / _clamp_min(e, EPS)
    tc = _clamp01(t)
    s2 = _clamp01((b * tc - c) / _clamp_min(a, EPS))
    s = F(0) if a <= EPS else (s if t == tc else s2)
    cp = _axpy(p1, s, d1)
    cq = _axpy(q1, F(0) if e <= EPS else tc, d2)
    dd = _sub(cq, cp)
    return cp, cq, np.sqrt(_dot3(dd, dd))


def twin_thread(x, dim, a, o, m):
    """The kernel's thread of hull (a, o, m) on the numpy inputs `x` (by
    name): (normal [3], anchors [N, 3], margins [N])."""
    M = x["obs_ctrl"].shape[2]
    ar, ad = F(x["agent_radius"][a]), F(x["agent_downwash"][a])
    orad, od = F(x["obs_radius"][a, o]), F(x["obs_downwash"][a, o])
    den = ar + orad
    dw = (ad * ar + od * orad) / den if x["obs_is_agent"][a, o] else (ar + od * orad) / den
    dwe = dw if dim == 3 else F(1)

    def zs(v):
        return (F(v[0]), F(v[1]), F(v[2]) / dwe)

    it = [zs(v) for v in x["initial_ctrl"][a, m]]
    obs = [tuple(F(c) for c in v) for v in x["obs_ctrl"][a, o, m]]
    rel = [_sub(i, zs(v)) for i, v in zip(it, obs)]
    closest, dist = _hull(rel)
    normal = _unit(closest, dist)
    marg = [F(0.5) * (den + _dot3(r, normal)) for r in rel]
    anchors = obs
    if m == M - 1:
        cp, cq, seg = _segments(zs(obs[-1]), zs(x["obs_goal"][a, o]), it[-1],
                                zs(x["current_goal"][a]))
        nl = _unit(_sub(cq, cp), seg)
        ml = F(0.5) * (den + seg)
        floor_ = ml - GUARD
        if all(_dot3(_sub(i, cp), nl) >= floor_ for i in it):
            normal, marg, anchors = nl, [ml] * len(rel), [cp] * len(rel)
    keep = x["obs_mask"][a, o]
    normal = (normal[0], normal[1], normal[2] / dw) if keep else (F(0),) * 3
    return np.asarray(normal, F), np.asarray(anchors, F), np.asarray(marg, F)


def twin(x, dim):
    """twin_thread over every hull: (normals, anchors, margins)."""
    A, O, M = x["obs_ctrl"].shape[:3]
    with np.errstate(all="ignore"):  # NaN inputs
        out = [[[twin_thread(x, dim, a, o, m) for m in range(M)] for o in range(O)]
               for a in range(A)]
    return tuple(np.asarray([[[t[k] for t in row] for row in agent] for agent in out])
                 for k in range(3))


# ---- inputs -------------------------------------------------------------------
def clsc_inputs(seed, dim, A=5, O=4, M=10, N=6):
    """build_clsc's inputs (numpy, by name): neighbours near each agent,
    some of them obstacles (another downwash), some slots masked; in 2-D
    every point at z = 0.6."""
    rng = np.random.default_rng(seed)
    init = f32(rng, A, M, N, 3)
    obs = init[:, None] + 0.8 + f32(rng, A, O, M, N, 3, scale=0.5)
    if dim == 2:
        init[..., 2] = obs[..., 2] = 0.6
    x = dict(initial_ctrl=init, obs_ctrl=obs, obs_goal=f32(rng, A, O, 3),
             agent_radius=np.full(A, 0.15, F) + f32(rng, A, scale=0.01),
             agent_downwash=np.full(A, 2.0, F),
             obs_radius=np.full((A, O), 0.15, F) + f32(rng, A, O, scale=0.02),
             obs_downwash=np.where(rng.uniform(size=(A, O)) < 0.5, 2.0, 1.0).astype(F),
             obs_is_agent=rng.uniform(size=(A, O)) < 0.7, current_goal=f32(rng, A, 3),
             obs_mask=rng.uniform(size=(A, O)) < 0.7)
    if dim == 2:
        x["obs_goal"][..., 2] = x["current_goal"][..., 2] = 0.6
    # goals beside the last segments, so that the guard holds for some pairs
    x["current_goal"] = (init[:, -1, -1] + 3.0 * (init[:, -1, -1] - obs[:, 0, -1, -1])).astype(F)
    return x


@functools.lru_cache(maxsize=None)
def fleet_inputs(A=32, steps=2, dim=2, device="cpu", **over):
    """build_clsc's inputs on `workload.build_fleet(A, **over)` after
    `steps` evolving steps on `device` (numpy, by name), and the
    dimension."""
    from lsc_dr_planner_tpu_torch import workload

    p, planner, fleet, inp = workload.build_fleet(A, device=device, world_dimension=dim, **over)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(steps):
        inp, _ = step(inp)
    seen = []
    build = lsc.build_clsc

    def record(*a, **k):
        seen.append((a, k))
        return build(*a, **k)

    lsc.build_clsc = record
    try:
        planner._step_impl(fleet, inp)
    finally:
        lsc.build_clsc = build
    ((a, k),) = seen
    x = dict(zip(NAMES, (t.cpu().numpy() for t in a[:10])))
    return x, a[10] if len(a) > 10 else k["world_dimension"]


def named_inputs(what):
    """(inputs, dim) of a case: "<dim>d-<seed>" (N = 6) or
    "<dim>d-<seed>-N<N>", "fleet-<dim>d" (a few agents of an evolving
    fleet) or "fleet-<dim>d-n8" (of degree 8: N = 9), "nan" or "nan-N9"
    (NaN and infinite points), or "tie-N9" (hulls whose candidates tie:
    vertices, edges and triangles of equal squared norms, and a hull of
    nine equal points)."""
    if what.startswith("fleet"):
        over = {"n": 8} if what.endswith("-n8") else {}
        x, dim = fleet_inputs(dim=int(what.split("-")[1][0]), **over)
        return {k: v[:4] for k, v in x.items()}, dim
    if what == "tie-N9":
        x = clsc_inputs(11, 3, N=9)
        # relative points exactly these: 0 − (−P) (z: 0 / dw − (−0 / dw))
        ring = np.asarray([[3, 4, 0], [4, 3, 0], [5, 0, 0], [4, -3, 0], [3, -4, 0],
                           [-3, 4, 0], [-4, 3, 0], [0, 5, 0], [0, -5, 0]], F)
        x["initial_ctrl"][0, 3] = x["initial_ctrl"][1, 2] = 0.0
        x["obs_ctrl"][0, :, 3] = -ring
        x["obs_ctrl"][1, 0, 2] = -ring[0]
        x["obs_ctrl"][1, 1, 2] = -ring[[0, 1, 0, 1, 0, 1, 0, 1, 0]]
        return x, 3
    if what.startswith("nan"):
        x = clsc_inputs(9, 3, N=9 if what.endswith("-N9") else 6)
        x["obs_ctrl"][0, 1, 2, 3, 0] = np.nan
        x["obs_ctrl"][1, 0, -1, -1, 2] = np.nan  # the last segment's end
        x["initial_ctrl"][2, 4, 0, 1] = np.inf
        x["obs_goal"][3, 2, 0] = np.nan
        return x, 3
    dim, seed = int(what[0]), int(what.split("-")[1])
    N = int(what.split("-N")[1]) if "-N" in what else 6
    return clsc_inputs(seed, dim, N=N), dim


def plain(x, dim):
    """The plain body on the CPU, as numpy (normals, anchors, margins)."""
    s = lsc.build_clsc(**{k: torch.as_tensor(v) for k, v in x.items()}, world_dimension=dim)
    return s.normals.numpy(), s.anchors.numpy(), s.margins.numpy()


CASES = ["2d-0", "2d-1", "3d-0", "3d-1", "fleet-2d", "fleet-3d", "nan",
         # the run-time build's N (> 8)
         "2d-0-N9", "3d-1-N9", "3d-2-N10", "2d-3-N12", "fleet-2d-n8", "fleet-3d-n8", "nan-N9",
         "tie-N9"]


# ---- on the CPU -------------------------------------------------------------
@pytest.mark.parametrize("what", CASES)
def test_twin_equals_plain(what):
    """The kernel's thread, hull by hull, equals the plain body bit for
    bit (by value): 2-D and 3-D, masked slots, obstacles of another
    downwash, an evolving fleet's pairs, NaN and infinite points."""
    x, dim = named_inputs(what)
    got, want = twin(x, dim), plain(x, dim)
    assert_equal_by_value(got, want)
    if not what.startswith("nan"):
        assert np.isfinite(want[0]).all()


def test_flat_hulls_fail_every_tetrahedron():
    """Points all at z = ±0 (CLSC's relative points in 2-D), finite or not
    in x and y: every tetrahedron's first volume is ±0 or NaN, so every
    `_in_tetra` fails, which lets the run-time build leave the tests out
    (flat_hull in csrc/hull_closest.cu)."""
    import itertools

    rng = np.random.default_rng(6)
    for trial in range(40):
        p = rng.normal(size=(7, 3)).astype(F) * F(3)
        p[:, 2] = np.where(rng.random(7) < 0.5, F(0), F(-0.0))
        if trial % 4 == 1:
            p[rng.integers(7), rng.integers(2)] = np.inf
        elif trial % 4 == 2:
            p[rng.integers(7), rng.integers(2)] = np.nan
        pts = [tuple(r) for r in p]
        with np.errstate(all="ignore"):
            assert not any(_in_tetra(*(pts[i] for i in c))
                           for c in itertools.combinations(range(7), 4))


@pytest.mark.parametrize("dim", [2, 3])
def test_cases_take_both_branches_of_the_guard(dim):
    """The last segment of some pairs takes the segment plane, of others
    the hull plane: the twin's test covers both."""
    x, _ = named_inputs(f"{dim}d-0")
    n, anchors, _ = plain(x, dim)
    seg = np.isclose(anchors[:, :, -1, 0], anchors[:, :, -1, 1]).all(-1)  # all N equal: cp
    assert seg.any() and not seg.all()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax(dim, seed):
    """The pinned plain body against the JAX package's build_clsc, the
    masked slots included (their normals are zero in both)."""
    import jax.numpy as jnp

    from lsc_dr_planner_tpu.ops import lsc as jlsc

    x = clsc_inputs(seed, dim)
    got = plain(x, dim)
    s = jlsc.build_clsc(**{k: jnp.asarray(v) for k, v in x.items()}, world_dimension=dim)
    for g, w in zip(got, (s.normals, s.anchors, s.margins)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL)
    assert not got[0][~x["obs_mask"]].any()


@pytest.mark.parametrize("dim", [2, 3])
def test_plain_matches_jax_at_degree_8(dim):
    """The plain body against the JAX package's build_clsc on segments
    of 9 control points (Bézier degree 8), the masked slots included: the
    synthetic pairs (their last segments mostly on the hull plane) and a
    fleet of degree 8's (on the segment plane)."""
    import jax.numpy as jnp

    from lsc_dr_planner_tpu.ops import lsc as jlsc

    seg = []
    for x in (clsc_inputs(dim, dim, N=9), named_inputs(f"fleet-{dim}d-n8")[0]):
        got = plain(x, dim)
        s = jlsc.build_clsc(**{k: jnp.asarray(v) for k, v in x.items()}, world_dimension=dim)
        for g, w in zip(got, (s.normals, s.anchors, s.margins)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL)
        assert not got[0][~x["obs_mask"]].any()
        seg.append(np.isclose(got[1][:, :, -1, 0], got[1][:, :, -1, 1]).all(-1).ravel())
    seg = np.concatenate(seg)
    assert seg.any() and not seg.all()  # both branches of the guard


def test_cpu_tensors_take_the_plain_body():
    """CPU tensors run the plain body: no kernel launch, no count of
    plain bodies on CUDA; plain=True gives the same result."""
    x, dim = named_inputs("3d-0")
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    launches, hulls, plain_cuda = (hull_cuda.clsc_launches, hull_cuda.launches,
                                   lsc.plain_cuda_calls)
    got = lsc.build_clsc(**t, world_dimension=dim)
    again = lsc.build_clsc(**t, world_dimension=dim, plain=True)
    assert (hull_cuda.clsc_launches, hull_cuda.launches, lsc.plain_cuda_calls) == (
        launches, hulls, plain_cuda)
    for name in ("normals", "anchors", "margins"):
        assert torch.equal(getattr(got, name), getattr(again, name))


def test_other_devices_raise():
    x, dim = named_inputs("2d-0")
    with pytest.raises(ValueError, match="no CLSC construction for device meta"):
        lsc.build_clsc(**{k: torch.as_tensor(v).to("meta") for k, v in x.items()},
                       world_dimension=dim)


def _bad(what):
    t = {k: torch.as_tensor(v) for k, v in named_inputs("2d-0")[0].items()}
    if what == "float64":
        t["obs_goal"] = t["obs_goal"].double()
    elif what == "shape":
        t["current_goal"] = t["current_goal"][:-1]
    elif what == "non_contiguous":
        t["obs_radius"] = t["obs_radius"].t().contiguous().t()
    elif what == "N0":
        t["obs_ctrl"] = torch.zeros(5, 4, 10, 0, 3)
    elif what == "rank":
        t["obs_ctrl"] = t["obs_ctrl"][0]
    return t


@pytest.mark.parametrize("what,match", [
    ("float64", "obs_goal: need torch.float32"), ("shape", "current_goal: shape"),
    ("non_contiguous", "obs_radius: not contiguous"), ("N0", "N >= 1"),
    ("rank", r"need \[A, O, M, N, 3\]"), ("cpu", "needs CUDA tensors"),
])
def test_kernel_entry_raises(what, match):
    """No silent fallback: the kernel's entry refuses what it does not
    take before it builds anything (CPU tensors included)."""
    launches = hull_cuda.clsc_launches
    with pytest.raises(ValueError, match=match):
        hull_cuda.build_clsc_cuda(**_bad(what), world_dimension=2)
    assert hull_cuda.clsc_launches == launches


# ---- on the card ------------------------------------------------------------
@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def kernel_vs_plain(x, dim, dev):
    """The kernel (through the dispatch: one launch, no hull query of its
    own) and the plain body on the card: (kernel, plain) as numpy."""
    t = {k: torch.as_tensor(v).to(dev) for k, v in x.items()}
    launches, hulls = hull_cuda.clsc_launches, hull_cuda.launches
    rt = hull_cuda.rt_launches["clsc_build"]
    got = lsc.build_clsc(**t, world_dimension=dim)
    got = (got.normals, got.anchors, got.margins)
    torch.cuda.synchronize()
    assert hull_cuda.clsc_launches == launches + (t["obs_ctrl"].numel() > 0)
    assert hull_cuda.launches == hulls
    A, O, M, N = t["obs_ctrl"].shape[:4]
    if t["obs_ctrl"].numel():  # the run-time build takes N > 8 and stages past 48 KB
        took_rt = hull_cuda.clsc_build_plan(A, O, M, N)[0]
        assert hull_cuda.rt_launches["clsc_build"] - rt == took_rt
    want = lsc.build_clsc(**t, world_dimension=dim, plain=True)
    return (tuple(g.cpu().numpy() for g in got),
            tuple(getattr(want, n).cpu().numpy() for n in ("normals", "anchors", "margins")))


@pytest.mark.cuda
@pytest.mark.parametrize("what", CASES)
def test_kernel_equals_plain_on_card(cuda_dev, what):
    """The kernel equals the plain body on the card and the CPU's (the
    twin's), bit for bit by value."""
    x, dim = named_inputs(what)
    got, want = kernel_vs_plain(x, dim, cuda_dev)
    assert_equal_by_value(got, want)
    assert_equal_by_value(got, plain(x, dim))


@pytest.mark.cuda
@pytest.mark.parametrize("N", range(1, 17))
@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_each_N(cuda_dev, dim, N):
    """Every template build (N = 1..8 control points a segment) and the
    run-time build at N = 9..16, M = 1 (the last segment alone) and M = 10."""
    for M in (1, 10):
        assert hull_cuda.clsc_build_plan(7, 5, M, N)[0] == (N > 8)
        x = clsc_inputs(30 + N, dim, A=7, O=5, M=M, N=N)
        got, want = kernel_vs_plain(x, dim, cuda_dev)
        assert_equal_by_value(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("A,O,M,N", [(7, 5, 10, 16), (3, 1, 300, 6), (2, 2, 90, 12)])
def test_kernel_stage_past_48kb(cuda_dev, A, O, M, N):
    """Shapes whose stage passes 48 KB of shared memory a block (N = 16;
    a template N whose initial points pass it at M = 300) take the
    run-time build, opted in to the shared memory they need, and equal
    the plain body."""
    rt, smem = hull_cuda.clsc_build_plan(A, O, M, N)
    assert rt == 1 and 48 * 1024 < smem <= hull_cuda.build().hull_max_smem(), smem
    for dim in (2, 3):
        x = clsc_inputs(40 + N, dim, A=A, O=O, M=M, N=N)
        got, want = kernel_vs_plain(x, dim, cuda_dev)
        assert_equal_by_value(got, want)


@pytest.mark.cuda
def test_kernel_refuses_a_stage_past_the_card(cuda_dev):
    """A stage past the 227 KB a block may take (600 segments of 16
    points) is the one shape the kernel refuses, and the message says why;
    nothing is launched."""
    rt, smem = hull_cuda.clsc_build_plan(2, 1, 600, 16)
    assert rt == 1 and smem > hull_cuda.build().hull_max_smem()
    t = {k: torch.as_tensor(v).to(cuda_dev)
         for k, v in clsc_inputs(0, 3, A=2, O=1, M=600, N=16).items()}
    launches = hull_cuda.clsc_launches
    with pytest.raises(ValueError, match=f"needs {smem} B of shared memory a block, past"):
        lsc.build_clsc(**t, world_dimension=3)
    assert hull_cuda.clsc_launches == launches


@pytest.mark.cuda
def test_kernel_empty_batch(cuda_dev):
    """No agent, or no neighbour slot: empty outputs, no launch."""
    for A, O in ((0, 4), (3, 0)):
        x = {k: v[:A] for k, v in clsc_inputs(5, 3).items()}
        x = {k: (v[:, :O] if v.ndim > 1 and k not in ("initial_ctrl", "current_goal") else v)
             for k, v in x.items()}
        t = {k: torch.as_tensor(v).to(cuda_dev) for k, v in x.items()}
        launches = hull_cuda.clsc_launches
        s = lsc.build_clsc(**t, world_dimension=3)
        assert hull_cuda.clsc_launches == launches
        assert s.normals.shape == (A, O, 10, 3) and s.anchors.shape == (A, O, 10, 6, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_on_main_path_inputs(cuda_dev, dim):
    """build_clsc's inputs on `build_fleet(1024)` on the card after three
    evolving steps (163,840 hulls)."""
    x, d = fleet_inputs(1024, 3, dim, "cuda")
    got, want = kernel_vs_plain(x, d, cuda_dev)
    assert_equal_by_value(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_on_degree_8_inputs(cuda_dev, dim):
    """build_clsc's inputs on `build_fleet(1024, n=8)` on the card after
    two evolving steps (163,840 hulls of 9 points: the run-time build)."""
    x, d = fleet_inputs(1024, 2, dim, "cuda", n=8)
    assert x["obs_ctrl"].shape[1:] == (16, 10, 9, 3)
    got, want = kernel_vs_plain(x, d, cuda_dev)
    assert_equal_by_value(got, want)
