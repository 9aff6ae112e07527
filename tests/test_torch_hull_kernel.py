"""The hull enumeration kernel (csrc/hull_closest.cu, ops/hull_cuda.py) and
its dispatch in ops/geometry.py::closest_point_origin_to_hull.

On the CPU: CPU tensors take the plain enumeration, the kernel's entry
raises on them, and a scalar float32 twin of the kernel's thread (one
hull at a time, the kernel's order of candidates and of operations) is
held to the plain enumeration bit for bit, on degenerate hulls and on
hulls sampled from the CLSC inputs of an evolving fleet, for K = 2, 3, 6
and 8 (the template builds) and 9, 10 and 12 (the run-time build, whose
loops run in the same order; the hulls from a fleet of degree 8, N = 9;
its per-hull flat test on a block of mixed flat and 3-D hulls);
the plain enumeration is held to the JAX package's at 1e-5. The `cuda`
tests hold the kernel to the plain enumeration on the card, bit for bit,
for every K from 1 to 16; they import neither jax nor the JAX package, so on the GPU
machine they run with `python -m pytest --noconftest -m cuda
tests/test_torch_hull_kernel.py` (tests/conftest.py imports jax).
"""

import functools

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu_torch.ops import geometry, hull_cuda, lsc

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

F = np.float32
EPS, VOL_EPS = F(1e-12), F(1e-10)  # geometry.py's clamps, as torch casts them to float32
ATOL = 1e-5  # against the JAX package: the order of its 3-term sums is XLA's
KS = [2, 3, 6, 8, 9, 10, 12]
RT_KS = [9, 10, 12]  # the run-time build's (K > 8)
SAMPLES = 512


# ---- the kernel's thread, in Python -----------------------------------------
def _dot3(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _axpy(a, t, d):
    return (a[0] + t * d[0], a[1] + t * d[1], a[2] + t * d[2])


def _fms(a, b, c, d):
    """a·b − c·d, c·d rounded, a·b not (float64), the difference rounded
    in float64, then to float32."""
    return F(np.float64(a) * np.float64(b) - np.float64(c * d))


def _cross(u, v):
    return (_fms(u[1], v[2], u[2], v[1]), _fms(u[2], v[0], u[0], v[2]),
            _fms(u[0], v[1], u[1], v[0]))


def _clamp_min(x, lo):
    return x if np.isnan(x) else max(x, lo)


def _ratio01(t, den):
    r = t / _clamp_min(den, EPS)
    return r if np.isnan(r) else min(max(r, F(0)), F(1))


def _segment(a, b):
    ab = _sub(b, a)
    denom = _dot3(ab, ab)
    pa = _sub((F(0),) * 3, a)
    t = F(0) if denom <= EPS else _ratio01(_dot3(pa, ab), denom)
    return _axpy(a, t, ab)


def _triangle(a, b, c):
    ab, ac = _sub(b, a), _sub(c, a)
    ap, bp, cp = ((-x[0], -x[1], -x[2]) for x in (a, b, c))
    d1, d2 = _dot3(ab, ap), _dot3(ac, ap)
    d3, d4 = _dot3(ab, bp), _dot3(ac, bp)
    d5, d6 = _dot3(ab, cp), _dot3(ac, cp)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    d43, d56 = d4 - d3, d5 - d6
    if d1 <= 0 and d2 <= 0:
        return a
    if d3 >= 0 and d4 <= d3:
        return b
    if d6 >= 0 and d5 <= d6:
        return c
    if vc <= 0 and d1 >= 0 and d3 <= 0:
        return _axpy(a, _ratio01(d1, d1 - d3), ab)
    if vb <= 0 and d2 >= 0 and d6 <= 0:
        return _axpy(a, _ratio01(d2, d2 - d6), ac)
    if va <= 0 and d43 >= 0 and d56 >= 0:
        return _axpy(b, _ratio01(d43, d43 + d56), _sub(c, b))
    denom = _clamp_min((va + vb) + vc, EPS)
    return _axpy(_axpy(a, vb / denom, ab), vc / denom, ac)


def _signed_vol(p0, p1, p2, p3):
    return _dot3(_sub(p1, p0), _cross(_sub(p2, p0), _sub(p3, p0)))


def _in_tetra(a, b, c, d):
    o = (F(0),) * 3
    v0 = _signed_vol(a, b, c, d)
    if not abs(v0) > VOL_EPS:
        return False
    vs = (_signed_vol(o, b, c, d), _signed_vol(a, o, c, d), _signed_vol(a, b, o, d),
          _signed_vol(a, b, c, o))
    return all(v >= -VOL_EPS for v in vs) if v0 > 0 else all(v <= VOL_EPS for v in vs)


def flat(points):
    """flat_hull: every point's z is ±0 (a NaN z is not)."""
    return all(F(row[2]) == 0 for row in points)


def twin_hull(points, skip_flat=False):
    """The kernel's thread for one hull ([K, 3] float32): (closest [3],
    dist). skip_flat (the run-time build's): no tetrahedron tested where
    the hull is flat."""
    p = [tuple(F(v) for v in row) for row in points]
    K = len(p)
    best, bd = p[0], _dot3(p[0], p[0])

    def consider(q):
        nonlocal best, bd
        d = _dot3(q, q)
        if d < bd or (np.isnan(d) and not np.isnan(bd)):  # torch.argmin's NaN rule
            best, bd = q, d

    for i in range(1, K):
        consider(p[i])
    for i in range(K):
        for j in range(i + 1, K):
            consider(_segment(p[i], p[j]))
    for i in range(K):
        for j in range(i + 1, K):
            for k in range(j + 1, K):
                consider(_triangle(p[i], p[j], p[k]))
    if skip_flat and flat(points):
        return np.asarray(best, F), np.sqrt(bd)
    for i in range(K):
        for j in range(i + 1, K):
            for k in range(j + 1, K):
                for m in range(k + 1, K):
                    if _in_tetra(p[i], p[j], p[k], p[m]):
                        return np.zeros(3, F), F(0)
    return np.asarray(best, F), np.sqrt(bd)


def twin(points, skip_flat=False):
    """twin_hull over [H, K, 3]: (closest [H, 3], dist [H])."""
    with np.errstate(all="ignore"):  # NaN and infinite hulls
        out = [twin_hull(h, skip_flat) for h in points]
    return np.stack([c for c, _ in out]), np.asarray([d for _, d in out], F)


# ---- inputs -------------------------------------------------------------------
def f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def hull_cases():
    """The hull cases of this file and of tests/test_torch_ops.py (which
    imports them: this file imports no jax at the top, so the card runs
    it too)."""
    rng = np.random.default_rng(2)
    generic = f32(rng, 64, 6, 3)
    interior = f32(rng, 16, 6, 3) + 0.0  # clouds around the origin
    planar = f32(rng, 32, 6, 3)
    planar[..., 2] = 0.6  # 2-D: every hull is planar, triangles and edges tie
    offset = f32(rng, 32, 6, 3, scale=0.3) + np.array([1.0, -0.5, 0.2], np.float32)
    point = np.repeat(f32(rng, 8, 1, 3), 6, axis=1)  # all six points equal
    line = (f32(rng, 8, 1, 3) + np.linspace(0, 1, 6, dtype=np.float32)[None, :, None]
            * f32(rng, 8, 1, 3))  # collinear
    return {"generic": generic, "interior": interior, "planar": planar,
            "offset": offset, "point": point, "line": line}


CASES = list(hull_cases())


def nonfinite_hulls():
    """Hulls with a NaN or an infinite coordinate (what a diverged QP
    would hand the query), among finite ones: the candidate of NaN norm
    wins the minimum, the first such one, as in torch.argmin."""
    rng = np.random.default_rng(3)
    pts = f32(rng, 48, 6, 3)
    pts[16:32, :, 2] = 0.0  # planar
    for h in range(0, 48, 2):
        pts[h, h % 6, h % 3] = np.nan
    for h in range(1, 48, 4):
        pts[h, (h + 1) % 6, (h + 2) % 3] = np.inf if h % 8 == 1 else -np.inf
    pts[45] = np.nan  # every coordinate
    return pts


@functools.lru_cache(maxsize=None)
def clsc_rel(A=32, steps=2, device="cpu", **over):
    """The hull query's input of build_clsc ([A, O, M, N, 3]) on
    `workload.build_fleet(A, **over)` after `steps` evolving steps, as
    numpy (the step's build_clsc runs its plain body, which queries the
    hulls on their own; on the card the fused kernel queries them inside)."""
    from lsc_dr_planner_tpu_torch import workload

    p, planner, fleet, inp = workload.build_fleet(A, device=device, **over)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(steps):
        inp, _ = step(inp)
    seen = []
    query, build = geometry.closest_point_origin_to_hull, lsc.build_clsc

    def record(points, **k):
        seen.append(points.cpu().numpy())
        return query(points, **k)

    geometry.closest_point_origin_to_hull = record
    lsc.build_clsc = functools.partial(build, plain=True)
    try:
        planner._step_impl(fleet, inp)
    finally:
        geometry.closest_point_origin_to_hull, lsc.build_clsc = query, build
    (rel,) = seen
    return rel


def clsc_hulls(K, n=SAMPLES, seed=0):
    """n hulls of K points sampled from build_clsc's input: up to K = 8
    on the bench fleet (6 points a hull), from K = 9 on a fleet of degree
    8 (9 points a hull): the first K of a hull's points, or all of them
    and the next hull's first (K = 8: 6 and 2; K = 10, 12: 9 and 1, 3)."""
    rel = clsc_rel(n=8) if K > 8 else clsc_rel()
    flat = rel.reshape(-1, rel.shape[-2], 3)
    idx = np.random.default_rng(seed).choice(len(flat) - 1, n, replace=False)
    if K <= flat.shape[1]:
        return np.ascontiguousarray(flat[idx, :K])
    return np.concatenate([flat[idx], flat[idx + 1, :K - flat.shape[1]]], axis=1)


def degenerate_hulls(K, H, seed=None):
    """H hulls of K points (seed 10 + K by default): generic, planar (the
    first quarter), coincident, collinear and tiny (an eighth each)."""
    rng = np.random.default_rng(10 + K if seed is None else seed)
    pts = f32(rng, H, K, 3)
    q, e = H // 4, H // 8
    pts[:q, :, 2] = 0.0  # planar
    pts[q:q + e] = pts[q:q + e, :1]  # coincident
    pts[q + e:2 * q] = (pts[q + e:2 * q, :1] + np.linspace(0, 1, K, dtype=F)[None, :, None]
                        * f32(rng, e, 1, 3))  # collinear
    pts[2 * q:2 * q + e] *= 0.01  # tiny hulls
    return pts


def plain(points):
    """The plain enumeration on the CPU, as numpy."""
    c, d = geometry.closest_point_origin_to_hull(torch.as_tensor(points), plain=True)
    return c.numpy(), d.numpy()


def assert_equal_by_value(got, want):
    """Equal values (−0.0 equals +0.0, a NaN equals a NaN)."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---- on the CPU -------------------------------------------------------------
@pytest.mark.parametrize("case", [*CASES, "nonfinite"])
def test_twin_equals_plain_on_cases(case):
    pts = named_hulls(case)
    assert_equal_by_value(twin(pts), plain(pts))


@pytest.mark.parametrize("K", KS)
def test_twin_equals_plain_on_clsc_hulls(K):
    """512 hulls of an evolving 32-agent fleet's CLSC (2-D: every hull
    planar, z = 0), bit for bit."""
    pts = clsc_hulls(K)
    assert pts.shape == (SAMPLES, K, 3) and not pts[..., 2].any()
    assert_equal_by_value(twin(pts), plain(pts))


@pytest.mark.parametrize("K", RT_KS)
def test_twin_equals_plain_on_degenerate_hulls(K):
    """The run-time build's K: generic, planar, coincident, collinear,
    tiny and origin-holding hulls, and hulls with a NaN or an infinite
    coordinate, bit for bit."""
    pts = degenerate_hulls(K, 256)
    pts[::16, 1, 0] = np.nan
    pts[5::32, K - 1, 2] = np.inf
    pts[7::32, 0, 1] = -np.inf
    c, d = plain(pts)
    assert (d == 0).any() and (d > 0).any() and np.isnan(d).any()
    assert_equal_by_value(twin(pts), (c, d))


def mixed_block(K, H=128, seed=None):
    """One block of the run-time build (H hulls of K points): flat hulls at
    z = +0 and at z = −0 (some with both), 3-D hulls, some holding the
    origin, a flat hull with one NaN z (not flat) and a 3-D hull with one;
    the flat and 3-D hulls interleaved."""
    rng = np.random.default_rng(30 + K if seed is None else seed)
    pts = f32(rng, H, K, 3)
    pts[0::4, :, 2] = 0.0
    pts[1::4, :, 2] = -0.0
    pts[2::8, ::2, 2] = -0.0  # z = +0 and −0 in one hull
    pts[2::8, 1::2, 2] = 0.0
    pts[3::8] *= 0.05  # 3-D, tiny: around the origin
    pts[5::16, 0, 2] = np.nan  # flat but for a NaN z
    pts[7::16, 1, 2] = np.nan  # 3-D with a NaN z
    return pts


def named_hulls(what):
    """A case of hull_cases(), nonfinite: nonfinite_hulls(), or
    clsc_K<K>: clsc_hulls(K)."""
    if what in CASES:
        return hull_cases()[what]
    if what == "nonfinite":
        return nonfinite_hulls()
    return clsc_hulls(int(what.split("K")[1]))


@pytest.mark.parametrize("K", RT_KS)
def test_rt_twin_skips_flat_hulls(K):
    """The run-time build's per-hull flat test: on a block of mixed flat
    (z = ±0) and 3-D hulls, with NaN z, the twin that tests no
    tetrahedron where a hull is flat equals the plain enumeration (and
    the twin that tests them all) bit for bit."""
    pts = mixed_block(K)
    flats = np.array([flat(h) for h in pts])
    assert 0 < flats.sum() < len(pts) and not flats[5::16].any()
    want = plain(pts)
    assert (want[1][~flats] == 0).any() and np.isnan(want[1]).any()
    assert_equal_by_value(twin(pts, skip_flat=True), want)
    assert_equal_by_value(twin(pts), want)


@pytest.mark.parametrize("K", KS)
def test_plain_matches_jax_on_clsc_hulls(K):
    """(tests/test_torch_ops.py holds it to JAX on hull_cases().)"""
    import jax.numpy as jnp

    from lsc_dr_planner_tpu.ops import geometry as jgeo

    pts = clsc_hulls(K)
    bt, dt = plain(pts)
    bj, dj = jgeo.closest_point_origin_to_hull(jnp.asarray(pts))
    np.testing.assert_allclose(dt, np.asarray(dj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(bt, np.asarray(bj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("what", ["cases", "clsc", "nonfinite"])
def test_twin_is_odd(what):
    """points → −points mirrors the closest point exactly (reciprocal
    pairs get mirrored normals)."""
    pts = {"cases": lambda: np.concatenate(list(hull_cases().values())),
           "clsc": lambda: clsc_hulls(6, n=128, seed=1), "nonfinite": nonfinite_hulls}[what]()
    c, d = twin(pts)
    cn, dn = twin(-pts)
    assert_equal_by_value((cn, dn), (-c, d))


def test_cpu_tensors_take_the_plain_enumeration():
    """CPU tensors run the plain enumeration: no kernel launch, no count
    of plain runs on CUDA; plain=True gives the same result."""
    pts = torch.as_tensor(hull_cases()["generic"])
    launches, plain_cuda = hull_cuda.launches, geometry.plain_cuda_calls
    got = geometry.closest_point_origin_to_hull(pts)
    again = geometry.closest_point_origin_to_hull(pts, plain=True)
    want = geometry.closest_point_origin_to_hull_plain(pts)
    assert hull_cuda.launches == launches and geometry.plain_cuda_calls == plain_cuda
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert got[0].shape == (64, 3) and got[1].shape == (64,)


def test_other_devices_raise():
    with pytest.raises(ValueError, match="no hull query for device meta"):
        geometry.closest_point_origin_to_hull(torch.empty(4, 6, 3, device="meta"))


@pytest.mark.parametrize("bad,match", [
    (lambda: torch.zeros(4, 6, 3, dtype=torch.float64), "need float32"),
    (lambda: torch.zeros(6, 4, 3).transpose(0, 1), "not contiguous"),
    (lambda: torch.zeros(3), r"\[\.\.\., K, 3\] with K >= 1"),
    (lambda: torch.zeros(4, 0, 3), "K >= 1"),
    (lambda: torch.zeros(4, 6, 2), r"\[\.\.\., K, 3\]"),
    (lambda: torch.zeros(4, 6, 3), "needs CUDA tensors"),
], ids=["float64", "non_contiguous", "rank1", "K0", "2d_points", "cpu"])
def test_kernel_entry_raises(bad, match):
    """No silent fallback: the kernel's entry refuses what it does not
    take before it builds anything."""
    launches = hull_cuda.launches
    with pytest.raises(ValueError, match=match):
        hull_cuda.closest_point_origin_to_hull_cuda(bad())
    assert hull_cuda.launches == launches


def lsc_inputs(seed, device="cpu", A=6, O=5, M=10, N=6):
    """Inputs of build_lsc and build_clsc: neighbours near each agent,
    both in 3-D (z spread), some slots masked."""
    rng = np.random.default_rng(seed)
    init = f32(rng, A, M, N, 3)
    obs = init[:, None] + 0.8 + f32(rng, A, O, M, N, 3, scale=0.5)
    common = dict(
        initial_ctrl=init, obs_ctrl=obs, agent_radius=np.full(A, 0.15, F),
        agent_downwash=np.full(A, 2.0, F), obs_radius=np.full((A, O), 0.15, F),
        obs_downwash=np.full((A, O), 2.0, F), obs_is_agent=rng.uniform(size=(A, O)) < 0.8,
        current_goal=f32(rng, A, 3), obs_mask=rng.uniform(size=(A, O)) < 0.7)
    only_lsc = dict(obs_pred_sizes=np.abs(f32(rng, A, O, M, N, scale=0.1)) + 0.15,
                    obs_position=f32(rng, A, O, 3))
    only_clsc = dict(obs_goal=f32(rng, A, O, 3))
    return {name: {k: torch.as_tensor(v).to(device) for k, v in {**common, **only}.items()}
            for name, only in (("build_lsc", only_lsc), ("build_clsc", only_clsc))}


@pytest.mark.parametrize("build", ["build_lsc", "build_clsc"])
def test_lsc_constructions_pass_contiguous_rel(monkeypatch, build):
    """build_lsc and build_clsc give the hull query a contiguous float32 [A, O, M, N,
    3], which the kernel takes as it is (no copy in the wrapper)."""
    seen = []
    query = geometry.closest_point_origin_to_hull

    def record(points, **k):
        seen.append(points)
        return query(points, **k)

    monkeypatch.setattr(geometry, "closest_point_origin_to_hull", record)
    kw = lsc_inputs(0)[build]
    extra = {"world_dimension": 3} if build == "build_clsc" else {}
    getattr(lsc, build)(**kw, **extra)
    (rel,) = seen
    assert rel.shape == kw["obs_ctrl"].shape and rel.dtype == torch.float32
    assert rel.is_contiguous()


# ---- on the card ------------------------------------------------------------
@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def kernel_vs_plain(points, dev):
    """The kernel (through the dispatch: one launch) and the plain
    enumeration on the card on the same hulls: (kernel, plain) as numpy."""
    x = torch.as_tensor(points).to(dev)
    launches, rt = hull_cuda.launches, hull_cuda.rt_launches["hull_closest"]
    got = geometry.closest_point_origin_to_hull(x)
    torch.cuda.synchronize()
    assert hull_cuda.launches == launches + (x.numel() > 0)
    # the run-time build takes K > 8
    assert hull_cuda.rt_launches["hull_closest"] == rt + (x.numel() > 0 and x.shape[-2] > 8)
    want = geometry.closest_point_origin_to_hull(x, plain=True)
    return tuple(t.cpu().numpy() for t in got), tuple(t.cpu().numpy() for t in want)


@pytest.mark.cuda
@pytest.mark.parametrize("what", [*CASES, "nonfinite", *(f"clsc_K{K}" for K in KS)])
def test_kernel_equals_plain_on_card(cuda_dev, what):
    """The kernel equals the plain enumeration on the card and the twin
    (the CPU's plain enumeration), bit for bit by value, and is odd."""
    pts = named_hulls(what)
    got, want = kernel_vs_plain(pts, cuda_dev)
    assert_equal_by_value(got, want)
    assert_equal_by_value(got, plain(pts))
    neg, _ = kernel_vs_plain(-pts, cuda_dev)
    assert_equal_by_value(neg, (-got[0], got[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("K", range(1, 17))
def test_kernel_each_K(cuda_dev, K):
    """Every template build (K = 1..8) and the run-time build at K = 9..16,
    on generic, planar, coincident, collinear and origin-holding hulls of
    K points."""
    pts = degenerate_hulls(K, 4096)
    got, want = kernel_vs_plain(pts, cuda_dev)
    assert_equal_by_value(got, want)
    neg, _ = kernel_vs_plain(-pts, cuda_dev)
    assert_equal_by_value(neg, (-got[0], got[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [9, 10, 12, 16])
def test_rt_kernel_on_mixed_flat_and_3d_hulls(cuda_dev, K):
    """The run-time build on 32 blocks of mixed flat and 3-D hulls (its
    per-hull flat test), NaN z among them, equals the plain enumeration
    (and the twin on the first block), and is odd."""
    pts = np.concatenate([mixed_block(K, seed=100 * K + b) for b in range(32)])
    got, want = kernel_vs_plain(pts, cuda_dev)
    assert_equal_by_value(got, want)
    assert_equal_by_value((got[0][:128], got[1][:128]), twin(pts[:128], skip_flat=True))
    neg, _ = kernel_vs_plain(-pts, cuda_dev)
    assert_equal_by_value(neg, (-got[0], got[1]))


@pytest.mark.cuda
def test_kernel_at_mc_pod_size(cuda_dev):
    """H = 1,310,720 hulls (mc_pod_bench's 8,192 agents × 16 slots × 10
    segments): 64-bit offsets, the last hull written."""
    H = 8192 * 16 * 10
    rng = np.random.default_rng(20)
    pts = f32(rng, H, 6, 3)
    pts[::2, :, 2] = 0.0
    got, want = kernel_vs_plain(pts, cuda_dev)
    assert_equal_by_value(got, want)
    assert_equal_by_value((got[0][-3:], got[1][-3:]), twin(pts[-3:]))


@pytest.mark.cuda
def test_kernel_on_main_path_clsc(cuda_dev):
    """The hull query of build_clsc on `build_fleet(1024)` on the card
    after three evolving steps (163,840 hulls)."""
    rel = clsc_rel(1024, 3, "cuda")
    assert rel.shape[0] * rel.shape[1] * rel.shape[2] == 163840
    got, want = kernel_vs_plain(rel, cuda_dev)
    assert_equal_by_value(got, want)


@pytest.mark.cuda
def test_kernel_on_degree_8_clsc(cuda_dev):
    """The hull query of build_clsc on `build_fleet(1024, n=8)` on the card
    after two evolving steps (163,840 hulls of 9 points: the run-time
    build)."""
    rel = clsc_rel(1024, 2, "cuda", n=8)
    assert rel.shape[1:] == (16, 10, 9, 3)
    got, want = kernel_vs_plain(rel, cuda_dev)
    assert_equal_by_value(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("build", ["build_lsc", "build_clsc"])
@pytest.mark.parametrize("dim", [2, 3])
def test_lsc_constructions_on_card_equal_plain(cuda_dev, monkeypatch, build, dim):
    """build_lsc on the card launches the hull kernel once, build_clsc
    the fused CLSC kernel (which queries the hulls inside) once; each
    equals its run with the plain enumeration (build_clsc: its plain
    body)."""
    kw = lsc_inputs(dim, cuda_dev)[build]
    if dim == 2:
        for name in ("initial_ctrl", "obs_ctrl"):
            kw[name][..., 2] = 0.6
    extra = {"world_dimension": dim} if build == "build_clsc" else {}
    launches = (hull_cuda.launches, hull_cuda.clsc_launches)
    got = getattr(lsc, build)(**kw, **extra)
    torch.cuda.synchronize()
    fused = build == "build_clsc"
    assert (hull_cuda.launches, hull_cuda.clsc_launches) == (launches[0] + (not fused),
                                                             launches[1] + fused)
    monkeypatch.setattr(geometry, "closest_point_origin_to_hull",
                        functools.partial(geometry.closest_point_origin_to_hull, plain=True))
    want = getattr(lsc, build)(**kw, **extra, **({"plain": True} if fused else {}))
    for name in ("normals", "anchors", "margins"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
