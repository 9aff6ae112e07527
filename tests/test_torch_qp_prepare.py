"""The QP preparation (`qp.prepare`) on the CPU: its plain body against the
JAX package's pre-loop body of `solve`, and a Python twin of the CUDA
kernel's arithmetic (csrc/qp_prepare.cu) against the plain body.

The kernel runs only on the card (tests/test_torch_qp_prepare_kernel.py
and chip_smoke.py hold it to the plain body there). Here the twin repeats
what each of its blocks computes for one agent: the row index decoding
of constraint_bounds's flat order, the Kronecker assembly of the KKT
matrix by index arithmetic, and its inverse in double as the kernel's
tiles of 8 take it (the padding, the panels of the L·D·Lᵀ factor, the
block inverse of L and the tile order of the product Wᵀ·D⁻¹·W). Inputs are made from numpy seeds: a few agents (A ≤ 16), O ≤ 4
neighbour slots, 2-D and 3-D, comm rows on and off, warm and cold duals.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu.ops import qp as jqp
from lsc_dr_planner_tpu_torch.ops import qp, qp_check, qp_prepare_cuda
from tests.test_torch_qp import capture_jax_loop_inputs

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

CPU = torch.device("cpu")


def qp_cfg(dim=2, use_comm=True, n_obs=4, sigma=1e-6, stop_at_horizon=True, M=10):
    """The bench QP configuration (`Param` defaults, M=10, n=5) with O slots."""
    return qp.QPConfig(dim=dim, M=M, n=5, phi=3, n_obs=n_obs, use_comm=use_comm,
                       stop_at_horizon=stop_at_horizon, dt=0.2, control_input_weight=0.01,
                       terminal_weight=1.0, rho=1.0, sigma=sigma, alpha=1.6, max_iter=200,
                       eps_abs=1e-3, rescue_iter=800)


def jax_cfg(cfg):
    return jqp.QPConfig(**dataclasses.asdict(cfg), rho_eq=1.0)


def random_inputs(cfg, A, seed, warm):
    """QP inputs of A agents from a numpy seed, shaped as the pipeline's:
    positions within 20 m of the origin, unit normals with a masked slot,
    LSC rows active where the slot is, the first segment's pinned points
    inactive, world-sized bounds, a warm start near the agent, and duals
    when `warm`. Returns numpy arrays by field."""
    rng = np.random.default_rng(seed)
    dim, O, M, N = cfg.dim, cfg.n_obs, cfg.M, cfg.N
    R = qp.n_rows(cfg)
    f32 = np.float32
    p0 = rng.uniform(-20, 20, (A, dim))
    nrm = rng.standard_normal((A, O, M, dim))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mask = rng.random((A, O)) < 0.8
    nrm *= mask[..., None, None]
    active = np.broadcast_to(mask[..., None, None], (A, O, M, N)).copy()
    active &= rng.random((A, O, M, N)) < 0.9
    active[:, :, 0, :cfg.phi] = False
    tmask = (np.arange(M) >= rng.integers(1, M, A)[:, None]).astype(f32)
    centre = p0[:, :, None, None]
    out = dict(
        p0=p0, v0=rng.uniform(-1, 1, (A, dim)), a0=rng.uniform(-2, 2, (A, dim)),
        goal=p0 + rng.uniform(-3, 3, (A, dim)), terminal_mask=tmask, lsc_normals=nrm,
        lsc_rhs=rng.uniform(-2, 2, (A, O, M, N)), lsc_active=active,
        vmax=rng.uniform(1, 3, (A, dim)), amax=rng.uniform(2, 5, (A, dim)),
        lb=np.broadcast_to(centre - rng.uniform(2, 6, (A, dim, M, N)), (A, dim, M, N)),
        ub=np.broadcast_to(centre + rng.uniform(2, 6, (A, dim, M, N)), (A, dim, M, N)),
        comm_halfrange=rng.uniform(1, 2, A) if cfg.use_comm else np.full(A, 1e19),
        x0=centre + rng.uniform(-1, 1, (A, dim, M, N)),
        y0=rng.standard_normal((A, R)) if warm else None)
    return {k: (v if v is None or v.dtype == bool else np.ascontiguousarray(v, dtype=f32))
            for k, v in out.items()}


def port_inputs(arrays):
    return qp.QPInputs(**{k: None if v is None else torch.as_tensor(v)
                          for k, v in arrays.items()})


# ----------------------------------------------------------------------
# the kernel's arithmetic, one agent, in numpy
# ----------------------------------------------------------------------


def twin(cfg, inp, a):
    """Agent a's preparation as a block of csrc/qp_prepare.cu computes it:
    the plain body's float32 operations for the elementwise outputs; every
    sum in float32 in the CPU einsums' order (`fsum`: a chain of fused
    multiply-adds from 0, emulated in float64; `lsum`: a product, then an
    addition, a term); the rows decoded from their flat index; the KKT matrix assembled entry by
    entry (row d·K + k, column e·K + l), then inverted in float64 as the
    kernel does (`blocked_inverse`). Returns ({field: array}, Kmat
    float64, info)."""
    ts = qp.torch_statics(cfg, CPU)
    st = {k: v.numpy() for k, v in ts["stencil"].items()}
    f32 = np.float32
    sc = {k: f32(v) for k, v in qp.prepare_scalars(cfg).items()}
    dim, O, M, N, K = cfg.dim, cfg.n_obs, cfg.M, cfg.N, ts["K"]
    n, MN, dk = N - 1, M * N, dim * K
    R_lsc, R_stat = O * MN, len(st["idx"])
    nv, na, nc = M * n, M * (n - 1), (M * (M + 1) // 2 if cfg.use_comm else 0)
    S_ = {k: ts[k].numpy() for k in (
        "X_pin", "P_blk", "N_null", "N3k", "Pn_base", "T_term", "G_stat", "T_lsc", "An_stat")}

    def g(name):
        return getattr(inp, name)[a].numpy()

    def lsum(terms):  # float32 products, added left to right
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        return acc

    def fsum(pairs):  # fused multiply-adds from 0, left to right (float64 emulation)
        acc = np.float64(0)
        for x, y in pairs:
            acc = (np.float64(x) * np.float64(y) + acc).astype(f32).astype(np.float64)
        return acc.astype(f32)

    nrm = g("lsc_normals")  # [O, M, dim]
    p, v, acc = g("p0"), g("v0"), g("a0")
    c1 = p + v * sc["vel"]
    pins = np.stack([p, c1, (acc * sc["acc"] + f32(2) * c1) - p], axis=-1)  # [dim, 3]
    td = sc["tdiag"] * g("terminal_mask")
    xp = fsum([(S_["X_pin"][:, q], pins[:, q:q + 1]) for q in range(3)])  # [dim, MN]
    term = np.arange(MN) % N == n
    tvec = np.where(term, np.repeat(td, N), f32(0))
    qflat = np.where(term[None], (sc["q"] * np.repeat(g("terminal_mask"), N))[None]
                     * g("goal")[:, None], f32(0))

    out = {k: np.zeros(R_lsc + R_stat, f32) for k in ("l", "u", "b_off")}
    vmax, amax, lb, ub = g("vmax"), g("amax"), g("lb"), g("ub")
    for r in range(R_lsc + R_stat):
        if r < R_lsc:
            o, vv = divmod(r, MN)
            m, i = divmod(vv, N)
            lo = g("lsc_rhs")[o, m, i] if g("lsc_active")[o, m, i] else f32(-1e20)
            hi = f32(1e20)
            boff = lsum([nrm[o, m, d] * xp[d, vv] for d in range(dim)])
        else:
            q = r - R_lsc
            if q < dim * nv:  # velocity cap (d, m, i)
                d, w = divmod(q, nv)
                m, i = divmod(w, n)
                x = xp[d, m * N + i:]
                hi = f32(1e20) if (m == 0 and i < 2) else vmax[d] * sc["vcap"]
                lo, boff = -hi, x[1] - x[0]
            elif (q := q - dim * nv) < dim * na:  # acceleration cap
                d, w = divmod(q, na)
                m, i = divmod(w, n - 1)
                x = xp[d, m * N + i:]
                hi = f32(1e20) if (m == 0 and i == 0) else amax[d] * sc["acap"]
                lo, boff = -hi, (x[2] - f32(2) * x[1]) + x[0]
            elif (q := q - dim * na) < dim * nc:  # comm pair (mi ≤ mm)
                d, p_ = divmod(q, nc)
                mi = 0
                while p_ >= M - mi:
                    p_ -= M - mi
                    mi += 1
                hi = g("comm_halfrange")
                lo, boff = -hi, xp[d, (mi + p_) * N + n] - xp[d, mi * N]
            else:  # variable bound (d, m, i)
                d, vv = divmod(q - dim * nc, MN)
                m, i = divmod(vv, N)
                pin = m == 0 and i < 3
                lo, hi = (f32(-1e20), f32(1e20)) if pin else (lb[d, m, i], ub[d, m, i])
                boff = xp[d, vv]
        out["l"][r], out["u"][r], out["b_off"][r] = lo, hi, boff
    out["ln"], out["un"] = out["l"] - out["b_off"], out["u"] - out["b_off"]
    out["rho"] = ts["kernel_rho"].numpy()
    out["scale"] = np.clip(f32(6) * (f32(0.5) * (out["u"] - out["l"])), f32(0.02), f32(1))

    x4, blk = xp.reshape(dim, M, N), S_["P_blk"]
    pxp = fsum([(blk[:, j], x4[..., j:j + 1]) for j in range(N)]).reshape(dim, MN)
    inner = qflat + (pxp + tvec * xp)
    out["qn"] = fsum([(S_["N_null"][v_], inner[:, v_:v_ + 1]) for v_ in range(MN)])  # [dim, K]
    w = g("x0").reshape(dim, MN) - xp
    xi = fsum([(S_["N_null"][v_], w[:, v_:v_ + 1]) for v_ in range(MN)])  # [dim, K]
    out["xi"] = xi
    # z0 as _fwd: c[o, m, k] = Σ_d n·ξ, the LSC rows Σ_k N3·c, the static rows
    # Σ_k An_stat·ξ over the row's dimension's block
    c = fsum([(nrm[..., d, None], xi[d]) for d in range(dim)])  # [O, M, K]
    N3 = S_["N3k"].T.reshape(M, N, K)
    z_lsc = fsum([(N3[None, :, :, k], c[..., k, None]) for k in range(K)])  # [O, M, N]
    An = S_["An_stat"]
    z_stat = fsum([(An[:, k::K][np.arange(R_stat), st["idx"][:, 0] // MN],
                    xi[st["idx"][:, 0] // MN, k]) for k in range(K)])
    out["z"] = np.concatenate([z_lsc.reshape(-1), z_stat])
    out["y"] = np.zeros(R_lsc + R_stat, f32) if inp.y0 is None else g("y0")
    pn = S_["Pn_base"] + fsum([(td[m], S_["T_term"][m]) for m in range(M)])
    out["Pn"] = pn
    out.update(xpart=xp, tvec=tvec[None], qflat=qflat, normals=nrm)

    # the KKT matrix, entry by entry: G[d, k, e, l] = Σ_m S[m, d, e]·T_lsc[m, k, l]
    S = lsum([nrm[o, :, :, None] * nrm[o, :, None, :] for o in range(O)])  # [M, dim, dim]
    G = fsum([(S[m][:, None, :, None], S_["T_lsc"][m][None, :, None, :]) for m in range(M)])
    Kf = sc["rho_lsc"] * G  # [dim, K, dim, K]
    diag = (pn + S_["G_stat"]) + sc["sigma"] * np.eye(K, dtype=f32)
    for d in range(dim):
        Kf[d, :, d, :] = Kf[d, :, d, :] + diag
    Kmat = Kf.reshape(dk, dk).astype(np.float64)
    out["Kinv"], info = blocked_inverse(Kmat)
    return out, Kmat, info


def blocked_inverse(Kmat):
    """The kernel's double inverse of an SPD matrix of order dk, tile by
    tile: padded to nT tiles of 8 with an identity; K = L·D·Lᵀ by panels
    (the diagonal tile column by column, the panel's rows below it by
    forward substitution, the trailing lower tiles by rank-8 products);
    each diagonal tile's unit lower inverse, a column at a time; W = L⁻¹
    block column by block column from the last (the column times the
    inverted diagonal tile staged, then W[I][J] = −Σ_{K=J+1..I}
    W[I][K]·staged[K]); Kinv = Wᵀ·D⁻¹·W, each lower tile once, K
    ascending, its lower triangle mirrored. Every tile product adds its
    two halves (columns 0-3 and 4-7 of A) in two accumulators, then one to
    the other; within a half the terms add in numpy's order here and in
    the tensor cores' on the card. Returns (Kinv float32, info: 0 or the
    order of the first non-positive pivot, with a NaN Kinv)."""
    dk = Kmat.shape[0]
    nT = -(-dk // 8)
    KM = np.eye(8 * nT)
    KM[:dk, :dk] = np.tril(Kmat)

    def t(I, J):  # tile (I, J), a view
        return KM[8 * I:8 * I + 8, 8 * J:8 * J + 8]

    def w(I, J):  # W's tile (I, J); a diagonal tile holds W's strict lower part
        return np.tril(t(I, J), -1) + np.eye(8) if I == J else t(I, J)

    def halves(a, b):  # a @ b as the kernel's two accumulators take it
        return a[:, :4] @ b[:4], a[:, 4:] @ b[4:]

    invd = np.zeros(8 * nT)
    for p in range(nT):
        T = t(p, p)
        for j in range(8):  # column j keeps L's column times d_j
            if not T[j, j] > 0:
                return np.full((dk, dk), np.nan, np.float32), 8 * p + j + 1
            invd[8 * p + j] = 1.0 / T[j, j]
            col = T[j + 1:, j]
            T[j + 1:, j + 1:] -= np.tril(np.outer(col * invd[8 * p + j], col))
        for I in range(p + 1, nT):  # the panel's rows: L[i][j] = (K[i][j] − Σ_l L[i][l]·T[j][l])/d_j
            R = t(I, p)
            for j in range(8):
                R[:, j] = (R[:, j] - R[:, :j] @ T[j, :j]) * invd[8 * p + j]
        L = np.tril(T, -1) * invd[8 * p:8 * p + 8][None, :] + np.eye(8)
        Wpp = np.eye(8)  # the diagonal tile's unit lower inverse, column c
        for c in range(8):
            for i in range(c + 1, 8):
                Wpp[i, c] = -L[i, c:i] @ Wpp[c:i, c]
        d = np.diag(T).copy()
        for I in range(p + 1, nT):  # the trailing lower tiles
            for J in range(p + 1, I + 1):
                lo, hi = halves(-t(I, p), (t(J, p) * d[None, :]).T)
                t(I, J)[:] = (t(I, J) + lo) + hi
        T[np.tril_indices(8, -1)] = Wpp[np.tril_indices(8, -1)]
    for J in range(nT - 2, -1, -1):
        staged = [sum(halves(t(K, J), w(J, J))) for K in range(J + 1, nT)]
        for I in range(J + 1, nT):
            acc = [np.zeros((8, 8)), np.zeros((8, 8))]
            for K in range(J + 1, I + 1):
                for h, part in enumerate(halves(-w(I, K), staged[K - J - 1])):
                    acc[h] += part
            t(I, J)[:] = acc[0] + acc[1]
    Kinv = np.zeros((8 * nT, 8 * nT))
    for I in range(nT):
        for J in range(I + 1):
            acc = [np.zeros((8, 8)), np.zeros((8, 8))]
            for K in range(I, nT):
                for h, part in enumerate(halves(w(K, I).T, invd[8 * K:8 * K + 8, None] * w(K, J))):
                    acc[h] += part
            tl = acc[0] + acc[1]
            if I == J:
                tl = np.tril(tl) + np.tril(tl, -1).T
            Kinv[8 * I:8 * I + 8, 8 * J:8 * J + 8] = tl
            Kinv[8 * J:8 * J + 8, 8 * I:8 * I + 8] = tl.T
    return Kinv[:dk, :dk].astype(np.float32), 0


def twin_prepared(cfg, inp):
    """The twin over every agent, as a qp.Prepared, the twin's KKT
    matrices [A, dk, dk] (float64) and info."""
    A = inp.p0.shape[0]
    outs, kmats, infos = zip(*(twin(cfg, inp, a) for a in range(A)))
    t = {k: torch.as_tensor(np.stack([o[k] for o in outs])) for k in outs[0]}
    t["qn"] = t["qn"].reshape(A, cfg.dim, -1)
    t["xi"] = t["xi"].reshape(A, cfg.dim, -1)
    t["info"] = torch.tensor(infos, dtype=torch.int32)
    loop = qp.LoopInputs(**{f.name: t[f.name] for f in dataclasses.fields(qp.LoopInputs)})
    pr = qp.Prepared(loop=loop, **{f.name: t[f.name] for f in dataclasses.fields(qp.Prepared)
                                   if f.name != "loop"})
    return pr, torch.as_tensor(np.stack(kmats)), t["info"]


# (dim, use_comm, warm, stop_at_horizon, the segment whose terminal weight is
# made -1e5 on agent 0, or None): 2-D (dim·K 56, 60: seven and eight tile
# rows), 3-D (84, padded to 88), and an indefinite KKT matrix whose first
# non-positive pivot is the 12th, the fourth column of the second panel
TWIN_CASES = [(2, True, True, True, None), (2, False, False, True, None),
              (3, True, False, True, None), (2, True, True, False, None),
              (3, False, True, True, None), (2, True, False, True, 4)]


@pytest.mark.parametrize("dim,use_comm,warm,stop,bad_segment", TWIN_CASES)
def test_twin_matches_plain_body(dim, use_comm, warm, stop, bad_segment):
    """The kernel's arithmetic against the plain body on the CPU: the
    elementwise outputs and copies equal, the sums within
    `qp_check.prepare_tolerances` and equal (the kernel adds in the order of the
    CPU's einsums); the KKT matrix within its float32 assembly's rounding,
    and Kinv within 1e-6 of the float64 inverse of its KKT matrix (the
    plain body's float32 Cholesky: ~1e-3). Where agent 0's KKT matrix is
    indefinite, its info (the first non-positive pivot's order, inside a
    panel) and its NaN Kinv equal the plain body's, and the other agents
    are held as above."""
    cfg = qp_cfg(dim, use_comm, stop_at_horizon=stop)
    arrays = random_inputs(cfg, 3, seed=10 * dim + use_comm, warm=warm)
    if bad_segment is not None:
        arrays["terminal_mask"][0, bad_segment] = -1e5
    _twin_against_plain(cfg, arrays, bad_segment)


def _twin_against_plain(cfg, arrays, bad_segment=None, sums_equal=True):
    """test_twin_matches_plain_body's checks on one batch (the sums equal
    the CPU einsums' only where `sums_equal`; else within tolerance)."""
    dim = cfg.dim
    inp = port_inputs(arrays)
    want = qp.prepare(cfg, inp)
    got, kmat, info = twin_prepared(cfg, inp)
    assert torch.equal(info, want.info), (info, want.info)
    ok = info == 0
    if bad_segment is not None:
        assert int(info[0]) == 12 and (int(info[0]) - 1) % 8 != 0 and ok[1:].all(), info
        assert got.loop.Kinv[0].isnan().all() and want.loop.Kinv[0].isnan().all()
    else:
        assert ok.all(), info
    rec = qp_check.prepare_agreement(cfg, inp, got, want)
    assert all(n == 0 for n in rec["differing"].values()), rec
    assert all(n == 0 for n in rec["vacuous_differing"].values()), rec
    assert all(s <= 1.0 for s in rec["share_of_tolerance"].values()), rec
    # the sums themselves (but z0's static rows in 3-D: there the CPU's
    # product of dim·K = 84 columns adds in an order of its own)
    for name in ("xpart", "b_off", "ln", "un", "qn", "xi", "Pn") + (("z",) if dim == 2 else ()):
        assert not sums_equal or torch.equal(qp_check.field(got, name),
                                             qp_check.field(want, name)), name
    # Kmat: sums of M + 4 float32 terms in the plain body
    plain_k = qp.kkt_matrix(cfg, inp)[0].double()
    assert ((kmat - plain_k).abs() <= 2.0 ** -23 * (cfg.M + 4) * plain_k.abs().amax()).all()
    d_twin = qp_check.kinv_distance(got.loop.Kinv[ok], kmat[ok])
    d_plain = qp_check.kinv_distance(want.loop.Kinv[ok], plain_k[ok])
    assert d_twin.max() < 1e-6 and (d_twin <= torch.clamp(2 * d_plain, min=1e-5)).all(), \
        (d_twin, d_plain)
    assert torch.equal(got.loop.Kinv[ok], got.loop.Kinv[ok].transpose(1, 2))


def test_twin_matches_plain_body_at_the_global_build():
    """The shortest 3-D horizon whose preparation takes the kernel's
    global build (the KKT tiles past shared memory,
    `qp_prepare_cuda.tiles_in_workspace`; dim·K 219 at M = 25): its order
    of sums is the twin's (each tile's operations those of the narrower
    builds), held to the plain body as test_twin_matches_plain_body, but
    for its sums: over 144 control points the CPU's einsums add in an
    order of their own, so they are held to their tolerance alone."""
    M = next(m for m in range(11, 40) if qp_prepare_cuda.tiles_in_workspace(
        3, 4, m, 6, qp.torch_statics(qp_cfg(3, M=m), CPU)["K"]))
    cfg = qp_cfg(3, M=M)
    K = qp.torch_statics(cfg, CPU)["K"]
    assert not qp_prepare_cuda.tiles_in_workspace(
        3, 4, M - 1, 6, qp.torch_statics(qp_cfg(3, M=M - 1), CPU)["K"])
    assert 3 * K > 200, (M, K)
    _twin_against_plain(cfg, random_inputs(cfg, 2, seed=19, warm=True), sums_equal=False)


def test_twin_and_plain_body_give_nan_for_an_indefinite_kkt_matrix():
    """A KKT matrix that is not positive definite (σ far below zero) gets a
    NaN Kinv and the order of its first non-positive pivot in `info`, in
    the twin and the plain body alike, and nothing raises; the rows do
    not depend on it."""
    cfg = qp_cfg(2, True, sigma=-1e9)
    inp = port_inputs(random_inputs(cfg, 2, seed=5, warm=False))
    want = qp.prepare(cfg, inp)
    got, _, info = twin_prepared(cfg, inp)
    assert (info == 1).all() and torch.equal(want.info, info), (want.info, info)
    assert want.loop.Kinv.isnan().all() and got.loop.Kinv.isnan().all()
    rec = qp_check.prepare_agreement(cfg, inp, got, want)
    assert all(n == 0 for n in rec["differing"].values()), rec
    assert torch.isfinite(want.loop.ln).all() and torch.isfinite(want.loop.z).all()


# ----------------------------------------------------------------------
# the plain body against the JAX package's solve
# ----------------------------------------------------------------------

JAX_CASES = [(2, True, False), (2, False, True), (3, True, True), (3, False, False)]


def jax_pieces(monkeypatch, cfg, arrays):
    """The JAX solve's loop inputs (taken where it hands them to its loop
    backend) and its rows' (l, u, ρ), on the same numpy inputs."""
    jinp = jqp.QPInputs(**{k: None if v is None else jax.numpy.asarray(v)
                           for k, v in arrays.items()})
    ref = capture_jax_loop_inputs(monkeypatch, jax_cfg(cfg), jinp, 5e-3)
    l, u, rho = jax.vmap(lambda leaf: jqp.constraint_bounds(jax_cfg(cfg), leaf))(jinp)
    ref.update(l=np.asarray(l), u=np.asarray(u), rho=np.asarray(rho))
    return ref


@pytest.mark.parametrize("dim,use_comm,warm", JAX_CASES)
def test_plain_body_matches_jax(monkeypatch, dim, use_comm, warm):
    """`qp._prepare_plain` (the CPU path of `prepare`) against the JAX
    package's pre-loop body on the same numpy inputs. Sums: float32 in
    another order, 1e-4 relative plus 1e-4 of the array's scale (as
    test_torch_qp.py's bench case); l and u: the caps' scalar 0.95·dt/n
    is rounded once here and three times there, so a few ulp (4·2⁻²³
    relative); ρ equal. Kinv is each package's float32 Cholesky inverse of
    a matrix of condition ~1e5, so it is held through its action on the
    JAX one."""
    cfg = qp_cfg(dim, use_comm)
    arrays = random_inputs(cfg, 4, seed=dim + 2 * use_comm + 4 * warm, warm=warm)
    ref = jax_pieces(monkeypatch, cfg, arrays)
    pr = qp.prepare(cfg, port_inputs(arrays))
    assert int(pr.info.abs().sum()) == 0
    for name in ("normals", "Pn", "qn", "ln", "un", "scale", "xi", "z", "y"):
        got, want = getattr(pr.loop, name).numpy(), ref[name]
        fin = np.abs(want) < 1e19
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(want[fin]).max()), err_msg=name)
        np.testing.assert_array_equal(np.abs(got) >= 1e19, ~fin, err_msg=name)
    for name in ("l", "u"):
        np.testing.assert_allclose(getattr(pr, name).numpy(), ref[name], rtol=4.8e-7,
                                   err_msg=name)
    np.testing.assert_array_equal(pr.loop.rho.numpy(), ref["rho"])
    kt, kj = pr.loop.Kinv.numpy().astype(np.float64), ref["Kinv"].astype(np.float64)
    resid = np.einsum("aij,ajk->aik", kt, np.linalg.inv(kj)) - np.eye(kt.shape[-1])
    assert np.abs(resid).max() < 2e-2, np.abs(resid).max()


def test_plain_body_matches_jax_on_an_indefinite_kkt_matrix(monkeypatch):
    """Where the KKT matrix is not positive definite the JAX package's
    Cholesky gives NaN, and so does the plain body (with `info`), and
    neither raises."""
    cfg = qp_cfg(2, True, sigma=-1e9)
    arrays = random_inputs(cfg, 2, seed=7, warm=True)
    ref = jax_pieces(monkeypatch, cfg, arrays)
    pr = qp.prepare(cfg, port_inputs(arrays))
    assert np.isnan(ref["Kinv"]).all() and pr.loop.Kinv.isnan().all()
    assert (pr.info > 0).all()


# ----------------------------------------------------------------------
# dispatch and the kernel-rows mark
# ----------------------------------------------------------------------


def test_prepare_dispatches_on_the_device():
    """CPU tensors take the plain body (no kernel launch, no plain body
    counted on the card); a CUDA-only entry refuses CPU tensors; another
    device raises."""
    cfg = qp_cfg(2, True)
    inp = port_inputs(random_inputs(cfg, 2, seed=1, warm=False))
    qp.reset_counts()
    qp_prepare_cuda.reset_launches()
    qp.prepare(cfg, inp)
    qp.prepare(cfg, inp, plain=True)
    assert qp.plain_cuda_calls == 0 and qp_prepare_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        qp_prepare_cuda.prepare_cuda(cfg, qp.torch_statics(cfg, CPU), inp,
                                     qp.prepare_scalars(cfg))
    meta = qp.QPInputs(**{f.name: None if getattr(inp, f.name) is None
                          else getattr(inp, f.name).to("meta")
                          for f in dataclasses.fields(inp)})
    with pytest.raises(ValueError, match="device"):
        qp.prepare(cfg, meta)


@pytest.fixture(scope="module")
def loop_inputs():
    cfg = qp_cfg(2, True)
    return cfg, qp.prepare(cfg, port_inputs(random_inputs(cfg, 4, seed=3, warm=True))).loop


def test_marked_loop_inputs_skip_the_row_check(loop_inputs):
    """A marked batch passes `check_kernel_rows` without a look (here one
    whose ρ is wrong, which only the mark lets through), and so do its
    `take` and `resume`; a plain batch is looked at and marked."""
    cfg, li = loop_inputs
    wrong = dataclasses.replace(li, rho=li.rho * 2).mark_kernel_rows()
    qp.check_kernel_rows(cfg, wrong)
    idx = torch.tensor([2, 0])
    qp.check_kernel_rows(cfg, wrong.take(idx))
    qp.check_kernel_rows(cfg, wrong.take(idx).resume(li.xi[idx], li.z[idx], li.y[idx]))
    fresh = dataclasses.replace(li)
    assert not fresh.kernel_rows_marked()
    qp.check_kernel_rows(cfg, fresh)
    assert fresh.kernel_rows_marked() and fresh.take(idx).kernel_rows_marked()


@pytest.mark.parametrize("change", ["unmarked_wrong_rho", "edited_after_mark", "replaced"])
def test_row_check_still_raises_without_a_valid_mark(loop_inputs, change):
    """A hand-built batch with a wrong ρ raises; so does a marked batch
    whose un is edited in place (the mark records the tensors' state), and
    a batch made by `dataclasses.replace` of a marked one (a new object
    carries no mark)."""
    cfg, li = loop_inputs
    if change == "unmarked_wrong_rho":
        bad = dataclasses.replace(li, rho=li.rho * 2)
    elif change == "edited_after_mark":
        bad = dataclasses.replace(li, un=li.un.clone()).mark_kernel_rows()
        bad.un[0, 0] = 1.0
    else:
        marked = dataclasses.replace(li, rho=li.rho * 2).mark_kernel_rows()
        bad = dataclasses.replace(marked, xi=marked.xi)
    with pytest.raises(ValueError):
        qp.check_kernel_rows(cfg, bad)


def test_args_mirror_the_kernels_layout():
    """ctypes' mirror of the kernel's argument struct is laid out as the
    source's C struct: 15 strided inputs of 40 bytes, 31 pointers (the
    last the global build's tile workspace), 9 ints and 8 floats, 920
    bytes (the kernel checks its own size against it when the library
    loads)."""
    assert qp_prepare_cuda._Args.kmat.offset == 15 * 40 + 29 * 8
    assert qp_prepare_cuda._Args.work.offset == 15 * 40 + 30 * 8
    assert qp_prepare_cuda.ctypes.sizeof(qp_prepare_cuda._Args) == 920


# ----------------------------------------------------------------------
# the loop's float64 criterion (qp_check.whole_run_f64)
# ----------------------------------------------------------------------


def test_whole_run_criterion_passes_the_plain_loop(loop_inputs):
    """The float32 plain loop's own run lies inside its envelope about the
    float64 iterate (the envelope's first run is that run)."""
    cfg, li = loop_inputs
    got = qp.admm_loop_plain(cfg, li, 48, 0.0)
    rec = qp_check.whole_run_f64(cfg, li, got)
    assert rec["iterations"] == 48 and rec["agents_failed"] == 0, rec
    assert rec["ratio_max"] <= 1.0, rec


def test_whole_run_criterion_rejects_a_run_off_float64(loop_inputs):
    """A run whose duals of one agent are off by 1e-3 of that agent's
    largest dual (a hundred tolerances; the float32 spread about float64
    is a few) fails, and only that agent."""
    cfg, li = loop_inputs
    xi, z, y, itdone, iters = qp.admm_loop_plain(cfg, li, 48, 0.0)
    y = y.clone()
    y[1] += 1e-3 * y[1].abs().max()
    rec = qp_check.whole_run_f64(cfg, li, (xi, z, y, itdone, iters))
    assert rec["agents_failed"] == 1 and rec["ratio_max"] > qp_check.F64_FACTOR, rec
    assert [w[1:3] for w in rec["worst"] if w[0] > qp_check.F64_FACTOR] == [("y", 1)], rec
