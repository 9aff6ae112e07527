"""Batched trajectory QP (port of lsc_dr_planner_tpu/ops/qp.py).

Every agent's control-point QP is solved at once by OSQP-style ADMM on
the equality-reduced variables ξ (x = x_p + N·ξ per spatial dimension;
the equalities are eliminated offline through a static orthonormal
nullspace basis). The per-agent KKT matrix is assembled from Kronecker
structure and inverted once by batched Cholesky, so each iteration is
one [dk, dk] matvec per agent plus the structured row operator.

The numpy statics are copied from the JAX package as they are. The
iteration loop has two implementations: `admm_loop_plain` here, the
mirror of the XLA loop with its global early exit, and the CUDA kernel
`csrc/admm.cu` (wrapper `ops/qp_cuda.py`). `run_loop` gives CUDA
tensors to the kernel and CPU tensors to the plain loop.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from lsc_dr_planner_tpu_torch.ops import bernstein, qp_cuda

_INF = 1e20
CHUNK = 8  # iterations between exit tests
RESCUE = 64  # rescue batch size above which stragglers are compacted


@dataclasses.dataclass(frozen=True)
class QPConfig:
    dim: int
    M: int
    n: int
    phi: int
    n_obs: int  # padded obstacle slots O
    use_comm: bool
    stop_at_horizon: bool
    dt: float
    control_input_weight: float
    terminal_weight: float
    rho: float
    sigma: float
    alpha: float
    max_iter: int
    eps_abs: float
    # agents still infeasible after max_iter iterate up to rescue_iter
    # more (0 disables); above RESCUE agents the worst RESCUE are compacted
    rescue_iter: int = 0

    @property
    def N(self):
        return self.n + 1


@dataclasses.dataclass
class QPInputs:
    """Per-agent problem data; every field has a leading agent axis."""

    p0: torch.Tensor  # [A, dim]
    v0: torch.Tensor  # [A, dim]
    a0: torch.Tensor  # [A, dim]
    goal: torch.Tensor  # [A, dim]
    terminal_mask: torch.Tensor  # [A, M] ∈ {0,1}: segments with goal cost
    lsc_normals: torch.Tensor  # [A, O, M, dim]
    lsc_rhs: torch.Tensor  # [A, O, M, N]
    lsc_active: torch.Tensor  # [A, O, M, N] bool
    vmax: torch.Tensor  # [A, dim]
    amax: torch.Tensor  # [A, dim]
    lb: torch.Tensor  # [A, dim, M, N]
    ub: torch.Tensor  # [A, dim, M, N]
    comm_halfrange: torch.Tensor  # [A] (0.5·R − r; big disables)
    x0: torch.Tensor  # [A, dim, M, N] warm start (initial trajectory)
    y0: Optional[torch.Tensor] = None  # [A, R] dual warm start (None = cold)


@dataclasses.dataclass
class QPResult:
    x: torch.Tensor  # [A, dim, M, N] control points
    converged: torch.Tensor  # [A] bool
    primal_residual: torch.Tensor  # [A] max row-scaled violation
    iterations: torch.Tensor  # [A] int32
    objective: torch.Tensor  # [A]
    z: torch.Tensor  # [A, R] final slack rows (reduced coords)
    y: torch.Tensor  # [A, R] final duals — next step's warm start


@dataclasses.dataclass
class LoopInputs:
    """The ADMM loop's inputs in the flat row layout (leading agent axis)."""

    normals: torch.Tensor  # [A, O, M, dim]
    Kinv: torch.Tensor  # [A, dk, dk]
    Pn: torch.Tensor  # [A, K, K]
    qn: torch.Tensor  # [A, dim, K]
    ln: torch.Tensor  # [A, R]
    un: torch.Tensor  # [A, R]
    rho: torch.Tensor  # [A, R]
    scale: torch.Tensor  # [A, R]
    xi: torch.Tensor  # [A, dim, K]
    z: torch.Tensor  # [A, R]
    y: torch.Tensor  # [A, R]

    def __post_init__(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name).contiguous())

    def take(self, idx) -> "LoopInputs":
        return LoopInputs(*(getattr(self, f.name)[idx]
                            for f in dataclasses.fields(self)))


# ----------------------------------------------------------------------
# static equality elimination (numpy, as in the JAX package)
# ----------------------------------------------------------------------


def pinned_values(cfg: QPConfig, p0, v0, a0):
    """Exact initial control points from the initial state:
    c0 = p, c1 = p + dt/n·v, c2 = dt²/(n(n−1))·a + 2c1 − c0."""
    n, dt = cfg.n, cfg.dt
    c0 = p0
    c1 = p0 + v0 * (dt / n)
    c2 = a0 * (dt * dt / (n * (n - 1))) + 2 * c1 - c0
    return torch.stack([c0, c1, c2], dim=-1)  # [..., dim, phi]


@functools.lru_cache(maxsize=None)
def _equality_basis(M: int, n: int, phi: int, dt: float, stop: bool):
    """(N_null [MN, K] orthonormal nullspace basis of the per-dimension
    equalities, X_pin [MN, phi] minimum-jerk particular-solution map)."""
    NN = n + 1
    MN = M * NN

    def idx(m, i):
        return m * NN + i

    rows = []
    r = np.zeros(MN)
    r[idx(0, n)] = 1
    r[idx(1, 0)] = -1
    rows.append(r)
    r = np.zeros(MN)
    r[idx(1, 1)] = 1
    r[idx(1, 0)] = -1
    r[idx(0, n)] = -1
    r[idx(0, n - 1)] = 1
    rows.append(r)
    r = np.zeros(MN)
    r[idx(1, 2)] = 1
    r[idx(1, 1)] = -2
    r[idx(1, 0)] = 1
    r[idx(0, n)] = -1
    r[idx(0, n - 1)] = 2
    r[idx(0, n - 2)] = -1
    rows.append(r)
    rows.extend(bernstein.continuity_matrix(M, n, phi, dt))
    if stop:
        for i in range(1, phi):
            r = np.zeros(MN)
            r[idx(M - 1, n)] = 1
            r[idx(M - 1, n - i)] = -1
            rows.append(r)
    E_static = np.asarray(rows)
    pinrows = np.zeros((phi, MN))
    for i in range(phi):
        pinrows[i, idx(0, i)] = 1
    E = np.vstack([E_static, pinrows])

    _, s, vt = np.linalg.svd(E)
    rank = int((s > 1e-9).sum())
    N_null = vt[rank:].T

    P_reg = np.kron(np.eye(M), bernstein.jerk_cost_matrix(n, phi, 1, dt)) + 1e-6 * np.eye(MN)
    neq = E.shape[0]
    KKT = np.block([[P_reg, E.T], [E, np.zeros((neq, neq))]])
    rhs = np.zeros((MN + neq, phi))
    rhs[MN + E_static.shape[0] :, :] = np.eye(phi)
    X_pin = np.linalg.solve(KKT, rhs)[:MN]
    return N_null, X_pin


def n_rows(cfg: QPConfig) -> int:
    """Total inequality rows per agent (the dual-vector length)."""
    return sum(row_blocks(cfg).values())


@functools.lru_cache(maxsize=None)
def _comm_pairs(M: int):
    pairs = [(mi, m) for mi in range(M) for m in range(mi, M)]
    a = np.asarray(pairs, dtype=np.int64)
    return a[:, 0], a[:, 1]


def row_blocks(cfg: QPConfig):
    """Static row counts per inequality family, in flat-vector order."""
    dim, M, n, N = cfg.dim, cfg.M, cfg.n, cfg.N
    return {
        "lsc": cfg.n_obs * M * N,
        "vel": dim * M * n,
        "acc": dim * M * (n - 1),
        "comm": dim * (M * (M + 1) // 2) if cfg.use_comm else 0,
        "bound": dim * M * N,
    }


# Per-family ρ multipliers, roughly ∝ 1/(feasible row range).
_RHO_SCALE = {"lsc": 10.0, "vel": 100.0, "acc": 500.0, "comm": 1.0, "bound": 5.0}


@functools.lru_cache(maxsize=None)
def _solver_statics(cfg: QPConfig):
    """Everything data-independent, in numpy, shared across the fleet."""
    M, n, N = cfg.M, cfg.n, cfg.N
    MN = M * N
    N_null, X_pin = _equality_basis(M, n, cfg.phi, cfg.dt, cfg.stop_at_horizon)
    K = N_null.shape[1]
    N3 = N_null.reshape(M, N, K)

    P_base = np.kron(
        np.eye(M),
        2.0 * cfg.control_input_weight
        * bernstein.jerk_cost_matrix(n, cfg.phi, 1, cfg.dt),
    )
    Pn_base = N_null.T @ P_base @ N_null
    T_term = np.einsum("mk,ml->mkl", N3[:, n, :], N3[:, n, :])
    T_lsc = np.einsum("mik,mil->mkl", N3, N3)

    rows = []
    rhos = []
    for m in range(M):
        for i in range(n):
            r = np.zeros(MN)
            r[m * N + i + 1] = 1
            r[m * N + i] = -1
            rows.append(r)
            rhos.append(cfg.rho * _RHO_SCALE["vel"])
    for m in range(M):
        for i in range(n - 1):
            r = np.zeros(MN)
            r[m * N + i + 2] = 1
            r[m * N + i + 1] = -2
            r[m * N + i] = 1
            rows.append(r)
            rhos.append(cfg.rho * _RHO_SCALE["acc"])
    if cfg.use_comm:
        mi_arr, mm_arr = _comm_pairs(M)
        for mi, mm in zip(mi_arr, mm_arr):
            r = np.zeros(MN)
            r[mm * N + n] += 1
            r[mi * N + 0] -= 1
            rows.append(r)
            rhos.append(cfg.rho * _RHO_SCALE["comm"])
    rows.extend(np.eye(MN))
    rhos.extend([cfg.rho * _RHO_SCALE["bound"]] * MN)
    A_dim = np.asarray(rows)
    rho_dim = np.asarray(rhos)
    An_sd = A_dim @ N_null
    G_stat = (An_sd.T * rho_dim) @ An_sd

    # static families in reduced coords, family-major with dim-major rows
    # inside each family (constraint_bounds's flat layout)
    n_vel, n_acc = M * n, M * (n - 1)
    n_comm = M * (M + 1) // 2 if cfg.use_comm else 0
    eye_d = np.eye(cfg.dim)
    blocks = []
    off = 0
    for cnt in (n_vel, n_acc, n_comm, MN):
        if cnt:
            blocks.append(np.kron(eye_d, An_sd[off:off + cnt]))
        off += cnt
    An_stat = np.vstack(blocks)  # [dim·R_dim, dim·K]

    return {
        "N_null": N_null, "X_pin": X_pin, "N3": N3, "K": K,
        "P_base": P_base, "Pn_base": Pn_base, "T_term": T_term,
        "T_lsc": T_lsc, "G_stat": G_stat, "An_stat": An_stat,
    }


@functools.lru_cache(maxsize=None)
def torch_statics(cfg: QPConfig, device: torch.device):
    """`_solver_statics` as float32 tensors on `device`, plus N3k [K, MN]
    (the nullspace basis, k-major), the kernel's LSC operator."""
    st = _solver_statics(cfg)
    out = {k: (torch.as_tensor(v, dtype=torch.float32, device=device)
               if isinstance(v, np.ndarray) else v) for k, v in st.items()}
    K, MN = st["K"], cfg.M * cfg.N
    out["N3k"] = out["N3"].permute(2, 0, 1).reshape(K, MN).contiguous()
    out["comm_pairs"] = tuple(torch.as_tensor(v, device=device) for v in _comm_pairs(cfg.M))
    out["P_base64"] = torch.as_tensor(st["P_base"], dtype=torch.float64, device=device)
    return out


# ----------------------------------------------------------------------
# rows and bounds (batched over agents)
# ----------------------------------------------------------------------


def _rows_batched(cfg: QPConfig, x, normals):
    """A·x as flat rows: x [A, dim, M, N], normals [A, O, M, dim] → [A, R]."""
    A = x.shape[0]
    n = cfg.n
    out = [torch.einsum("aomk,akmi->aomi", normals, x).reshape(A, -1)]
    out.append((x[..., 1:] - x[..., :-1]).reshape(A, -1))
    out.append((x[..., 2:] - 2 * x[..., 1:-1] + x[..., :-2]).reshape(A, -1))
    if cfg.use_comm:
        mi, mm = torch_statics(cfg, x.device)["comm_pairs"]
        out.append((x[:, :, mm, n] - x[:, :, mi, 0]).reshape(A, -1))
    out.append(x.reshape(A, -1))
    return torch.cat(out, dim=-1)


def constraint_bounds(cfg: QPConfig, inp: QPInputs):
    """(l, u, rho) flat row vectors [A, R] (inequalities only)."""
    dim, M, n, N, phi = cfg.dim, cfg.M, cfg.n, cfg.N, cfg.phi
    dt = cfg.dt
    dtype, dev = inp.p0.dtype, inp.p0.device
    A = inp.p0.shape[0]
    ls, us, rs = [], [], []

    def add(l, u, rho):
        ls.append(l.reshape(A, -1))
        us.append(u.reshape(A, -1))
        rs.append(torch.full((A, ls[-1].shape[1]), rho, dtype=dtype, device=dev))

    lsc_l = torch.where(inp.lsc_active, inp.lsc_rhs, -_INF)
    add(lsc_l, torch.full_like(lsc_l, _INF), cfg.rho * _RHO_SCALE["lsc"])

    # velocity |Δ| ≤ 0.95·vmax·dt/n (5% robustness buffer); skip m=0, i<2
    vcap = (0.95 * inp.vmax * dt / n)[:, :, None, None].expand(A, dim, M, n)
    vmask = torch.ones((M, n), dtype=torch.bool, device=dev)
    vmask[0, :2] = False
    vcap = torch.where(vmask, vcap, _INF)
    add(-vcap, vcap, cfg.rho * _RHO_SCALE["vel"])

    # acceleration |Δ²| ≤ 0.95·amax·dt²/(n(n−1)); skip m=0, i=0
    acap = (0.95 * inp.amax * dt * dt / (n * (n - 1)))[:, :, None, None].expand(
        A, dim, M, n - 1)
    amask = torch.ones((M, n - 1), dtype=torch.bool, device=dev)
    amask[0, 0] = False
    acap = torch.where(amask, acap, _INF)
    add(-acap, acap, cfg.rho * _RHO_SCALE["acc"])

    if cfg.use_comm:
        npairs = M * (M + 1) // 2
        ccap = inp.comm_halfrange[:, None, None].expand(A, dim, npairs).to(dtype)
        add(-ccap, ccap, cfg.rho * _RHO_SCALE["comm"])

    # bounds; pinned entries vacuous (their value is fixed by elimination)
    pm = torch.zeros((dim, M, N), dtype=torch.bool, device=dev)
    pm[:, 0, :phi] = True
    add(torch.where(pm, -_INF, inp.lb), torch.where(pm, _INF, inp.ub),
        cfg.rho * _RHO_SCALE["bound"])
    return torch.cat(ls, dim=-1), torch.cat(us, dim=-1), torch.cat(rs, dim=-1)


# ----------------------------------------------------------------------
# reduced operators
# ----------------------------------------------------------------------


def _fwd(cfg, ts, normals, xi):
    """ξ [B, dim, K] → rows [B, R] (pin offset excluded)."""
    B = xi.shape[0]
    c = torch.einsum("aomd,adk->aomk", normals, xi)
    r_lsc = torch.einsum("mik,aomk->aomi", ts["N3"], c).reshape(B, -1)
    r_stat = xi.reshape(B, -1) @ ts["An_stat"].T
    return torch.cat([r_lsc, r_stat], dim=-1)


def _adj(cfg, ts, normals, w):
    """Row cotangent [B, R] → ξ-space [B, dim, K]."""
    B = w.shape[0]
    R_lsc = cfg.n_obs * cfg.M * cfg.N
    wl = w[:, :R_lsc].reshape(B, cfg.n_obs, cfg.M, cfg.N)
    t = torch.einsum("mik,aomi->aomk", ts["N3"], wl)
    g_lsc = torch.einsum("aomd,aomk->adk", normals, t)
    g_stat = (w[:, R_lsc:] @ ts["An_stat"]).reshape(B, cfg.dim, ts["K"])
    return g_lsc + g_stat


def admm_loop_plain(cfg: QPConfig, li: LoopInputs, max_iter: int, feas_tol: float):
    """The chunked ADMM iteration in plain torch, the mirror of the XLA
    loop: exit tests every CHUNK iterations (row-scaled feasibility of
    the actual iterate, relative dual residual, iterate stall, objective
    patience) and a global exit once every agent is done at the same
    test. Returns (xi, z, y, itdone [B] int32, iters 0-d int32)."""
    ts = torch_statics(cfg, li.xi.device)
    normals, Kinv, Pn, qn = li.normals, li.Kinv, li.Pn, li.qn
    ln, un, rho, scale = li.ln, li.un, li.rho, li.scale
    xi, z, y = li.xi, li.z, li.y
    B = xi.shape[0]
    eps_rel = 1e-3
    stop_tol = 0.6 * feas_tol
    n_chunks = max(1, -(-max_iter // CHUNK))
    a, b = cfg.alpha, 1 - cfg.alpha

    Ax = _fwd(cfg, ts, normals, xi)
    itdone = torch.full((B,), max_iter, dtype=torch.int32, device=xi.device)
    best = torch.full((B,), float("inf"), dtype=xi.dtype, device=xi.device)
    noimp = torch.zeros((B,), dtype=torch.int32, device=xi.device)
    ck = 0
    while ck < n_chunks:
        xi_prev = xi
        for _ in range(CHUNK):
            rhs = cfg.sigma * xi - qn + _adj(cfg, ts, normals, rho * z - y)
            xi_t = torch.einsum("aij,aj->ai", Kinv, rhs.reshape(B, -1)).reshape(xi.shape)
            z_t = _fwd(cfg, ts, normals, xi_t)
            xi_n = a * xi_t + b * xi
            z_mix = a * z_t + b * z
            z_n = torch.minimum(torch.maximum(z_mix + y / rho, ln), un)
            y = y + rho * (z_mix - z_n)
            Ax = a * z_t + b * Ax
            xi, z = xi_n, z_n
        ck += 1
        viol = torch.clamp(torch.maximum(ln - Ax, Ax - un), min=0.0)
        feas = (viol / scale).amax(dim=-1) < stop_tol
        Px = torch.einsum("akl,adl->adk", Pn, xi)
        Aty = _adj(cfg, ts, normals, y)
        rd = (Px + qn + Aty).abs().reshape(B, -1).amax(dim=-1)
        dmag = torch.maximum(
            Px.abs().reshape(B, -1).amax(dim=-1),
            torch.maximum(Aty.abs().reshape(B, -1).amax(dim=-1),
                          qn.abs().reshape(B, -1).amax(dim=-1)))
        opt = rd < cfg.eps_abs + eps_rel * dmag
        dxi = (xi - xi_prev).abs().reshape(B, -1).amax(dim=-1)
        ximag = torch.clamp(xi.abs().reshape(B, -1).amax(dim=-1), min=1.0)
        stalled = dxi < 1e-4 * ximag
        obj = torch.einsum("adk,adk->a", 0.5 * Px + qn, xi)
        improved = obj < best - 2e-4 * torch.clamp(obj.abs(), min=1.0)
        best = torch.where(feas & improved, obj, best)
        noimp = torch.where(feas & ~improved, noimp + 1, 0).to(torch.int32)
        done = feas & (opt | stalled | (noimp >= 2))
        itdone = torch.where(done & (itdone == max_iter), ck * CHUNK, itdone).to(torch.int32)
        if bool(done.all()):
            break
    iters = torch.tensor(ck * CHUNK, dtype=torch.int32, device=xi.device)
    return xi, z, y, itdone, iters


def run_loop(cfg: QPConfig, li: LoopInputs, max_iter: int, feas_tol: float,
             plain: bool = False):
    """The ADMM loop: the CUDA kernel for CUDA tensors, the plain loop for
    CPU tensors; `plain` forces the plain loop on any device, for
    comparisons. Any other device raises."""
    dev = li.xi.device
    if plain or dev.type == "cpu":
        return admm_loop_plain(cfg, li, max_iter, feas_tol)
    if dev.type != "cuda":
        raise ValueError(f"no ADMM loop for device {dev}")
    ts = torch_statics(cfg, dev)
    return qp_cuda.admm_loop_cuda(li, ts["An_stat"], ts["N3k"], max_iter, CHUNK,
                                  0.6 * feas_tol, cfg.sigma, cfg.alpha, cfg.eps_abs)


# ----------------------------------------------------------------------
# solve
# ----------------------------------------------------------------------


@dataclasses.dataclass
class Prepared:
    """`prepare`'s products: the loop inputs and what the final residual
    and objective need."""

    loop: LoopInputs
    xpart: torch.Tensor  # [A, dim, MN]
    b_off: torch.Tensor  # [A, R]
    l: torch.Tensor  # [A, R]
    u: torch.Tensor  # [A, R]
    tvec: torch.Tensor  # [A, 1, MN]
    qflat: torch.Tensor  # [A, dim, MN]


def prepare(cfg: QPConfig, inputs: QPInputs) -> Prepared:
    """Everything before the ADMM loop: pins and their particular
    solution, bounds in reduced coordinates, the reduced cost, the KKT
    inverse (batched Cholesky) and the warm start."""
    dev, dtype = inputs.p0.device, inputs.p0.dtype
    ts = torch_statics(cfg, dev)
    A = inputs.p0.shape[0]
    dim, M, n, N = cfg.dim, cfg.M, cfg.n, cfg.N
    MN = M * N
    K = ts["K"]
    N_null = ts["N_null"]

    pins = pinned_values(cfg, inputs.p0, inputs.v0, inputs.a0)  # [A, dim, phi]
    xpart = torch.einsum("vp,adp->adv", ts["X_pin"], pins)  # [A, dim, MN]
    l, u, rho = constraint_bounds(cfg, inputs)
    b_off = _rows_batched(cfg, xpart.reshape(A, dim, M, N), inputs.lsc_normals)
    ln, un = l - b_off, u - b_off

    # reduced cost
    tdiag = 2.0 * cfg.terminal_weight * inputs.terminal_mask  # [A, M]
    tvec = torch.zeros((A, M, N), dtype=dtype, device=dev)
    tvec[:, :, n] = tdiag
    tvec = tvec.reshape(A, 1, MN)
    q = torch.zeros((A, dim, M, N), dtype=dtype, device=dev)
    q[..., n] = (-2.0 * cfg.terminal_weight * inputs.terminal_mask[:, None, :]
                 * inputs.goal[..., None])
    qflat = q.reshape(A, dim, MN)
    Pxp = torch.einsum("vw,adw->adv", ts["P_base"], xpart) + tvec * xpart
    qn = torch.einsum("vk,adv->adk", N_null, qflat + Pxp)  # [A, dim, K]

    # KKT matrix from Kronecker structure, inverted once
    Pn_dim = ts["Pn_base"][None] + torch.einsum("am,mkl->akl", tdiag, ts["T_term"])
    diag_blk = (Pn_dim + ts["G_stat"][None]
                + cfg.sigma * torch.eye(K, dtype=dtype, device=dev)[None])
    S_lsc = torch.einsum("aomd,aome->amde", inputs.lsc_normals, inputs.lsc_normals)
    Kmat = (cfg.rho * _RHO_SCALE["lsc"]) * torch.einsum(
        "amde,mkl->adkel", S_lsc, ts["T_lsc"])  # [A, dim, K, dim, K]
    for d in range(dim):
        Kmat[:, d, :, d, :] += diag_blk
    Kmat = Kmat.reshape(A, dim * K, dim * K)
    chol = torch.linalg.cholesky(Kmat)
    eye_dk = torch.eye(dim * K, dtype=dtype, device=dev).expand(A, dim * K, dim * K)
    Kinv = torch.cholesky_solve(eye_dk, chol)

    # residual row scale (matches the caller's feasibility gate)
    scale = torch.clamp(6.0 * (0.5 * (u - l)), 0.02, 1.0)

    xi0 = torch.einsum("vk,adv->adk", N_null, inputs.x0.reshape(A, dim, MN) - xpart)
    z0 = _fwd(cfg, ts, inputs.lsc_normals, xi0)
    y0 = torch.zeros_like(z0) if inputs.y0 is None else inputs.y0.to(dtype)
    loop = LoopInputs(normals=inputs.lsc_normals, Kinv=Kinv, Pn=Pn_dim, qn=qn,
                      ln=ln, un=un, rho=rho, scale=scale, xi=xi0, z=z0, y=y0)
    return Prepared(loop=loop, xpart=xpart, b_off=b_off, l=l, u=u, tvec=tvec,
                    qflat=qflat)


def solve(cfg: QPConfig, inputs: QPInputs, feas_tol: float = 5e-3,
          plain: bool = False) -> QPResult:
    """Solve all agents' QPs in one batched ADMM, then rescue the
    stragglers (small fleets in place; above RESCUE agents the worst
    RESCUE are compacted into one batch)."""
    pr = prepare(cfg, inputs)
    li = pr.loop
    A = li.xi.shape[0]
    dim, M, N = cfg.dim, cfg.M, cfg.N
    ts = torch_statics(cfg, li.xi.device)

    xi, z, y, itdone, iters = run_loop(cfg, li, cfg.max_iter, feas_tol, plain)

    if cfg.rescue_iter > 0 and A <= RESCUE:
        cont = dataclasses.replace(li, xi=xi, z=z, y=y)
        xi, z, y, itdone2, iters2 = run_loop(cfg, cont, cfg.rescue_iter, feas_tol, plain)
        itdone = (torch.clamp(itdone, max=cfg.max_iter)
                  + torch.minimum(itdone2, iters2)).to(torch.int32)
        iters = iters + iters2
    elif cfg.rescue_iter > 0:
        Axc = _fwd(cfg, ts, li.normals, xi)
        violc = torch.clamp(torch.maximum(li.ln - Axc, Axc - li.un), min=0.0)
        resc = (violc / li.scale).amax(dim=-1)
        bad = resc >= 0.6 * feas_tol
        # worst-first compaction; a stable sort keeps the lower index first
        # among ties, as lax.top_k does
        key = torch.where(bad, resc, -1.0)
        idx = torch.sort(key, descending=True, stable=True).indices[:RESCUE]
        take = bad[idx]
        sub = dataclasses.replace(li.take(idx), xi=xi[idx], z=z[idx], y=y[idx])
        xi_r, z_r, y_r, it_r, iters2 = run_loop(cfg, sub, cfg.rescue_iter, feas_tol,
                                                plain)
        xi = xi.clone()
        z = z.clone()
        y = y.clone()
        xi[idx] = torch.where(take[:, None, None], xi_r, xi[idx])
        z[idx] = torch.where(take[:, None], z_r, z[idx])
        y[idx] = torch.where(take[:, None], y_r, y[idx])
        itdone = itdone.clone()
        itdone[idx] += torch.where(take, torch.minimum(it_r, iters2), 0).to(torch.int32)
        iters = iters + iters2

    x = (torch.einsum("vk,adk->adv", ts["N_null"], xi) + pr.xpart).reshape(A, dim, M, N)
    Ax = _fwd(cfg, ts, li.normals, xi) + pr.b_off
    viol = torch.clamp(torch.maximum(pr.l - Ax, Ax - pr.u), min=0.0)
    primal_res = (viol / li.scale).amax(dim=-1)

    return QPResult(x=x, converged=primal_res < feas_tol, primal_residual=primal_res,
                    iterations=torch.minimum(itdone, iters),
                    objective=objective(cfg, pr, x), z=z, y=y)


def objective(cfg: QPConfig, pr: Prepared, x):
    """The QP objective ½xᵀPx + qᵀx of control points x [A, dim, M, N], in
    x's dtype. In float32 it carries cancellation noise of order
    eps·|P|·|x|² (≈1e-2 relative for agents 20 m from the origin), so
    comparisons of two solutions evaluate it in float64."""
    A, dim = x.shape[:2]
    ts = torch_statics(cfg, x.device)
    P_base = ts["P_base64"] if x.dtype == torch.float64 else ts["P_base"].to(x.dtype)
    xf = x.reshape(A, dim, -1)
    return (0.5 * torch.einsum("adv,vw,adw->a", xf, P_base, xf)
            + 0.5 * torch.einsum("adv,adv->a", pr.tvec.to(x.dtype) * xf, xf)
            + torch.einsum("adv,adv->a", pr.qflat.to(x.dtype), xf))
