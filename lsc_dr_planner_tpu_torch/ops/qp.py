"""Batched trajectory QP (port of lsc_dr_planner_tpu/ops/qp.py).

Every agent's control-point QP is solved at once by OSQP-style ADMM on
the equality-reduced variables ξ (x = x_p + N·ξ per spatial dimension;
the equalities are eliminated offline through a static orthonormal
nullspace basis). The per-agent KKT matrix is assembled from Kronecker
structure and inverted once by batched Cholesky, so each iteration is
one [dk, dk] matvec per agent plus the structured row operator.

The numpy statics are copied from the JAX package as they are. The two
parts of a solve each have two implementations, a plain torch version
here and a hand-written CUDA kernel; CUDA tensors go to the kernel, CPU
tensors to the plain version:
- the preparation (`prepare`: rows, reduced cost, KKT inverse, warm
  start): `_prepare_plain`, and one launch of `csrc/qp_prepare.cu`
  (wrapper `ops/qp_prepare_cuda.py`); `plain_cuda_calls` counts plain
  bodies run on CUDA tensors since `reset_counts()`;
- the iteration loop (`run_loop`): `admm_loop_plain`, the mirror of the
  XLA loop with its global early exit, and `csrc/admm.cu` (wrapper
  `ops/qp_cuda.py`).
On the kernel paths a solve reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from lsc_dr_planner_tpu_torch.ops import bernstein, qp_cuda, qp_prepare_cuda

_INF = 1e20
CHUNK = 8  # iterations between exit tests
RESCUE = 64  # rescue batch size above which stragglers are compacted

plain_cuda_calls = 0  # plain `prepare` bodies run on CUDA tensors since the last reset


def reset_counts():
    global plain_cuda_calls
    plain_cuda_calls = 0


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
        """The agents `idx`; keeps the kernel-rows mark."""
        return self._carry_mark(LoopInputs(*(getattr(self, f.name)[idx]
                                             for f in dataclasses.fields(self))))

    def resume(self, xi, z, y) -> "LoopInputs":
        """The same problems, from the iterate (xi, z, y); keeps the mark."""
        return self._carry_mark(dataclasses.replace(self, xi=xi, z=z, y=y))

    def mark_kernel_rows(self) -> "LoopInputs":
        """Marks rho and un, in their present state, as what the CUDA loop
        kernel takes in their place (`check_kernel_rows`): set by the
        check itself and by the preparation kernel, which writes them so
        by construction. An edit in place (the tensors' version counters)
        or another tensor clears the mark."""
        self._kernel_rows_mark = self._rows_state()
        return self

    def kernel_rows_marked(self) -> bool:
        return self.__dict__.get("_kernel_rows_mark") == self._rows_state()

    def _rows_state(self):
        return (self.rho.data_ptr(), self.rho._version, self.un.data_ptr(), self.un._version)

    def _carry_mark(self, out: "LoopInputs") -> "LoopInputs":
        return out.mark_kernel_rows() if self.kernel_rows_marked() else out


# ----------------------------------------------------------------------
# static equality elimination (numpy, as in the JAX package)
# ----------------------------------------------------------------------


def pinned_values(cfg: QPConfig, p0, v0, a0):
    """Exact initial control points from the initial state:
    c0 = p, c1 = p + dt/n·v, c2 = dt²/(n(n−1))·a + 2c1 − c0."""
    sc = prepare_scalars(cfg)
    c0 = p0
    c1 = p0 + v0 * sc["vel"]
    c2 = a0 * sc["acc"] + 2 * c1 - c0
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
    # inside each family (constraint_bounds's flat layout): flat static
    # row s is row stat_rr[s] of A_dim in dimension stat_d[s]
    n_vel, n_acc = M * n, M * (n - 1)
    n_comm = M * (M + 1) // 2 if cfg.use_comm else 0
    stat_d, stat_rr = [], []
    off = 0
    for cnt in (n_vel, n_acc, n_comm, MN):
        for d in range(cfg.dim):
            stat_d.extend([d] * cnt)
            stat_rr.extend(range(off, off + cnt))
        off += cnt
    stat_d, stat_rr = np.asarray(stat_d), np.asarray(stat_rr)
    An_stat = np.zeros((len(stat_rr), cfg.dim * K))  # [dim·R_dim, dim·K]
    for s, (d, rr) in enumerate(zip(stat_d, stat_rr)):
        An_stat[s, d * K:(d + 1) * K] = An_sd[rr]

    return {
        "N_null": N_null, "X_pin": X_pin, "N3": N3, "K": K,
        "P_base": P_base, "Pn_base": Pn_base, "T_term": T_term,
        "T_lsc": T_lsc, "G_stat": G_stat, "An_stat": An_stat,
        "A_dim": A_dim, "rho_dim": rho_dim, "stat_d": stat_d, "stat_rr": stat_rr,
    }


@functools.lru_cache(maxsize=None)
def stencil_table(cfg: QPConfig):
    """The static rows as stencils over the control points, the CUDA
    kernel's operator in place of An_stat, in numpy, from
    `_solver_statics`'s own A_dim and flat row order.

    Static row s = Σ_e coef[s, e]·VU[idx[s, e]], where VU [dim·MN] holds
    the control points N_null·ξ_d of every dimension d (flat d·MN + mn);
    unused slots have coefficient 0. `rho` [R_stat] is each row's ρ. The
    adjoint reads the transpose as compressed columns: the rows of
    control point c are adj_row[adj_ptr[c]:adj_ptr[c+1]], with
    coefficients adj_coef; `grp_ptr` restricts those columns to each of
    the CUDA kernel's fixed row groups (`qp_cuda.group_ptr`)."""
    st = _solver_statics(cfg)
    A_dim, MN = st["A_dim"], cfg.M * cfg.N
    stat_d, stat_rr = st["stat_d"], st["stat_rr"]
    R_stat = len(stat_rr)
    idx = np.zeros((R_stat, qp_cuda.STENCIL_WIDTH), np.int32)
    coef = np.zeros((R_stat, qp_cuda.STENCIL_WIDTH))
    cols = [[] for _ in range(cfg.dim * MN)]
    for s, (d, rr) in enumerate(zip(stat_d, stat_rr)):
        nz = np.flatnonzero(A_dim[rr])
        if len(nz) > qp_cuda.STENCIL_WIDTH:
            raise ValueError(f"A_dim row {rr} has {len(nz)} nonzeros > {qp_cuda.STENCIL_WIDTH}")
        idx[s, :len(nz)] = d * MN + nz
        coef[s, :len(nz)] = A_dim[rr, nz]
        for c in nz:
            cols[d * MN + c].append((s, A_dim[rr, c]))
    adj_ptr = np.cumsum([0] + [len(c) for c in cols]).astype(np.int32)
    adj_row = np.asarray([s for c in cols for s, _ in c], np.int32)
    adj_coef = np.asarray([v for c in cols for _, v in c])
    return {"idx": idx, "coef": coef, "rho": st["rho_dim"][stat_rr],
            "adj_ptr": adj_ptr, "adj_row": adj_row, "adj_coef": adj_coef,
            "grp_ptr": qp_cuda.group_ptr(adj_ptr, adj_row, R_stat)}


@functools.lru_cache(maxsize=None)
def torch_statics(cfg: QPConfig, device: torch.device, dtype: torch.dtype = torch.float32):
    """`_solver_statics` as `dtype` (float32) tensors on `device` (its
    integer arrays stay numpy), plus the CUDA kernels' operators: N3k
    [K, MN] (the nullspace basis, k-major) and its transpose N3kT,
    `stencil`, `stencil_table` as tensors, `kernel_rho` [R], the ρ of
    every row as the loop kernel takes it (ρ_lsc on the LSC rows, the
    table's on the static rows), `P_blk` [N, N] (P_base = I_M ⊗ P_blk)
    and `prep`, the statics the preparation kernel reads, contiguous."""
    st = _solver_statics(cfg)
    out = {k: (torch.as_tensor(v, dtype=dtype, device=device)
               if isinstance(v, np.ndarray) and v.dtype.kind == "f" else v)
           for k, v in st.items()}
    K, MN = st["K"], cfg.M * cfg.N
    out["N3k"] = out["N3"].permute(2, 0, 1).reshape(K, MN).contiguous()
    out["N3kT"] = out["N3k"].T.contiguous()
    out["stencil"] = {k: torch.as_tensor(v, dtype=torch.int32 if v.dtype.kind == "i" else dtype,
                                         device=device)
                      for k, v in stencil_table(cfg).items()}
    R_lsc = cfg.n_obs * cfg.M * cfg.N
    out["kernel_rho"] = torch.cat([
        torch.full((R_lsc,), cfg.rho * _RHO_SCALE["lsc"], dtype=dtype, device=device),
        out["stencil"]["rho"]])
    out["comm_pairs"] = tuple(torch.as_tensor(v, device=device) for v in _comm_pairs(cfg.M))
    out["P_base64"] = torch.as_tensor(st["P_base"], dtype=torch.float64, device=device)
    # P_base = I_M ⊗ P_blk: one segment's block of the jerk cost
    N = cfg.N
    blk = st["P_base"][:N, :N]
    if not np.array_equal(st["P_base"], np.kron(np.eye(cfg.M), blk)):
        raise ValueError("P_base is not block diagonal with equal blocks")
    out["P_blk"] = torch.as_tensor(blk, dtype=dtype, device=device)
    # the preparation kernel's statics, contiguous (N_null is a transpose;
    # An_statT [dim·K, R_stat], so that a row a thread reads coalesced)
    out["prep"] = {k: out[k].contiguous() for k in (
        "X_pin", "P_blk", "N_null", "N3k", "Pn_base", "T_term", "G_stat", "T_lsc",
        "kernel_rho")}
    out["prep"]["An_statT"] = out["An_stat"].T.contiguous()
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
    dtype, dev = inp.p0.dtype, inp.p0.device
    A = inp.p0.shape[0]
    ls, us, rs = [], [], []

    def add(l, u, rho):
        ls.append(l.reshape(A, -1))
        us.append(u.reshape(A, -1))
        rs.append(torch.full((A, ls[-1].shape[1]), rho, dtype=dtype, device=dev))

    lsc_l = torch.where(inp.lsc_active, inp.lsc_rhs, -_INF)
    add(lsc_l, torch.full_like(lsc_l, _INF), cfg.rho * _RHO_SCALE["lsc"])

    # velocity |Δ| ≤ 0.95·vmax·dt/n (5% robustness buffer); skip m=0, i<2.
    # One product with the scalar rounded once: a tensor divided by a
    # Python scalar is multiplied by its reciprocal on the card and
    # divided on the CPU, which round differently
    sc = prepare_scalars(cfg)
    vcap = (inp.vmax * sc["vcap"])[:, :, None, None].expand(A, dim, M, n)
    vmask = torch.ones((M, n), dtype=torch.bool, device=dev)
    vmask[0, :2] = False
    vcap = torch.where(vmask, vcap, _INF)
    add(-vcap, vcap, cfg.rho * _RHO_SCALE["vel"])

    # acceleration |Δ²| ≤ 0.95·amax·dt²/(n(n−1)); skip m=0, i=0
    acap = (inp.amax * sc["acap"])[:, :, None, None].expand(A, dim, M, n - 1)
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
    test. Runs in the inputs' dtype (float64 gives the reference for
    float32 rounding). Returns (xi, z, y, itdone [B] int32, iters 0-d
    int32)."""
    ts = torch_statics(cfg, li.xi.device, li.xi.dtype)
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
    check_kernel_rows(cfg, li)
    ts = torch_statics(cfg, dev)
    return qp_cuda.admm_loop_cuda(li, ts["stencil"], ts["N3k"], ts["N3kT"],
                                  cfg.rho * _RHO_SCALE["lsc"], max_iter, CHUNK,
                                  0.6 * feas_tol, cfg.sigma, cfg.alpha, cfg.eps_abs)


def check_kernel_rows(cfg: QPConfig, li: LoopInputs):
    """Raise ValueError unless li's ρ and LSC upper bounds are what the
    CUDA kernel takes in their place: ρ per family (`kernel_rho`) and
    one-sided LSC rows (u ≥ 1e19; `prepare` makes it 1e20 less the pin
    offset). The kernel reads neither li.rho nor the LSC rows of li.un,
    so inputs of another kind (another ρ, a finite LSC bound) would
    otherwise leave the plain loop's answer without a word. Loop inputs
    that carry the mark (`LoopInputs.mark_kernel_rows`: the preparation
    kernel's, their `take` and `resume`, or a batch checked before in
    the same state) pass at once; any other costs one host
    synchronisation, and then carries the mark."""
    if li.kernel_rows_marked():
        return
    ts = torch_statics(cfg, li.xi.device, li.rho.dtype)
    R_lsc = cfg.n_obs * cfg.M * cfg.N
    want = ts["kernel_rho"]
    if li.rho.shape[1:] != want.shape or li.un.shape != li.rho.shape:
        raise ValueError(f"rho {tuple(li.rho.shape)} / un {tuple(li.un.shape)}: "
                         f"need [A, {want.shape[0]}]")
    if bool(((li.rho != want).any() | (li.un[:, :R_lsc] < 0.1 * _INF).any()).item()):
        raise ValueError("the CUDA kernel takes ρ per family and one-sided LSC rows; "
                         "these loop inputs differ (use plain=True)")
    li.mark_kernel_rows()


def rescue_batch(cfg: QPConfig, li: LoopInputs, xi, z, y, feas_tol: float):
    """The compacted rescue of a batch of more than RESCUE agents after
    the main loop left it at (xi, z, y): the RESCUE agents whose iterate
    is the most infeasible (row-scaled), worst first; a stable sort keeps
    the lower index first among ties, as lax.top_k does. Returns (idx
    [RESCUE], take [RESCUE] bool: the agent is still infeasible, the
    rescue's LoopInputs, starting from the iterate)."""
    ts = torch_statics(cfg, li.xi.device, li.xi.dtype)
    Axc = _fwd(cfg, ts, li.normals, xi)
    violc = torch.clamp(torch.maximum(li.ln - Axc, Axc - li.un), min=0.0)
    resc = (violc / li.scale).amax(dim=-1)
    bad = resc >= 0.6 * feas_tol
    key = torch.where(bad, resc, -1.0)
    idx = torch.sort(key, descending=True, stable=True).indices[:RESCUE]
    sub = li.take(idx).resume(xi[idx], z[idx], y[idx])
    return idx, bad[idx], sub


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
    info: torch.Tensor  # [A] int32: 0, or the order of the KKT matrix's first non-positive pivot


def prepare_scalars(cfg: QPConfig):
    """The Python scalars of the preparation's arithmetic, each met by a
    tensor in one product (rounded once to its type), in the plain body
    and the kernel alike, and the KKT matrix's ρ_lsc and σ."""
    n, dt, tw = cfg.n, cfg.dt, cfg.terminal_weight
    return {"vel": dt / n, "acc": dt * dt / (n * (n - 1)), "vcap": 0.95 * dt / n,
            "acap": 0.95 * dt * dt / (n * (n - 1)), "tdiag": 2.0 * tw, "q": -2.0 * tw,
            "rho_lsc": cfg.rho * _RHO_SCALE["lsc"], "sigma": cfg.sigma}


def prepare(cfg: QPConfig, inputs: QPInputs, plain: bool = False) -> Prepared:
    """Everything before the ADMM loop: pins and their particular
    solution, bounds in reduced coordinates, the reduced cost, the KKT
    inverse and the warm start. CUDA tensors go to the kernel (one
    launch, no host synchronisation; its loop inputs carry the
    kernel-rows mark), CPU tensors to the plain body; `plain` forces the
    plain body on any device, for comparisons. Any other device raises."""
    global plain_cuda_calls
    dev = inputs.p0.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no QP preparation for device {dev}")
    if dev.type == "cpu" or plain:
        if dev.type == "cuda":
            plain_cuda_calls += 1
        return _prepare_plain(cfg, inputs)
    out = qp_prepare_cuda.prepare_cuda(cfg, torch_statics(cfg, dev), inputs,
                                       prepare_scalars(cfg))
    loop = LoopInputs(**{f.name: out[f.name] for f in dataclasses.fields(LoopInputs)})
    return Prepared(loop=loop.mark_kernel_rows(),
                    **{f.name: out[f.name] for f in dataclasses.fields(Prepared)
                       if f.name != "loop"})


def kkt_matrix(cfg: QPConfig, inputs: QPInputs):
    """The plain body's KKT matrix from its Kronecker structure: (Kmat [A,
    dim·K, dim·K] with rows d·K + k, Pn_dim [A, K, K] the reduced cost's
    Hessian per dimension)."""
    dev, dtype = inputs.p0.device, inputs.p0.dtype
    ts = torch_statics(cfg, dev, dtype)
    A, dim, K = inputs.p0.shape[0], cfg.dim, ts["K"]
    tdiag = prepare_scalars(cfg)["tdiag"] * inputs.terminal_mask  # [A, M]
    Pn_dim = ts["Pn_base"][None] + torch.einsum("am,mkl->akl", tdiag, ts["T_term"])
    diag_blk = (Pn_dim + ts["G_stat"][None]
                + cfg.sigma * torch.eye(K, dtype=dtype, device=dev)[None])
    S_lsc = torch.einsum("aomd,aome->amde", inputs.lsc_normals, inputs.lsc_normals)
    Kmat = (cfg.rho * _RHO_SCALE["lsc"]) * torch.einsum(
        "amde,mkl->adkel", S_lsc, ts["T_lsc"])  # [A, dim, K, dim, K]
    for d in range(dim):
        Kmat[:, d, :, d, :] += diag_blk
    return Kmat.reshape(A, dim * K, dim * K), Pn_dim


def _prepare_plain(cfg: QPConfig, inputs: QPInputs) -> Prepared:
    """prepare's plain version (the torch body). A KKT matrix that is not
    positive definite gets a NaN inverse and its pivot's order in `info`,
    as jnp.linalg.cholesky gives NaN; nothing raises and nothing is read
    back to the host. Runs in the inputs' dtype."""
    dev, dtype = inputs.p0.device, inputs.p0.dtype
    ts = torch_statics(cfg, dev, dtype)
    sc = prepare_scalars(cfg)
    A = inputs.p0.shape[0]
    dim, M, n, N = cfg.dim, cfg.M, cfg.n, cfg.N
    MN = M * N
    N_null = ts["N_null"]

    pins = pinned_values(cfg, inputs.p0, inputs.v0, inputs.a0)  # [A, dim, phi]
    xpart = torch.einsum("vp,adp->adv", ts["X_pin"], pins)  # [A, dim, MN]
    l, u, rho = constraint_bounds(cfg, inputs)
    b_off = _rows_batched(cfg, xpart.reshape(A, dim, M, N), inputs.lsc_normals)
    ln, un = l - b_off, u - b_off

    # reduced cost
    tdiag = sc["tdiag"] * inputs.terminal_mask  # [A, M]
    tvec = torch.zeros((A, M, N), dtype=dtype, device=dev)
    tvec[:, :, n] = tdiag
    tvec = tvec.reshape(A, 1, MN)
    q = torch.zeros((A, dim, M, N), dtype=dtype, device=dev)
    q[..., n] = sc["q"] * inputs.terminal_mask[:, None, :] * inputs.goal[..., None]
    qflat = q.reshape(A, dim, MN)
    # qn = N_nullᵀ(q + P·xpart) is a small difference of terms up to ~1e2
    # times its size (N_nullᵀ·P_base·X_pin is ~0: X_pin is the minimum-jerk
    # particular solution): its float32 rounding, which depends on the
    # order of the sums, is as large as qn itself for agents far from the
    # origin, as in the JAX package's identical formulation
    Pxp = torch.einsum("vw,adw->adv", ts["P_base"], xpart) + tvec * xpart
    qn = torch.einsum("vk,adv->adk", N_null, qflat + Pxp)  # [A, dim, K]

    # KKT matrix from Kronecker structure, inverted once
    Kmat, Pn_dim = kkt_matrix(cfg, inputs)
    chol, info = torch.linalg.cholesky_ex(Kmat)
    chol = torch.where((info != 0)[:, None, None], float("nan"), chol)
    eye_dk = torch.eye(Kmat.shape[-1], dtype=dtype, device=dev).expand(Kmat.shape)
    Kinv = torch.cholesky_solve(eye_dk, chol)

    # residual row scale (matches the caller's feasibility gate)
    scale = torch.clamp(6.0 * (0.5 * (u - l)), 0.02, 1.0)

    xi0 = torch.einsum("vk,adv->adk", N_null, inputs.x0.reshape(A, dim, MN) - xpart)
    z0 = _fwd(cfg, ts, inputs.lsc_normals, xi0)
    y0 = torch.zeros_like(z0) if inputs.y0 is None else inputs.y0.to(dtype)
    loop = LoopInputs(normals=inputs.lsc_normals, Kinv=Kinv, Pn=Pn_dim, qn=qn,
                      ln=ln, un=un, rho=rho, scale=scale, xi=xi0, z=z0, y=y0)
    return Prepared(loop=loop, xpart=xpart, b_off=b_off, l=l, u=u, tvec=tvec,
                    qflat=qflat, info=info)


def solve(cfg: QPConfig, inputs: QPInputs, feas_tol: float = 5e-3,
          plain: bool = False) -> QPResult:
    """Solve all agents' QPs in one batched ADMM, then rescue the
    stragglers (small fleets in place; above RESCUE agents the worst
    RESCUE are compacted into one batch). `plain` forces the plain
    preparation and loop on any device, for comparisons; the plain path
    runs in the inputs' dtype (float64: `qp_check.solve_f64`)."""
    pr = prepare(cfg, inputs, plain)
    li = pr.loop
    A = li.xi.shape[0]
    dim, M, N = cfg.dim, cfg.M, cfg.N
    ts = torch_statics(cfg, li.xi.device, li.xi.dtype)

    xi, z, y, itdone, iters = run_loop(cfg, li, cfg.max_iter, feas_tol, plain)

    if cfg.rescue_iter > 0 and A <= RESCUE:
        cont = li.resume(xi, z, y)
        xi, z, y, itdone2, iters2 = run_loop(cfg, cont, cfg.rescue_iter, feas_tol, plain)
        itdone = (torch.clamp(itdone, max=cfg.max_iter)
                  + torch.minimum(itdone2, iters2)).to(torch.int32)
        iters = iters + iters2
    elif cfg.rescue_iter > 0:
        idx, take, sub = rescue_batch(cfg, li, xi, z, y, feas_tol)
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
