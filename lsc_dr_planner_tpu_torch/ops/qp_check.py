"""Checks of the QP kernels against their plain versions, used by
`chip_smoke.py` and the tests; no planner path calls them.

- Two QP preparations (the kernel's against the plain body's): which
  outputs must be equal, the tolerance of each float32 sum from its
  length and its terms' magnitude, and Kinv's distance from a float64
  inverse.
- An ADMM loop run against float64 (`float32_envelope`,
  `whole_run_f64`): two float32 loops that sum in different orders
  drift apart on ill-conditioned batches, so the loop kernel is held to
  the float64 plain loop, as far from it as F64_FACTOR times the float32
  plain loop's own spread; and a whole solve's reference in float64
  (`solve_f64`).
"""

from __future__ import annotations

import dataclasses

import torch

from lsc_dr_planner_tpu_torch.ops.qp import (LoopInputs, Prepared, QPConfig, QPInputs,
                                             QPResult, admm_loop_plain, prepare_scalars, solve,
                                             torch_statics)

# the float64 criterion, per agent: the kernel within F64_FACTOR times the
# float32 plain loop's distance from float64 over ENVELOPE_RUNS runs
F64_FACTOR, ENVELOPE_RUNS = 5.0, 8

# outputs the kernel computes with the plain body's float32 operations,
# or copies: equal, element for element
EQUAL_FIELDS = ("l", "u", "rho", "scale", "tvec", "qflat", "y", "normals")
SUM_FIELDS = ("xpart", "b_off", "ln", "un", "qn", "xi", "z", "Pn")


def field(pr: Prepared, name: str):
    return getattr(pr, name) if hasattr(pr, name) else getattr(pr.loop, name)


def _rows_abs(cfg: QPConfig, ts, nrm_abs, x):
    """|A|·x for x ≥ 0 [A, dim, M, N]: the rows with every coefficient
    taken by its absolute value ([A, R], float64)."""
    A = x.shape[0]
    st = ts["stencil"]
    lsc = torch.einsum("aomd,admi->aomi", nrm_abs, x).reshape(A, -1)
    stat = (x.reshape(A, -1)[:, st["idx"].long()] * st["coef"].abs()).sum(-1)
    return torch.cat([lsc, stat], dim=-1)


def prepare_tolerances(cfg: QPConfig, inputs: QPInputs, pr: Prepared):
    """{name: tolerance} for each sum of `SUM_FIELDS` that `pr` (a
    preparation of `inputs`) holds: L·2⁻²³·Σ|terms|, where Σ|terms| is the
    sum taken over the absolute values of everything that enters it, down
    to the inputs, and L the longest chain of float32 roundings that leads
    to it in the plain body (each rounding errs by at most 2⁻²⁴ of its
    terms' magnitude); two float32 evaluations in different orders, each
    within L·2⁻²⁴·Σ|terms| of the exact value, differ by at most the
    tolerance. Vacuous rows (|l|, |u| ≥ 1e19) are not covered: both sides
    give ±1e20 there exactly."""
    dev = inputs.p0.device
    ts = torch_statics(cfg, dev, torch.float64)
    sc = prepare_scalars(cfg)
    A, dim, M, N = inputs.p0.shape[0], cfg.dim, cfg.M, cfg.N
    MN, K = M * N, ts["K"]

    def ab(t):
        return t.double().abs()

    N_abs = ts["N_null"].abs()
    nrm = ab(inputs.lsc_normals)
    p, c1 = ab(inputs.p0), ab(inputs.p0) + ab(inputs.v0) * abs(sc["vel"])
    pins = torch.stack([p, c1, ab(inputs.a0) * abs(sc["acc"]) + 2 * c1 + p], dim=-1)
    xp = torch.einsum("vp,adp->adv", ts["X_pin"].abs(), pins)  # [A, dim, MN]
    b = _rows_abs(cfg, ts, nrm, xp.reshape(A, dim, M, N))
    inner = (ab(pr.qflat) + torch.einsum("vw,adw->adv", ts["P_base"].abs(), xp)
             + ab(pr.tvec) * xp)
    xi = torch.einsum("vk,adv->adk", N_abs, ab(inputs.x0).reshape(A, dim, MN) + xp)
    cp = torch.einsum("vk,adk->adv", N_abs, xi).reshape(A, dim, M, N)
    tdiag = abs(sc["tdiag"]) * ab(inputs.terminal_mask)
    lu = {name: torch.where(ab(getattr(pr, name)) < 1e19, ab(getattr(pr, name)), 0.0)
          for name in ("l", "u")}
    mags = {  # name: (chain length L, Σ|terms|)
        "xpart": (8, xp), "b_off": (12, b), "ln": (13, lu["l"] + b), "un": (13, lu["u"] + b),
        "qn": (2 * MN + 10, torch.einsum("vk,adv->adk", N_abs, inner)),
        "xi": (MN + 9, xi), "z": (MN + 10 + dim * K, _rows_abs(cfg, ts, nrm, cp)),
        "Pn": (M + 2, ts["Pn_base"].abs()[None]
               + torch.einsum("am,mkl->akl", tdiag, ts["T_term"].abs())),
    }
    return {name: L * 2.0 ** -23 * mag for name, (L, mag) in mags.items()}


def prepare_agreement(cfg: QPConfig, inputs: QPInputs, got: Prepared, want: Prepared):
    """How far `got` departs from `want`, two preparations of `inputs`:
    per field of `EQUAL_FIELDS` (and `info`) the elements that differ by
    value (a NaN equal to a NaN); per sum of `SUM_FIELDS` the largest
    |got − want| over its tolerance (`prepare_tolerances`, from `want`;
    at most 1 agrees) and the vacuous entries (|want| ≥ 1e19) that
    differ."""
    tol = prepare_tolerances(cfg, inputs, want)
    rec = {"differing": {}, "share_of_tolerance": {}, "vacuous_differing": {}}
    for name in (*EQUAL_FIELDS, "info"):
        g, w = field(got, name), field(want, name)
        same = (g == w) | (g.isnan() & w.isnan()) if g.is_floating_point() else g == w
        rec["differing"][name] = int((~same).sum())
    for name in SUM_FIELDS:
        g, w = field(got, name).double(), field(want, name).double()
        vac = w.abs() >= 1e19
        diff = (g - w).abs()
        share = torch.where(vac | (diff == 0), 0.0, diff / tol[name])
        rec["share_of_tolerance"][name] = float(share.nan_to_num(float("inf")).max())
        rec["vacuous_differing"][name] = int((vac & (g != w)).sum())
    return rec


def kinv_distance(Kinv, Kmat):
    """Per agent, max|Kinv − K⁻¹| / max|K⁻¹|, where K⁻¹ is the float64
    inverse of the KKT matrix Kmat [A, dk, dk]."""
    ref = torch.linalg.inv(Kmat.double())
    return ((Kinv.double() - ref).abs().amax(dim=(1, 2))
            / ref.abs().amax(dim=(1, 2)))


def agent_shares(a, b):
    """Per agent: the largest |a − b| over rtol 1e-4 of the agent's
    largest |b| / atol 1e-5 [B]."""
    d, m = (a - b).abs().flatten(1), b.abs().flatten(1)
    return d.amax(1) / (1e-5 + 1e-4 * m.amax(1))


def as_f64(li: LoopInputs) -> LoopInputs:
    return LoopInputs(*(getattr(li, f.name).double() for f in dataclasses.fields(li)))


def solve_f64(cfg: QPConfig, inputs: QPInputs, feas_tol: float) -> QPResult:
    """qp.solve's plain path in float64 on `inputs` taken to float64: the
    preparation (the KKT inverse among it), the loop, the rescue and the
    result. The reference for the float32 solves: the float32 plain
    preparation inverts the KKT matrix in float32 (~cond·2⁻²⁴ relative
    error), the kernel in double rounded once, and ADMM's fixed point
    moves with the inverse it is given."""
    f64 = {f.name: getattr(inputs, f.name) for f in dataclasses.fields(inputs)}
    f64 = {k: v.double() if v is not None and v.is_floating_point() else v
           for k, v in f64.items()}
    return solve(cfg, QPInputs(**f64), feas_tol, plain=True)


def float32_envelope(cfg: QPConfig, state: LoopInputs, iters: int, feas_tol: float, plain,
                     exact, seed: int):
    """Per tensor (xi, z, y), each agent's largest distance (agent_shares)
    from the float64 plain run `exact` over ENVELOPE_RUNS float32 plain
    runs of `iters` iterations: `plain`, from `state`, and runs from
    `state` with every entry of xi, z and y moved one ulp up or down at
    random (seeded): how far float32 rounding alone puts that agent's run
    [3 x B]."""
    g = torch.Generator(device=state.xi.device).manual_seed(seed)

    def nudge(v):
        up = torch.rand(v.shape, generator=g, device=v.device) < 0.5
        return torch.nextafter(v, torch.where(up, torch.inf, -torch.inf).to(v.dtype))

    env = [agent_shares(b.double(), x) for b, x in zip(plain[:3], exact[:3])]
    for _ in range(ENVELOPE_RUNS - 1):
        moved = dataclasses.replace(state, xi=nudge(state.xi), z=nudge(state.z),
                                    y=nudge(state.y))
        run = admm_loop_plain(cfg, moved, iters, feas_tol)
        env = [torch.maximum(v, agent_shares(b.double(), x))
               for v, b, x in zip(env, run[:3], exact[:3])]
    return env


def whole_run_f64(cfg: QPConfig, li: LoopInputs, got, seed: int = 0):
    """The loop kernel's whole run `got` (run_loop's (xi, z, y, itdone,
    iters) from `li`) against the float64 plain loop after as many
    iterations (feas_tol = 0 turns its exit off). Per agent and tensor
    (xi, z, y) it passes within one tolerance (`agent_shares`) of the
    float64 iterate, or within F64_FACTOR times the float32 plain loop's
    envelope (`float32_envelope` over the whole run). A float32 loop
    integrates every iteration's rounding in the duals of active rows,
    so after ~200 iterations two float32 loops that sum in different
    orders can lie several tolerances apart from identical inputs, and
    one run alone can land near float64 by luck. Returns {"iterations",
    "agents_failed" (agent-tensor cases that fail), "ratio_max" (the
    largest ratio to the envelope among the cases more than one
    tolerance from float64; 0 if none), "kernel_vs_f64",
    "plain_vs_f64" (the largest agent_shares), "worst" (up to 5 cases:
    ratio, tensor, agent, kernel's, envelope's)}."""
    stop = int(got[4])
    want = admm_loop_plain(cfg, li, stop, 0.0)
    exact = admm_loop_plain(cfg, as_f64(li), stop, 0.0)
    env = float32_envelope(cfg, li, stop, 0.0, want, exact, seed)
    rec = {"iterations": stop, "agents_failed": 0, "ratio_max": 0.0, "kernel_vs_f64": 0.0,
           "plain_vs_f64": 0.0, "worst": []}
    for t, (a, b, x) in enumerate(zip(got[:3], want[:3], exact[:3])):
        k64 = agent_shares(a.double(), x)
        rec["kernel_vs_f64"] = max(rec["kernel_vs_f64"], float(k64.max()))
        rec["plain_vs_f64"] = max(rec["plain_vs_f64"], float(agent_shares(b.double(), x).max()))
        off = k64 > 1.0
        if not off.any():
            continue
        r = torch.where(off, k64 / env[t], 0.0)
        rec["agents_failed"] += int((r > F64_FACTOR).sum())
        rec["ratio_max"] = max(rec["ratio_max"], float(r.max()))
        for i in r.argsort(descending=True)[:3].tolist():
            if r[i] > 0:
                rec["worst"].append((float(r[i]), "xzy"[t], i, float(k64[i]), float(env[t][i])))
    rec["worst"] = sorted(rec["worst"], reverse=True)[:5]
    return rec
