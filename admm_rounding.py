#!/usr/bin/env python3
"""Which float32 roundings of the ADMM loop kernel move its iterate away
from the float64 plain loop, on the CPU.

    python3 admm_rounding.py [--A 256] [--iters 200] [--variants all,base,d,...]

Builds phase 8e's kind of batch (`workload.build_fleet(A)` in 3-D DLSC
after 3 evolving steps, its next QP prepared by the plain body) and runs
the loop of `csrc/admm.cu` in double, rounding to float32 only where a
variant says (one letter a rounding):

- `a`: the cotangent ρz − y;
- `b`: the adjoint's control-point accumulator VA;
- `c`: Aᵀ(ρz − y) in ξ-space;
- `d`: rhs = (σξ − q) + Aᵀ(ρz − y), two roundings;
- `e`: ξ̃ = Kinv·rhs;
- `g`: the LSC rows, summed in float32 from the rounded control points;
- `i`: the row update (relaxation, projection, dual update);
- `x`: ξ's relaxation.

Every variant stores ξ, z and y as float32 after each iteration, and
takes the static rows in double from the control points, as the kernel
does. `all` is every letter (the kernel before its rhs, ξ̃ and LSC
rows were carried in double); `abix` is the kernel now. For each
variant and tensor (ξ, z, y): the largest and the 90th percentile over
agents of `qp_check.agent_shares` against the float64 plain loop, and
the float32 plain loop's beside them. One JSON line a variant.
"""

import argparse
import json

import torch

from lsc_dr_planner_tpu_torch import workload
from lsc_dr_planner_tpu_torch.config import PlannerMode
from lsc_dr_planner_tpu_torch.ops import qp, qp_check

LETTERS = "abcdegix"


def batch(A):
    """(cfg, LoopInputs) of phase 8e's kind at A agents, on the CPU."""
    p, planner, fleet, inp = workload.build_fleet(A, device="cpu", world_dimension=3,
                                                  planner_mode=PlannerMode.DLSC)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(3):
        inp, _ = step(inp)
    cfg = planner.qp_cfg
    return cfg, qp.prepare(cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp).loop


def emulated_loop(cfg, li, iters, rounded, store32=True):
    """(ξ, z, y) after `iters` iterations of the kernel's loop in double,
    rounded to float32 at the steps named by the letters of `rounded`,
    and (with `store32`) where the kernel stores the state and the static
    rows."""
    ts = qp.torch_statics(cfg, torch.device("cpu"), torch.float64)
    N3k, idx, coef = ts["N3k"], ts["stencil"]["idx"].long(), ts["stencil"]["coef"].double()
    dim, O, M, N, K = cfg.dim, cfg.n_obs, cfg.M, cfg.N, ts["K"]
    MN = M * N
    L = qp_check.as_f64(li)
    B = L.xi.shape[0]
    nrm = L.normals[:, :, torch.arange(MN) // N, :]  # [B, O, MN, dim]
    f = {k: (lambda t: t.float().double()) if k in rounded else (lambda t: t) for k in LETTERS}
    r32 = (lambda t: t.float().double()) if store32 else (lambda t: t)
    xi, z, y, qn = L.xi.reshape(B, dim, K), L.z, L.y, L.qn.reshape(B, dim, K)
    a, b = cfg.alpha, 1 - cfg.alpha
    for _ in range(iters):
        w = f["a"](L.rho * z - y)
        VA = torch.einsum("bomd,bom->bdm", nrm, w[:, :O * MN].reshape(B, O, MN)).reshape(B, -1)
        VA = VA.index_add(1, idx.reshape(-1), (coef * w[:, O * MN:, None]).reshape(B, -1))
        g = f["c"](torch.einsum("km,bdm->bdk", N3k, f["b"](VA).reshape(B, dim, MN)))
        rhs = f["d"](f["d"](cfg.sigma * xi - qn) + g)
        xt = f["e"](torch.einsum("bij,bj->bi", L.Kinv, rhs.reshape(B, -1))).reshape(B, dim, K)
        V = torch.einsum("bdk,km->bdm", xt, N3k)
        if "g" in rounded:
            Vf, nf = V.float(), nrm.float()
            acc = nf[..., 0] * Vf[:, None, 0]
            for d in range(1, dim):
                acc = acc + nf[..., d] * Vf[:, None, d]
            zl = acc.double().reshape(B, -1)
        else:
            zl = torch.einsum("bomd,bdm->bom", nrm, V).reshape(B, -1)
        zs = r32((coef * V.reshape(B, -1)[:, idx]).sum(-1))
        zt = torch.cat([zl, zs], 1)
        xi = r32(f["x"](a * xt + b * xi))
        zmix = f["i"](a * zt + b * z)
        zn = torch.minimum(torch.maximum(f["i"](zmix + f["i"](y / L.rho)), L.ln), L.un)
        y = r32(f["i"](y + f["i"](L.rho * f["i"](zmix - zn))))
        z = r32(zn)
    return xi.reshape(L.xi.shape), z, y


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--A", type=int, default=256)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--variants", default="all,abix,base," + ",".join(LETTERS))
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    cfg, li = batch(args.A)
    exact = qp.admm_loop_plain(cfg, qp_check.as_f64(li), args.iters, 0.0)
    plain = qp.admm_loop_plain(cfg, li, args.iters, 0.0)
    runs = [("float32 plain loop", plain)] + [
        (v, emulated_loop(cfg, li, args.iters, {"all": LETTERS, "base": ""}.get(v, v)))
        for v in args.variants.split(",")]
    for name, got in runs:
        rec = {"variant": name, "A": args.A, "iters": args.iters}
        for t, g, x in zip("xzy", got[:3], exact[:3]):
            s = qp_check.agent_shares(g.double(), x)
            rec[t] = {"max": float(s.max()), "p90": float(s.quantile(0.9))}
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
