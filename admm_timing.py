#!/usr/bin/env python3
"""Time the port's ADMM loop on one GPU at the QP shapes its paths give it.

    python3 admm_timing.py [--root DIR]

Imports `lsc_dr_planner_tpu_torch` from DIR (default: the directory of
this script), so that one run on the card can time the kernels of two
trees of the repository in turns, for instance a `git archive` of an
earlier commit unpacked under `build/`. The shapes:

- `bench`: `workload.build_fleet(1024)` after 3 evolving steps (A=1024,
  O=16), the main path's batch;
- `rescue`: the second ADMM call of one `qp.solve` of that batch, the
  64 most infeasible agents compacted from the main loop's iterate
  (`qp.rescue_batch`; a tree whose `qp` lacks it skips this call);
- `flight64` and `flight10`: the QP of the 4th planner step of
  `forest_mission(64, seed=1)` (A=64, O=16) and `forest_mission(10)`
  (A=10, O=9) on `MultiSyncSimulator`.

`chip_smoke.py` calls `bench_calls`, `timed_call` and `kernel_report` on
the batches it checks, so that one object is compared and timed.

For each call: the iterations it ran (the global exit), its mean time
from CUDA events, µs per iteration, and the least time the card could
take for that work (`loop_bound`). Beside the loop, the main path's
per-stage device times (`step_stages`: `build_fleet(1024)`, 3 warm-up
and 20 evolving steps, CUDA events at the stage boundaries), so that
two trees' steps compare in one run. Prints one JSON object on its last
line. Exits non-zero without a CUDA device.
"""

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PEAK_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores (data sheet)
PEAK_FLOPS64 = 34e12  # H100 SXM, float64 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def gpu_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean device-timeline milliseconds of fn() over reps calls, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def loop_bound(cfg, li, iters, chunk=8):
    """(bound_ms, bound_by, flops per agent-iteration) of `iters` ADMM
    iterations of every agent of `li`, with the static rows counted as
    the stencils they are (≤ 3 nonzeros a row).

    Per agent-iteration, in double (as the kernel sums them): the LSC rows
    forward and adjoint (2·R_lsc·dim FMA), the two N3k products
    (2·dim·MN·K), the Kinv matvec (dk²), the static stencils forward and
    adjoint (2·nnz), at the FP64 rate outside the tensor cores; 15 float32
    flops of row update per row at the float32 rate; the exit test once
    per chunk (its adjoint in double; P·ξ, the feasibility and the
    reductions in float32). Bytes: every input of the loop read once
    (normals, Kinv, Pn, qn, ln, un, rho, scale, xi, z, y), every output
    written once (xi, z, y, itdone)."""
    A, O, M, dim = li.normals.shape
    K = li.Pn.shape[-1]
    N, n = cfg.N, cfg.n
    MN, dk, R = M * N, dim * K, li.z.shape[1]
    R_lsc = O * MN
    per_dim = 2 * M * n + 3 * M * (n - 1) + (2 * (M * (M + 1) // 2) if cfg.use_comm else 0) + MN
    nnz = dim * per_dim
    fma = 2 * R_lsc * dim + 2 * dim * MN * K + dk * dk + 2 * nnz
    fma_exit = R_lsc * dim + dim * MN * K + nnz
    flops64 = 2 * fma + 2 * fma_exit / chunk
    flops32 = 15 * R + (2 * dim * K * K + 4 * R + 16 * dk) / chunk
    flops = flops64 + flops32
    nbytes = 4 * A * (dk * dk + K * K + O * M * dim + 2 * dk + 6 * R + dk + 2 * R + 1)
    t_ops = A * iters * (flops64 / PEAK_FLOPS64 + flops32 / PEAK_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def timed_call(qp, cfg, li, max_iter, feas_tol, what, reps):
    """One loop call timed; its iterations, µs per iteration and bound."""
    from lsc_dr_planner_tpu_torch.ops import qp_cuda

    before = qp_cuda.launches
    out = qp.run_loop(cfg, li, max_iter, feas_tol)
    torch.cuda.synchronize()
    launches = qp_cuda.launches - before
    iters = int(out[4])
    ms = cuda_ms(lambda: qp.run_loop(cfg, li, max_iter, feas_tol), reps)
    bound_ms, bound_by, flops = loop_bound(cfg, li, iters)
    A, O = li.normals.shape[:2]
    return {"call": what, "A": A, "O": O, "R": li.z.shape[1], "max_iter": max_iter,
            "iters": iters, "launches": launches, "ms": ms,
            "us_per_iter": ms * 1e3 / max(iters, 1), "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms,
            "flops_per_agent_iter": flops}


def bench_qp(workload, A, dev, steps=3):
    p, planner, fleet, inp = workload.build_fleet(A, device=dev)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(steps):
        inp, _ = step(inp)
    return planner.qp_cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp, planner.feas_tol


def flight_qp(workload, A, seed, dev, log_dir, steps=3):
    """The QP of planner step steps+1 of forest_mission(A, seed)."""
    from lsc_dr_planner_tpu_torch.config import Param
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

    sim = MultiSyncSimulator(Param(multisim_save_result=False), workload.forest_mission(A, seed),
                             log_dir=str(log_dir), device=dev)
    for it in range(steps):
        if it:
            sim.do_step()
        sim.decentralized_mapp()
        assert sim.plan()
    sim.do_step()
    sim.decentralized_mapp()
    d = sim.planner._step_impl(sim.fleet, sim._build_step_inputs(), defer_qp=True)
    return sim.planner.qp_cfg, d.qp_inp, sim.planner.feas_tol


def bench_calls(qp, cfg, li, feas_tol, reps=10):
    """The two loop calls of one `qp.solve` of a batch of more than
    RESCUE agents, timed: the main loop from `li` (`bench`) and the
    compacted rescue from its iterate (`rescue`, where the package has
    `qp.rescue_batch`)."""
    calls = [timed_call(qp, cfg, li, cfg.max_iter, feas_tol, "bench", reps)]
    if hasattr(qp, "rescue_batch"):
        xi, z, y = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)[:3]
        sub = qp.rescue_batch(cfg, li, xi, z, y, feas_tol)[2]
        calls.append(timed_call(qp, cfg, sub, cfg.rescue_iter, feas_tol, "rescue", reps))
    return calls


def chunk_overhead(qp, qp_cuda, cfg, li):
    """ms of one launch's fixed work (state load and store, exit test,
    launch): 200 iterations with no exit, in chunks of 8 against chunks
    of 16 (25 against 13 launches)."""
    ts = qp.torch_statics(cfg, li.xi.device)

    def run(chunk):
        return qp_cuda.admm_loop_cuda(li, ts["stencil"], ts["N3k"], ts["N3kT"],
                                      cfg.rho * qp._RHO_SCALE["lsc"], cfg.max_iter, chunk,
                                      0.0, cfg.sigma, cfg.alpha, cfg.eps_abs)

    t8, t16 = cuda_ms(lambda: run(8), 5), cuda_ms(lambda: run(16), 5)
    n8, n16 = -(-cfg.max_iter // 8), -(-cfg.max_iter // 16)
    per_launch = (t8 - t16) / (n8 - n16)
    return {"ms_chunk8_no_exit": t8, "ms_chunk16_no_exit": t16,
            "ms_per_launch": per_launch, "share_of_chunk8": per_launch * n8 / t8}


def kernel_report(qp, qp_cuda, cfg, li):
    """The kernel at li's shape: shared memory per block, threads per
    block, agents resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor;
    `qp_cuda.launch_plan`) and the fixed cost of one launch."""
    lib = qp_cuda.build()
    ts = qp.torch_statics(cfg, li.xi.device)
    shape = (cfg.dim, cfg.n_obs, cfg.M, cfg.N, ts["K"], ts["stencil"]["idx"].shape[0])
    plan = qp_cuda.launch_plan(shape, li.xi.shape[0], li.xi.device)
    return {"smem_bytes": plan["smem_bytes"],
            "threads": lib.admm_threads(*shape),
            "blocks_per_sm": plan["ctas_per_sm"],
            "chunk_overhead": chunk_overhead(qp, qp_cuda, cfg, li)}


def timed_steps(step, planner, inp, steps, each=None):
    """`steps` evolving steps from `inp`: each step's wall seconds (the
    card synchronised), the planner's per-stage device ms
    (FleetPlanner(timing=True) events) and mean QP convergence; `each(inp)`
    runs after every step. Returns (inp, seconds, stage ms, convergence),
    one list entry per step."""
    lat, stages, convs = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        inp, conv = step(inp)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        stages.append(planner.stage_times_ms())
        convs.append(conv.float().mean().item())
        if each is not None:
            each(inp)
    return inp, lat, stages, convs


def mean_stages(stages):
    return {k: sum(st[k] for st in stages) / len(stages) for k in stages[0]}


def step_stages(workload, dev, A=1024, warmup=3, steps=20):
    """Mean per-stage device ms over `steps` evolving steps of
    build_fleet(A) after `warmup`."""
    p, planner, fleet, inp = workload.build_fleet(A, device=dev, timing=True)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(warmup):
        inp, _ = step(inp)
    return mean_stages(timed_steps(step, planner, inp, steps)[2])


def measure(dev, log_dir):
    """Every timing of this file, for the package on sys.path."""
    workload = importlib.import_module("lsc_dr_planner_tpu_torch.workload")
    qp = importlib.import_module("lsc_dr_planner_tpu_torch.ops.qp")
    qp_cuda = importlib.import_module("lsc_dr_planner_tpu_torch.ops.qp_cuda")
    log_dir.mkdir(parents=True, exist_ok=True)
    rec = {"package": str(Path(qp.__file__).resolve().parents[2]), "gpu": gpu_line()}
    cfg, qp_inp, feas_tol = bench_qp(workload, 1024, dev)
    li = qp.prepare(cfg, qp_inp).loop
    rec["calls"] = bench_calls(qp, cfg, li, feas_tol)
    for name, A, seed in (("flight64", 64, 1), ("flight10", 10, 0)):
        cfg_f, qp_f, tol_f = flight_qp(workload, A, seed, dev, log_dir)
        li_f = qp.prepare(cfg_f, qp_f).loop
        rec["calls"].append(timed_call(qp, cfg_f, li_f, cfg_f.max_iter, tol_f, name, 20))
    rec.update(kernel_report(qp, qp_cuda, cfg, li))
    rec["main_path_stage_ms"] = step_stages(workload, dev)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose lsc_dr_planner_tpu_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("admm_timing: no CUDA device; this script times the kernel on a GPU")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    rec = measure(torch.device("cuda", 0), ROOT / "chiprun_out" / "admm_timing")
    for c in rec["calls"]:
        print(json.dumps(c))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
