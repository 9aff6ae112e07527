#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the fused fleet planning step on the bench
workload (`lsc_dr_planner_tpu_torch.workload.build_fleet(1024)`: 1024
agents, M=10, n=5, 16 neighbour slots, a forest world), on the card:

  1. environment: torch/CUDA versions, nvcc, the card's name and power limit;
  2. build the ADMM kernel (csrc/admm.cu) with nvcc;
  3. kernel against the plain loop for one chunk (8 iterations) on the
     main path's QP: iterates within rtol 1e-4 / atol 1e-5, itdone equal
     on ≥ 99.5% of agents; then many chunks on a ragged fleet (A=37) that
     exits before max_iter: the kernel's state is the plain loop's
     iterate after the kernel's exit iteration (rtol 1e-4 / atol 1e-5),
     and the launches after the exit leave it bitwise unchanged;
  4. the full solve (200 iterations + 800 rescue) with the kernel and with
     the plain loop at A=1024 and A=1000: converged share within 0.5
     points, objectives (evaluated in float64) within rtol/atol 2e-2 and
     control points within 0.1 where both converged;
  5. the main path: 3 warm-up and 20 timed evolving steps; the kernel must
     have been launched, every output finite, mean QP convergence > 0.9
     and no two agents closer than 2·radius − feas_tol.

Prints the results of each phase, a JSON line of per-kernel results, the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, with no result, without a
CUDA device or outside a checkout of the repository. Writes the full
record to chiprun_out/chip_smoke.json.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
A_MAIN = 1024
WARMUP, TIMED = 3, 20


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def gpu_line():
    return sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])


def cuda_ms(fn, reps):
    """Mean device-timeline milliseconds of fn() over reps calls."""
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


def evolved_qp(workload, A, dev, steps=3):
    p, planner, fleet, inp = workload.build_fleet(A, device=dev)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(steps):
        inp, _ = step(inp)
    d = planner._step_impl(fleet, inp, defer_qp=True)
    return planner, d.qp_inp


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures the port on a GPU")
    sys.path.insert(0, str(ROOT))
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.ops import qp, qp_cuda

    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    record = {"gpu": gpu}

    # ---- 1. environment ----------------------------------------------
    nvcc = sh([qp_cuda.nvcc_path(), "--version"]).splitlines()[-1]
    env = {"torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": nvcc,
           "python": sys.version.split()[0], "gpu": gpu}
    print("env", json.dumps(env))
    record["env"] = env

    # ---- 2. kernel build ---------------------------------------------
    t0 = time.perf_counter()
    lib = qp_cuda.build(verbose=True)
    build_s = time.perf_counter() - t0
    print(f"build admm.cu: {build_s:.2f} s (nvcc {qp_cuda.build_seconds} s)")
    record["build_s"] = build_s

    # ---- 3. kernel vs plain loop, one chunk ----------------------------
    planner, qp_inp = evolved_qp(workload, A_MAIN, dev)
    cfg, feas_tol = planner.qp_cfg, planner.feas_tol
    ts = qp.torch_statics(cfg, dev)
    print("smem bytes per block:", lib.admm_smem_bytes(
        cfg.dim, cfg.n_obs, cfg.M, cfg.N, ts["K"], ts["An_stat"].shape[0]))
    li = qp.prepare(cfg, qp_inp).loop
    got = qp.run_loop(cfg, li, 8, feas_tol)
    want = qp.admm_loop_plain(cfg, li, 8, feas_tol)
    torch.cuda.synchronize()
    max_abs_err = 0.0
    for name, a, b in zip(("xi", "z", "y"), got[:3], want[:3]):
        assert torch.isfinite(a).all(), name
        err = (a - b).abs().max().item()
        max_abs_err = max(max_abs_err, err)
        print(f"phase3 {name}: max|kernel-plain| = {err:.3e}")
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    itd_agree = (got[3] == want[3]).float().mean().item()
    print(f"phase3 itdone agreement {itd_agree:.4f}, iters {int(got[4])} / {int(want[4])}")
    assert itd_agree >= 0.995, itd_agree
    record["phase3"] = {"max_abs_err": max_abs_err, "itdone_agreement": itd_agree}

    # many chunks, global exit before max_iter (A=37: no block multiple)
    planner37, qp_inp37 = evolved_qp(workload, 37, dev)
    cfg37 = planner37.qp_cfg
    li37 = qp.prepare(cfg37, qp_inp37).loop
    feas37 = planner37.feas_tol
    got = qp.run_loop(cfg37, li37, cfg37.max_iter, feas37)
    stop = int(got[4])
    assert stop < cfg37.max_iter, f"A=37 should exit before {cfg37.max_iter}, ran {stop}"
    again = qp.run_loop(cfg37, li37, stop, feas37)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "launches after the exit moved"
    # the plain loop's iterate after `stop` iterations (feas_tol=0: no exit)
    want = qp.admm_loop_plain(cfg37, li37, stop, 0.0)
    gates = qp.admm_loop_plain(cfg37, li37, cfg37.max_iter, feas37)
    err_exit = max((a - b).abs().max().item() for a, b in zip(got[:3], want[:3]))
    rel_exit = max(((a - b).abs() / (1e-5 + 1e-4 * b.abs())).max().item()
                   for a, b in zip(got[:3], want[:3]))
    print(f"phase3 A=37: kernel exits at {stop} (plain loop's own exit: {int(gates[4])}); "
          f"max|kernel-plain| {err_exit:.3e} at the exit, {rel_exit:.3f} of the tolerance")
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    max_abs_err = max(max_abs_err, err_exit)
    record["phase3"]["A37"] = {"kernel_exit": stop, "plain_exit": int(gates[4]),
                               "max_abs_err_at_exit": err_exit,
                               "share_of_tolerance": rel_exit}

    # loop-only times at the main path's shapes (A=1024, max_iter=200)
    ms_kernel = cuda_ms(lambda: qp.run_loop(cfg, li, cfg.max_iter, feas_tol), 5)
    ms_plain = cuda_ms(lambda: qp.admm_loop_plain(cfg, li, cfg.max_iter, feas_tol), 3)
    print(f"ADMM loop A={A_MAIN} max_iter={cfg.max_iter}: kernel {ms_kernel:.3f} ms, "
          f"plain {ms_plain:.3f} ms [{gpu}]")
    record["loop_ms"] = {"kernel": ms_kernel, "plain": ms_plain}

    # ---- 4. full solve, kernel vs plain --------------------------------
    record["phase4"] = {}
    for A in (A_MAIN, 1000):
        if A != A_MAIN:
            planner, qp_inp = evolved_qp(workload, A, dev)
        out = qp.solve(planner.qp_cfg, qp_inp, feas_tol)
        ref = qp.solve(planner.qp_cfg, qp_inp, feas_tol, plain=True)
        torch.cuda.synchronize()
        ck, cp = out.converged.float().mean().item(), ref.converged.float().mean().item()
        both = out.converged & ref.converged
        # objectives of both solutions evaluated in float64: the float32
        # objective of agents ~20 m from the origin carries ~1e-2 relative
        # cancellation noise even for identical control points
        pr = qp.prepare(planner.qp_cfg, qp_inp)
        obj_k = qp.objective(planner.qp_cfg, pr, out.x.double())
        obj_p = qp.objective(planner.qp_cfg, pr, ref.x.double())
        obj_err = (obj_k - obj_p).abs()[both].max().item()
        obj32_err = (out.objective - ref.objective).abs()[both].max().item()
        dx = (out.x - ref.x).abs()[both].max().item()
        t_k = cuda_ms(lambda: qp.solve(planner.qp_cfg, qp_inp, feas_tol), 3)
        t_p = cuda_ms(lambda: qp.solve(planner.qp_cfg, qp_inp, feas_tol, plain=True), 2)
        print(f"phase4 A={A}: converged kernel {ck:.4f} plain {cp:.4f}; "
              f"max|dobj| {obj_err:.3e} (float32 evaluation: {obj32_err:.3e}), "
              f"max|dx| {dx:.3e}; "
              f"solve kernel {t_k:.2f} ms, plain {t_p:.2f} ms [{gpu}]")
        assert torch.isfinite(out.x).all()
        assert ck >= cp - 0.005, (ck, cp)
        torch.testing.assert_close(obj_k[both], obj_p[both], rtol=2e-2, atol=2e-2)
        assert dx < 0.1, dx
        record["phase4"][A] = {"converged_kernel": ck, "converged_plain": cp,
                               "max_obj_err": obj_err, "max_obj_err_f32": obj32_err,
                               "max_dx": dx,
                               "solve_ms_kernel": t_k, "solve_ms_plain": t_p}

    # ---- 5. main path --------------------------------------------------
    p, planner, fleet, inp = workload.build_fleet(A_MAIN, device=dev, timing=True)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(WARMUP):
        inp, conv = step(inp)
    torch.cuda.synchronize()
    qp_cuda.launches = 0
    lat, convs, stages = [], [], []
    min_dist = float("inf")
    eye = torch.eye(A_MAIN, device=dev) * 1e9
    for _ in range(TIMED):
        t0 = time.perf_counter()
        inp, conv = step(inp)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        stages.append(planner.stage_times_ms())
        convs.append(conv.float().mean().item())
        assert inp.prev_ctrl.shape == (A_MAIN, p.M, p.n + 1, 3), inp.prev_ctrl.shape
        for name in ("pos", "vel", "acc", "prev_ctrl", "current_goal", "qp_y0"):
            assert torch.isfinite(getattr(inp, name)).all(), name
        pos = inp.pos[:, :2]
        min_dist = min(min_dist, (torch.cdist(pos, pos) + eye).min().item())
    launches = qp_cuda.launches
    lat = np.asarray(lat)
    conv_mean = float(np.mean(convs))
    stage_ms = {k: float(np.mean([s[k] for s in stages])) for k in stages[0]}
    main = {"A": A_MAIN, "steps": TIMED, "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "agent_steps_per_s": A_MAIN * TIMED / float(lat.sum()),
            "qp_convergence": conv_mean, "min_pair_distance": min_dist,
            "kernel_launches": launches, "stage_ms": stage_ms, "gpu": gpu}
    print("main path", json.dumps(main))
    assert launches > 0, "the main path never launched the ADMM kernel"
    assert conv_mean > 0.9, conv_mean
    assert min_dist >= 2 * 0.15 - planner.feas_tol, min_dist
    record["main"] = main

    kernels = [{
        "name": "admm_loop", "route": "cuda",
        "source": "lsc_dr_planner_tpu_torch/csrc/admm.cu",
        "replaces": "lsc_dr_planner_tpu/ops/qp_pallas.py:67",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": ms_kernel, "plain_ms": ms_plain,
    }]
    record["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
