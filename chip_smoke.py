#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths on the card: the fused fleet planning step
on the bench workload (`lsc_dr_planner_tpu_torch.workload.build_fleet(1024)`:
1024 agents, M=10, n=5, 16 neighbour slots, a forest world), and the
simulator (`sim.simulator.MultiSyncSimulator` with its MAPF waypoint
layer and audit, and the `sim.run` CLI) flying forest missions:

  1. environment: torch/CUDA versions, nvcc, the card's name and power limit;
  2. build the ADMM kernel (csrc/admm.cu) with nvcc, printing ptxas's
     registers and spills;
  3. kernel against the plain loop for one chunk (8 iterations) on the
     main path's QP: iterates within rtol 1e-4 / atol 1e-5, itdone equal
     on ≥ 99.5% of agents; then many chunks on a ragged fleet (A=37) that
     exits before max_iter: the kernel's state is the plain loop's
     iterate after the kernel's exit iteration (rtol 1e-4 / atol 1e-5),
     and the launches after the exit leave it bitwise unchanged; then
     the loop timings of `admm_timing.py` on this phase's A=1024/O=16
     batch and on the 64-agent rescue compacted from its iterate
     (iterations run, ms, µs per iteration, bound and its share), the
     agents resident per SM and the fixed cost of one launch;
  4. the full solve (200 iterations + 800 rescue) with the kernel and with
     the plain loop at A=1024 and A=1000: converged share within 0.5
     points, objectives (evaluated in float64) within rtol/atol 2e-2 and
     control points within 0.1 where both converged;
  5. the main path: 3 warm-up and 20 timed evolving steps; the kernel must
     have been launched, every output finite, mean QP convergence > 0.9
     and no two agents closer than 2·radius − feas_tol;
  6. the reference size: `workload.forest_mission(10)` (O = 9 neighbour
     slots, the in-place rescue) flown to its goals on the card by
     `MultiSyncSimulator.run`, at most 300 planner iterations, then once
     more through the CLI (`sim.run --device cuda`);
  7. the repo's scaled forest: `forest_mission(64, seed=1)` flown to its
     goals, at most 400 planner iterations; its first 5 steps are rerun
     from checkpoints on the card and by a CPU simulator (the plain torch
     loop): positions and waypoints identical (host state, before the
     QP), control points within 0.1 m where both QPs converged.
Each flight must pass the audit (no collision, no QP failure, safety
ratio ≥ 1, no velocity or acceleration excess, finite flight time), use
the native MAPF backend and launch the ADMM kernel. Each flight is
checkpointed after the planner steps of CK_STEPS; on the QP of the step
that follows each checkpoint, the kernel is held against the plain loop
as in phase 3 (every chunk per agent within rtol 1e-4 / atol 1e-5, and
the run to the kernel's own exit), and the loop is timed on the QP of
planner step 4 (A=64/O=16 and A=10/O=9).

Prints the results of each phase, a JSON line of per-kernel results, the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, with no result, without a
CUDA device or outside a checkout of the repository. Writes the full
record to chiprun_out/chip_smoke.json.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import admm_timing  # noqa: E402
A_MAIN = 1024
WARMUP, TIMED = 3, 20
# (phase, agents, mission seed, max planner iterations). Seed 0 of the
# 64-agent forest wedges one agent 3.3 m short of its goal in the JAX
# package and the port alike (its waypoint layer, not the planner step),
# so the flight to the goals takes seed 1.
FLIGHTS = ((6, 10, 0, 300), (7, 64, 1, 400))
# planner steps after which each flight is checkpointed; phase 7 reruns
# the step after each of the first PARITY_STEPS on the CPU
CK_STEPS = (1, 2, 3, 4, 5, 30)
PARITY_STEPS = 5
TIMED_CK = 2  # the loop is timed on the QP of the step after CK_STEPS[2]


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def gpu_line():
    return sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])


cuda_ms = admm_timing.cuda_ms


def run_checkpointed(sim, max_iter, ck_dir):
    """`sim.run()` to the goals in pieces: one call up to each planner
    step of CK_STEPS, a checkpoint after it, then one call for the rest
    (at most max_iter planner iterations in all, as one run() call).
    Returns (run()'s summary, checkpoint paths)."""
    cks, done = [], 0
    for k in CK_STEPS:
        sim.run(max_iterations=k - done + 1)
        assert sim.planner_seq == k, (sim.planner_seq, k)
        cks.append(str(ck_dir / f"ck{k}.npz"))
        sim.save_checkpoint(cks[-1])
        done = k
    return sim.run(max_iterations=max_iter - done), cks


def shares(a, b):
    """|a − b| as a share of the tolerance rtol 1e-4 / atol 1e-5 about b:
    (element by element, per agent against its largest |b|)."""
    d, m = (a - b).abs().flatten(1), b.abs().flatten(1)
    return ((d / (1e-5 + 1e-4 * m)).max().item(),
            (d.amax(1) / (1e-5 + 1e-4 * m.amax(1))).max().item())


def as_f64(qp, li):
    return qp.LoopInputs(*(getattr(li, f.name).double() for f in dataclasses.fields(li)))


def loop_check(qp, cfg, li, feas_tol, what):
    """The kernel against the plain loop on one QP batch (qp.LoopInputs).

    - Every 8-iteration chunk of the kernel's run up to its own exit,
      launched alone from the kernel's state at the chunk's start (the
      first from the QP's inputs), against the plain chunk from the same
      state: within rtol 1e-4 of the agent's largest entry / atol 1e-5.
      Element by element the tolerance is out of float32's reach for the
      duals: a dual of an inactive row is the difference of two terms of
      the size of the agent's duals, so its error scales with those, not
      with its own value. The element-wise shares are reported, for the
      kernel and for the float32 plain loop against the float64 plain
      chunk from the same state.
    - The run is bitwise that chain of single chunks (the iterate does
      not depend on the gate state the launches carry), and the launches
      after the exit leave it bitwise unchanged.
    - The whole run against the plain loop's iterate after as many
      iterations (feas_tol=0 turns the plain loop's exit off): the
      chunks' differences add up, so it must be within one tolerance
      (element by element) per chunk run, or else no farther from the
      float64 plain iterate than the float32 plain loop is. Over 200
      iterations from large warm-started duals the float32 plain loop
      can itself drift tens of tolerances from the float64 iterate (a
      dual of an active row integrates every iteration's rounding); two
      float32 loops that sum in different orders then drift apart by as
      much, and the second clause asks the kernel to be at least as
      accurate as its oracle. Both float32 loops' distances to the
      float64 plain iterate are reported beside it.
    Returns the errors."""
    got = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)
    stop = int(got[4])
    again = qp.run_loop(cfg, li, stop, feas_tol)
    rec = {"A": int(li.z.shape[0]), "O": cfg.n_obs, "rows": int(li.z.shape[1]),
           "kernel_exit": stop}
    sh = dict.fromkeys(("elementwise", "per_agent", "kernel_vs_f64", "plain_vs_f64"), 0.0)
    chunk_err, state = 0.0, li
    for c in range(stop // 8):
        k = qp.run_loop(cfg, state, 8, feas_tol)
        p = qp.admm_loop_plain(cfg, state, 8, feas_tol)
        e = qp.admm_loop_plain(cfg, as_f64(qp, state), 8, feas_tol)
        if c == 0:
            rec["itdone_agreement"] = (k[3] == p[3]).float().mean().item()
        for a, b, x in zip(k[:3], p[:3], e[:3]):
            chunk_err = max(chunk_err, (a - b).abs().max().item())
            new = (*shares(a, b), shares(a.double(), x)[0], shares(b.double(), x)[0])
            sh = {n: max(v, w) for (n, v), w in zip(sh.items(), new)}
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    rec["max_abs_err_chunk"] = chunk_err
    rec.update({f"chunk_share_{n}": v for n, v in sh.items()})
    chained = all(torch.equal(a, b) for a, b in zip(got[:3], (state.xi, state.z, state.y)))

    want = qp.admm_loop_plain(cfg, li, stop, 0.0)
    exact = qp.admm_loop_plain(cfg, as_f64(qp, li), stop, 0.0)
    rec["plain_exit"] = int(qp.admm_loop_plain(cfg, li, cfg.max_iter, feas_tol)[4])
    rec.update(
        max_abs_err_at_exit=max((a - b).abs().max().item() for a, b in zip(got[:3], want)),
        share_of_tolerance=max(shares(a, b)[0] for a, b in zip(got[:3], want)),
        kernel_vs_f64=max((a.double() - e).abs().max().item() for a, e in zip(got[:3], exact)),
        plain_vs_f64=max((b.double() - e).abs().max().item() for b, e in zip(want[:3], exact)),
        share_kernel_vs_f64=max(shares(a.double(), e)[0] for a, e in zip(got[:3], exact)),
        share_plain_vs_f64=max(shares(b.double(), e)[0] for b, e in zip(want[:3], exact)),
        chained_bitwise=chained)
    rec["whole_run_held_by"] = (
        "chunks" if rec["share_of_tolerance"] <= stop // 8
        else "float64" if rec["share_kernel_vs_f64"] <= rec["share_plain_vs_f64"] else None)
    print(what, json.dumps(rec))
    assert sh["per_agent"] <= 1.0, (what, rec)
    assert chained, f"{what}: the run is not its chain of single chunks"
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "launches after the exit moved"
    assert rec["whole_run_held_by"] is not None, (what, rec)
    return rec


def step_qp(param, mission, base, ck, log_dir):
    """The planner and QP inputs of the step after checkpoint `ck`, on
    the card: a fresh simulator restores it and runs the step up to the
    QP."""
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

    s = MultiSyncSimulator(param, mission, log_dir=log_dir, share_static_from=base,
                           device=base.device)
    s.load_checkpoint(ck)
    s.do_step()
    s.decentralized_mapp()
    return s.planner, s.planner._step_impl(s.fleet, s._build_step_inputs(), defer_qp=True).qp_inp


def min_pair_distance(sim):
    """Smallest centre distance between two agents over the recorded
    trajectory (the audit's samples)."""
    best = np.inf
    for pos in sim.traj_history:
        d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        np.fill_diagonal(d, np.inf)
        best = min(best, float(d.min()))
    return best


def check_audit(r, what):
    assert not r["is_collided"] and not r["qp_failed"], (what, r)
    assert r["safety_ratio_agent"] >= 1.0, (what, r)
    assert r["vel_excess_ratio"] == 0.0 and r["acc_excess_ratio"] == 0.0, (what, r)
    assert np.isfinite(r["total_flight_time"]), (what, r)
    assert r["mapf_backend"] == "native", (what, r)


def step_parity(param, mission, cuda_sim, cks, log_dir):
    """From each checkpoint, one step of a fresh simulator on the card
    and one on the CPU. Positions, waypoints and corridors come before the
    QP: identical, they show the host path and the SFC stage agree across
    devices. Control points, the QP's output, within 0.1 m where both QPs
    converged (the kernel itself is held by `loop_check`). Returns the
    per-step comparison."""
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

    cpu_base = None
    out = []
    for ck in cks:
        sims = []
        for base, dev in ((cuda_sim, "cuda"), (cpu_base, "cpu")):
            s = MultiSyncSimulator(param, mission, log_dir=log_dir, share_static_from=base,
                                   device=dev)
            s.load_checkpoint(ck)
            s.do_step()
            s.decentralized_mapp()
            assert s.plan()
            sims.append(s)
        g, c = sims
        cpu_base = cpu_base or c
        both = g.qp_converged & c.qp_converged
        rec = {"planner_seq": g.planner_seq,
               "pos_equal": bool(np.array_equal(g.pos, c.pos)),
               "waypoint_equal": bool(np.array_equal(g.next_waypoint, c.next_waypoint)),
               "sfc_equal": bool(np.array_equal(g.sfc_lo, c.sfc_lo)
                                 and np.array_equal(g.sfc_hi, c.sfc_hi)),
               "converged_cuda": float(g.qp_converged.mean()),
               "converged_cpu": float(c.qp_converged.mean()),
               "max_dctrl": float(np.abs(g.desired_ctrl - c.desired_ctrl)[both].max(initial=0.0))}
        print("phase7 parity", json.dumps(rec))
        assert rec["pos_equal"] and rec["waypoint_equal"], rec
        assert rec["max_dctrl"] < 0.1, rec
        assert both.mean() >= 0.9, rec
        out.append(rec)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures the port on a GPU")
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
    qp_cuda.build(verbose=True)
    build_s = time.perf_counter() - t0
    print(f"build admm.cu: {build_s:.2f} s (nvcc {qp_cuda.build_seconds} s)")
    record["build_s"] = build_s
    record["ptxas"] = qp_cuda.build_log

    # ---- 3. kernel vs plain loop, one chunk ----------------------------
    cfg, qp_inp, feas_tol = admm_timing.bench_qp(workload, A_MAIN, dev)
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
    cfg37, qp_inp37, tol37 = admm_timing.bench_qp(workload, 37, dev)
    rec = loop_check(qp, cfg37, qp.prepare(cfg37, qp_inp37).loop, tol37, "phase3 A=37")
    assert rec["kernel_exit"] < cfg37.max_iter, f"A=37 should exit before {cfg37.max_iter}"
    assert rec["share_of_tolerance"] <= 1.0, rec  # the whole run, within one tolerance
    max_abs_err = max(max_abs_err, rec["max_abs_err_chunk"])
    record["phase3"]["A37"] = rec

    # loop-only times of this batch and of its rescue, occupancy,
    # per-launch cost
    out_dir = ROOT / "chiprun_out"
    timing = {"calls": admm_timing.bench_calls(qp, cfg, li, feas_tol)}
    timing.update(admm_timing.kernel_report(qp, qp_cuda, cfg, li))
    for c in timing["calls"]:
        print("phase3 timing", json.dumps(c))
    print("phase3 kernel", json.dumps({k: v for k, v in timing.items() if k != "calls"}))
    assert timing["blocks_per_sm"] > 0, timing
    bench, rescue = timing["calls"]
    assert rescue["A"] == qp.RESCUE and rescue["max_iter"] == cfg.rescue_iter, rescue
    ms_kernel = bench["ms"]
    ms_plain = cuda_ms(lambda: qp.admm_loop_plain(cfg, li, cfg.max_iter, feas_tol), 3)
    print(f"ADMM loop A={A_MAIN} max_iter={cfg.max_iter}: kernel {ms_kernel:.3f} ms "
          f"({bench['iters']} iterations, bound {bench['bound_ms']:.4f} ms), "
          f"plain {ms_plain:.3f} ms [{gpu}]")
    record["loop_ms"] = {"kernel": ms_kernel, "plain": ms_plain}
    record["timing"] = timing

    # ---- 4. full solve, kernel vs plain --------------------------------
    record["phase4"] = {}
    for A in (A_MAIN, 1000):
        if A != A_MAIN:
            cfg, qp_inp, feas_tol = admm_timing.bench_qp(workload, A, dev)
        out = qp.solve(cfg, qp_inp, feas_tol)
        ref = qp.solve(cfg, qp_inp, feas_tol, plain=True)
        torch.cuda.synchronize()
        ck, cp = out.converged.float().mean().item(), ref.converged.float().mean().item()
        both = out.converged & ref.converged
        # objectives of both solutions evaluated in float64: the float32
        # objective of agents ~20 m from the origin carries ~1e-2 relative
        # cancellation noise even for identical control points
        pr = qp.prepare(cfg, qp_inp)
        obj_k = qp.objective(cfg, pr, out.x.double())
        obj_p = qp.objective(cfg, pr, ref.x.double())
        obj_err = (obj_k - obj_p).abs()[both].max().item()
        obj32_err = (out.objective - ref.objective).abs()[both].max().item()
        dx = (out.x - ref.x).abs()[both].max().item()
        t_k = cuda_ms(lambda: qp.solve(cfg, qp_inp, feas_tol), 3)
        t_p = cuda_ms(lambda: qp.solve(cfg, qp_inp, feas_tol, plain=True), 2)
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
    launches_all = launches

    # ---- 6, 7. the simulator flies forest missions ---------------------
    from lsc_dr_planner_tpu_torch.config import Param
    from lsc_dr_planner_tpu_torch.sim import run as sim_run
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

    work = out_dir / "chip_smoke_sim"
    work.mkdir(parents=True, exist_ok=True)
    for phase, A, seed, max_iter in FLIGHTS:
        mission = workload.forest_mission(A, seed)
        param = Param(multisim_save_result=False, multisim_max_planner_iteration=max_iter)
        sim = MultiSyncSimulator(param, mission, log_dir=str(work), device=dev)
        ck_dir = work / f"phase{phase}"
        ck_dir.mkdir(exist_ok=True)
        qp_cuda.launches = 0
        t0 = time.perf_counter()
        r, cks = run_checkpointed(sim, max_iter, ck_dir)
        wall = time.perf_counter() - t0
        launches = qp_cuda.launches
        launches_all += launches
        mapf = np.asarray(sim.planning_time.mapf_time.samples) * 1e3
        res = {"phase": phase, "agents": A, "seed": seed, "O": sim.planner.O,
               "planner_steps": sim.planner_seq,
               "flight_time_s": r["total_flight_time"],
               "step_p50_ms": r["step_time_p50_ms"], "step_p99_ms": r["step_time_p99_ms"],
               "plan_p50_ms": r["planning_time_p50_ms"],
               "mapf_ms_mean": float(mapf.mean()), "mapf_ms_max": float(mapf.max()),
               "mapf_share_of_step": float(mapf.sum() / 1e3 / sum(sim.step_time.samples)),
               "min_pair_distance": min_pair_distance(sim),
               "safety_ratio_agent": r["safety_ratio_agent"],
               "qp_convergence": r["qp_converged_mean"], "kernel_launches": launches,
               "mapf_backend": r["mapf_backend"], "wall_s": wall, "gpu": gpu}
        if sim.planner.timing:
            pt = sim.planning_time
            res["stage_ms_mean"] = {
                k: getattr(pt, f).average * 1e3 for k, f in (
                    ("prediction", "obstacle_prediction_time"),
                    ("initial_traj", "initial_traj_planning_time"),
                    ("lsc", "lsc_generation_time"), ("sfc", "sfc_generation_time"),
                    ("goal", "goal_planning_time"), ("qp", "traj_optimization_time"))}
        print(f"phase{phase}", json.dumps(res))
        check_audit(r, f"phase {phase}")
        assert launches > 0, f"phase {phase} never launched the ADMM kernel"
        assert res["min_pair_distance"] >= 2 * 0.15 - sim.planner.feas_tol, res
        assert sim.step_time.N == sim.planner_seq, (sim.step_time.N, sim.planner_seq)
        record[f"phase{phase}"] = res

        # the kernel against the plain loop on the QPs of the flight's steps
        res["kernel_checks"] = []
        for ck in cks:
            planner_k, qp_inp_k = step_qp(param, mission, sim, ck, str(work))
            cfg_k, tol_k = planner_k.qp_cfg, planner_k.feas_tol
            li_k = qp.prepare(cfg_k, qp_inp_k).loop
            rec = loop_check(qp, cfg_k, li_k, tol_k,
                             f"phase{phase} kernel, step after {Path(ck).stem}")
            max_abs_err = max(max_abs_err, rec["max_abs_err_chunk"])
            res["kernel_checks"].append(rec)
            if ck == cks[TIMED_CK]:  # the loop's time on this flight's QP
                res["loop_timing"] = admm_timing.timed_call(
                    qp, cfg_k, li_k, cfg_k.max_iter, tol_k, f"flight{A}", 20)
                print(f"phase{phase} timing", json.dumps(res["loop_timing"]))

        if phase == 6:
            # the same mission through the CLI, as a user runs it
            mpath, wpath = str(work / "forest10.json"), str(work / "forest10.csv")
            mission.save(mpath)
            np.savetxt(wpath, mission.world_boxes, delimiter=",")
            qp_cuda.launches = 0
            (cli,) = sim_run.main(["--mission", mpath, "--world", wpath, "--device", "cuda",
                                   "--max-iter", str(max_iter), "--log-dir", str(work)])
            launches_all += qp_cuda.launches
            check_audit(cli, "phase 6 CLI")
            assert qp_cuda.launches > 0, "the CLI run never launched the ADMM kernel"
            record["phase6"]["cli"] = {"flight_time_s": cli["total_flight_time"],
                                       "planner_steps": cli["planner_seq"],
                                       "kernel_launches": qp_cuda.launches}
        else:
            record["phase7"]["parity"] = step_parity(param, mission, sim, cks[:PARITY_STEPS],
                                                     str(work))

    kernels = [{
        "name": "admm_loop", "route": "cuda",
        "source": "lsc_dr_planner_tpu_torch/csrc/admm.cu",
        "replaces": "lsc_dr_planner_tpu/ops/qp_pallas.py:67",
        "launches": launches_all, "max_abs_err": max_abs_err,
        "ms": ms_kernel, "plain_ms": ms_plain, "iters": bench["iters"],
        "bound_ms": bench["bound_ms"], "bound_by": bench["bound_by"],
        "bound_share": bench["bound_ms"] / ms_kernel,
        "library_ms": None,  # no single PyTorch call computes the loop
    }]
    record["kernels"] = kernels
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
