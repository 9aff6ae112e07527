#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths on the card: the fused fleet planning step
on the bench workload (`lsc_dr_planner_tpu_torch.workload.build_fleet(1024)`:
1024 agents, M=10, n=5, 16 neighbour slots, a forest world), and the
simulator (`sim.simulator.MultiSyncSimulator` with its MAPF waypoint
layer and audit, and the `sim.run` CLI) flying forest missions:

  1. environment: torch/CUDA versions, nvcc, the card's name and power limit;
  2. build the ADMM kernel (csrc/admm.cu), the SFC kernels
     (csrc/sfc_expand.cu: the expansion and the fused 'hull' update), the
     hull kernels (csrc/hull_closest.cu: the query and the fused CLSC
     construction), the QP preparation kernel (csrc/qp_prepare.cu) and
     the step's stage kernels (csrc/step_stages.cu: the neighbour slots,
     the prediction and initial trajectory, the goal and the QP inputs),
     one nvcc per source started together, printing
     ptxas's registers and spills per kernel; time one L2 round trip
     (`sfc_cuda.l2_round_trip_ns`, for the SFC kernels' latency floor);
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
  4. the full solve (200 iterations + 800 rescue) at A=1024 and A=1000,
     the kernel path (the preparation and loop kernels) against (a) the
     plain loop on the same preparation and (b) the plain path
     (qp.solve(plain=True): the plain body and loop): converged share at
     most 0.5 points lower, objectives (evaluated in float64) within
     rtol/atol 2e-2 and control points within 0.1 where both converged;
  5. the main path: 3 warm-up and 20 timed evolving steps; the kernel must
     have been launched, every output finite, mean QP convergence > 0.9
     and no two agents closer than 2·radius − feas_tol; every CLSC
     construction one launch of the fused CLSC kernel and every 'hull'
     SFC update one launch of the fused SFC kernel (the wrappers'
     counters against the calls; no hull query, expansion, plain-loop
     trip or plain body on the card), the longest lane's trips per step
     (the fused kernel adds them to `ops/sfc.py`'s device counter; also
     in phase 8's modes); `clsc_check` and `sfc_hull_check` on the calls
     of two timed steps: the fused kernels' normals, anchors and margins,
     and lattice boxes, world boxes and lanes, equal their plain bodies'
     on the card, element for element; each kernel timed on the first
     (its own device ms a launch by the profiler's events of that
     kernel, and a call's ms queued back to back by CUDA events) beside
     its plain version and its bound (`clsc_bound`: bytes
     and least operations, `hull_ops` extended; `trip_bounds`: bytes,
     operations and the latency floor); the expansion entry and the hull query timed
     on the same call's lanes and hulls (and the query held to the plain
     enumeration there); `clsc_split` and `sfc_split`: each stage's
     function under the profiler (device kernels, copies, host launch
     calls) and the wrappers' counters, one launch and no copy each;
     `rounding_check`: the rounding the plain versions pin (sums, cross
     products, square roots, the segment construction, the SFC seeds
     and world boxes) is the card's as the CPU's, bit for bit;
     `sfc_probe`: the expansion on the main path's lanes, on all lanes
     and on the longest alone, one dependent
     8-corner query, and the kernels' SASS (instructions, loads);
     one launch of the QP preparation kernel a step; `prepare_check` on
     two timed steps' qp.prepare calls (also in phases 8a-8d, 11, 12a and
     on phase 14's 8,192-agent batch): l, u, ρ, scale, tvec, qflat and
     the copies equal the plain body's element for element, each sum
     within its float32 chain's tolerance, Kinv per agent within twice
     the plain body's float32 distance from the float64 inverse (or
     1e-5), every info 0; `prepare_timing` (ms, device ms, plain ms, the
     library inverse's ms, bound); `qp_split` (also in 8b): the QP stage
     split by CUDA events into the input assembly, prepare, the main
     loop, rescue_batch, the rescue loop and the finish, its host
     synchronisations counted (0), qp.solve run under
     torch.cuda.set_sync_debug_mode("error"); one launch of each stage
     kernel a step (planner/stages.py's entries: front_with_neighbors,
     the neighbour selection inside the prediction's launch, and
     goal_qp_inputs; `assert_one_launch_a_call`), no plain stage body on
     the card, and `stage_timing` (own device ms, ms queued, host ms, plain
     ms, bytes bound, registers, shared memory, blocks an SM) on the
     first recorded call; then SEPARATE_STEPS steps with the two as
     separate launches (`separate_launches`), one launch of
     neighbor_slots and of step_front a step, checked and timed the same
     way; from here to
     phase 14's end the stage entries are recorded, and on the recorded
     calls of every phase (5-14; in 13 the sharded steps' gathered
     neighbour slots) `neighbor_check`, `front_check`, `fused_check` and
     `goal_inputs_check` hold each kernel's outputs to its plain body's,
     element for element;
  6. the reference size: `workload.forest_mission(10)` (O = 9 neighbour
     slots, the in-place rescue) flown to its goals on the card by
     `MultiSyncSimulator.run`, at most 300 planner iterations, writing its
     simulation CSV, then once more through the CLI (`sim.run --device
     cuda`); `sfc_hull_check` on its SFC updates, and on the same
     updates with no radius clamp (r = 0); `clsc_check` on its CLSC
     constructions (also in phases 7, 8a, 8b, 9, 11, 12a and on phase
     14's 8,192-agent Monte-Carlo batch);
  7. the repo's scaled forest: `forest_mission(64, seed=1)` flown to its
     goals, at most 400 planner iterations; its first 5 steps are rerun
     from checkpoints on the card and by a CPU simulator (the plain torch
     loop): positions and waypoints identical (host state, before the
     QP), control points within 0.1 m where both QPs converged;
  8. the fused step at A=1024 (`build_fleet(1024)` layout) in the other
     planner modes, whose QPs take the kernel's other builds: (a) DLSC
     sub-step (dim·K 60, M+2 SFC lanes), (b) LSC with DR goals in 3-D
     (84), (c) BVC and (d) Reciprocal-RSFC with static goals and no comm
     box (60, 'point' SFC); per mode the kernel against the plain loop on
     one step's QP and on its compacted rescue (`loop_check`, with its
     per-agent float64 clause in the DLSC and 3-D batches), the loop
     timed, then 3 warm-up and 10 timed steps with stage times, each
     geometry kernel once a call, `sfc_hull_check` ('hull') or
     `sfc_check` ('substep' and, with static goals, 'point' lanes) and the
     SFC kernel's time, `clsc_check` and the CLSC kernel's time (2-D and
     3-D), QP
     convergence > 0.9 and no two agents closer than 2·radius − feas_tol
     (with the downwash in 3-D) in (a) and (b); in (c) and (d), whose QPs
     fail by design in this layout (RSFC's failsafe flies agents into each
     other), convergence within 0.03 of the JAX package's on the CPU at the
     same shape and steps, and BVC's separation as above, RSFC's no more
     than 0.01 m under the JAX package's; and (e) `loop_check` alone on a
     DLSC 3-D QP (90); (f) the main path at full width past the narrow
     builds: `build_fleet(1024, world_dimension=3, M=12,
     communication_range=5.0, max_obstacles=80)` (every agent within 5 m
     an obstacle, as the reference plans: dim·K 102, OA = O = 80, the ADMM
     kernel's cluster build `<256,cluster>` (C = 2; its rescue too), the
     selection's and the prediction's wide builds), 2 warm-up and 5 timed
     steps checked as (b), with
     `fused_check` and `goal_inputs_check` on its stage calls, one launch
     a call of each stage entry, stage ms and `qp_split`, then one step
     with the selection and the prediction as two wide launches
     (`neighbor_check`, `front_check`); (g) the boundary shapes
     (`phase8g`): DLSC 3-D at M = 12 (108), 3-D at M = 16 (138) and at M
     = 28 with 160 slots (246: the preparation's global build, the loop's
     cluster build at C = 8), each `prepare_check` and `loop_check`, each
     on the cluster build; at M = 28 with 480 slots (481 agents: rows and
     Kinv past 8 CTAs, which the cluster build refuses) the loop's global
     build `<256,0,global>`, timed, its `loop_check` with the float64
     clause; fleets with 64, 65, 80, 160 and 256 slots
     through every stage entry, the gathered slots' included, each call
     held to its plain body, `loop_check` at 256 (2-D rows past one
     block's shared memory: the cluster build);
     the selection alone at A 256, 1,024 and 5,000 and OA 32, 33, 80, 128
     and 255 against the plain body; (h) the main path at Bézier degree 8
     (`build_fleet(1024, n=8)`: N = 9 control points a segment, the hull
     kernels' run-time builds; dim·K 116: the ADMM memory build on the
     main batch, the cluster build on its 64-agent rescue), 2
     warm-up and 5 timed steps checked as (f), `clsc_check` on the
     run-time CLSC build, the CLSC and hull kernels timed on its call,
     `qp_split`, QP convergence no worse than the JAX package's at n = 8
     on the same layout, fleet and steps (JAX_CPU_CONV) less one
     straggler a step; the kernel path's solve against the plain path's
     and float64 (`solve_against_plain`); then plain LSC with static
     goals at n = 8 for 2 steps (`phase8h_query`: build_lsc's hull
     queries, one launch of the run-time query each, `hull_check`);
  9. `forest_mission(10)` flown by `MultiSyncSimulator.run` in (a) DLSC
     sub-step mode, (b) 3-D and (c) with a spinning and a straight dynamic
     obstacle seen through 0.03 m observation noise: each flight passes
     the audit (and the obstacle audit in (c)), launches the kernel, is
     checkpointed after planner step 3 and gets `loop_check` on the next
     step's QP;
 10. the JAX package's small mode missions on the card with their own
     assertions (`sim/mode_missions.py`, which the CPU tests fly too):
     the Reciprocal-RSFC crossing, the RIGHT_HAND detour and
     the GOBACK round trip (tests/test_modes.py), BVC (tests/test_sim.py)
     and PRIOR_BASED (tests/test_aux.py), and PRIOR_BASED in
     `forest_mission(10)`'s world (its line-of-sight queries ask the
     world's distance on the card), with the host time of the priority
     goals per step; and a mini mission in DYNAMIC_PRIORITY and in DLSC
     replanning once a segment; the small missions fly with no world map
     (no SFC update), the forest's PRIOR_BASED flight through the SFC
     expansion kernel in 'point' mode, with `sfc_check` on its first SFC
     call, and `hull_check` on build_lsc's hull queries;
 11. local sensing (`world_use_global_map=False`, sensor range 3 m):
     (a) `forest_mission(10)` and (b) `forest_mission(64, seed=1)` flown
     to their goals by `MultiSyncSimulator.run` with the agents' known
     maps on the card, at most 300 / 400 planner iterations: the audit,
     the kernels' launches, `sfc_hull_check` on the per-agent images'
     SFC updates, `clsc_check`, the maps each checkpoint restores, `loop_check` on the step
     after the last checkpoint (after step 3);
     (a) once more through the CLI (`--no-global-map`), (b) its steps
     after 1-3 rerun on the CPU (positions, waypoints and known maps
     identical, control points within 0.1 m); per step the ms of sensing,
     merging, the per-agent integral images and the SFC stage, beside
     phase 7's global-map flight;
 12. Monte-Carlo scenario batching (`sim.montecarlo.MonteCarloSimulator`):
     (a) 8 scenarios of `forest_mission(64, seed=1)` (goal noise 0.25 m)
     until every one finishes or 150 iterations pass: every scenario's
     audit (no collision, safety ratio ≥ 1, no velocity or acceleration
     excess) and the count that arrive; per step the phase times,
     scenario·agent-steps/s and QP convergence; `loop_check` on the
     flattened QP of iteration 4 (A = 512) and on its compacted rescue,
     and the loop timed there, `sfc_hull_check` and `clsc_check` on the
     calls of iterations 0 and 50 (1,536 lanes); (b) 40 scenarios for 5 steps (two chunks
     of 32 scenarios, the second padded): finite outputs and the card's
     peak memory per chunk;
 13. the multi-device runtime on one rank, the debug step and the replay
     reader: (a) a one-rank NCCL group (parallel/mesh.py::init_group)
     runs the all-gather step and the halo step (parallel/halo.py, on
     the spatially sorted fleet) at A=1024 from a state 3 steps in, each
     equal to the unsharded step on the same inputs (rtol 1e-4 / atol
     2e-4; the loop's exit chunk, residual and duals skipped), each
     launching the kernel, with their times beside the unsharded step's;
     the scaling harness's one-rank row (one card: no scaling number);
     (b) the step with `planner.debug` on: every stash tensor finite and
     on the card, the outputs those of the normal step, its time beside
     the normal step's; (c) `sim.replay.read_csv` on the simulation CSV
     phase 6 wrote: every row the positions the flight recorded, the row
     at the final time its final positions; (d) this machine has no
     matplotlib: `render_debug_frame` raises the ImportError that names
     it and draws nothing;
 14. the port's tools (lsc_dr_planner_tpu_torch/tools/), each through
     its own entry point: (a) `sfc_bench` at A = 128 and 1024, clamps 30
     and 70 (the main path's), 3 reps, the plain loop and the kernel:
     trips, host syncs, launches per call and per trip (torch.profiler),
     kernel ms, ms per trip and the bound; (b) `qp_forensics` at A=1024 in DLSC sub-step for 12
     steps, convergence > 0.9 a step, and the re-solve at 1000 iterations
     where the last step leaves agents; (c) `mc_pod_bench` at A=1024,
     S=8 (one chunk of 8,192 agents) for 2 steps: every scenario's audit
     so far, finite state, the chunk's peak memory, and `loop_check` on
     the next iteration's 8,192-agent batch; (d) `scale_demo`'s 256-agent
     smoke run of 15 steps (no collision, no QP failure, safety ratio
     ≥ 1); (e) `dlsc_openworld`'s circle8 and (f) `fuzz_missions`'s cases
     2001 (hybrid layer) and, time allowing, 2002 (mcp) at 8 agents, which
     must succeed / come out clean, as in the JAX package. (a) must
     launch the SFC kernel, (b)-(f) the ADMM kernel and, where their
     world has a map (not (c), (e)), the SFC kernel.
Each flight must pass the audit (no collision, no QP failure, safety
ratio ≥ 1, no velocity or acceleration excess, finite flight time), use
the native MAPF backend and launch the ADMM and SFC kernels. Each flight is
checkpointed after the planner steps of CK_STEPS; on the QP of the step
that follows each checkpoint, the kernel is held against the plain loop
as in phase 3 (every chunk per agent within rtol 1e-4 / atol 1e-5, and
the run to the kernel's own exit), and the loop is timed on the QP of
planner step 4 (A=64/O=16 and A=10/O=9).

Every path that builds LSC rows (all but BVC and RSFC) must launch a
hull kernel once per CLSC construction (the fused kernel) or hull query
(build_lsc's); every path must launch the QP preparation kernel and run
no plain enumeration, CLSC body, 'hull' SFC body or QP preparation on a
CUDA tensor; `clsc_check` must cover 2-D and 3-D, the SFC
checks the shared and the per-agent images, `hull_check` build_lsc
(phase 10) and the main path's 2-D and 8b's 3-D hulls.

Prints the results and the wall time of each phase, a JSON line with one
entry per build of the ADMM kernel (its dim·K range; launches on the
paths of phases 5-14, largest error against the plain loop, and ms,
plain ms and bound at its first timed A=1024 shape, with ptxas's
registers and spills, the calls its `loop_check` held; the memory
build's, the cluster build's and the global build's C, shared bytes a
block or CTA, blocks an SM and resident clusters; the global build
timed at phase 8g's 480 slots, with its device ms),
one per geometry kernel
(sfc_expand, sfc_update_hull, hull_closest, clsc_build, and the hull
kernels' run-time builds hull_closest<rt> and clsc_build<rt>, timed at
phase 8h's N = 9: its launches on
those paths, the calls and items its check held to its plain version,
ms (the kernel's own device ms a launch: `profiled_ms`, which times the
named kernel's events alone), a call's ms queued back to back, plain
ms, bound and share on the main path's call, the SFC kernels' latency
floor, ptxas's registers and spills, shared memory and blocks an SM),
one for qp_prepare (the same, with the library inverse's ms; and its
global build, `qp_prepare<2,global>`, timed at phase 8g's dim·K 246)
and one per stage kernel (neighbor_slots, step_front,
front_with_neighbors, goal_qp_inputs, and the first three's wide builds,
`<wide>`, timed on phase 8f's calls: the same, with the host ms to issue
a call, the phases checked, the kernel's template, its dynamic shared
memory, blocks an SM and, for the wide prediction, its blocks an
agent), the card's name and power limit, and as the last line {"ok":
true, "device": {...}}. Exits non-zero, with no result, without a CUDA
device or outside a checkout of the repository. Writes the full record
to chiprun_out/chip_smoke.json.
"""

import contextlib
import dataclasses
import functools
import json
import re
import shutil
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import admm_timing  # noqa: E402
A_MAIN = 1024
WARMUP, TIMED = 3, 20
SEPARATE_STEPS = 3  # main-path steps with the neighbour selection launched on its own
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
TIMED8 = 10  # timed steps of each phase-8 mode
CK9 = (3,)  # phase-9 flights: checkpoint after planner step 3
# phase 8e's states moved by 1e-6 m (seeds of the moves): loop_check's
# float64 clause (qp_check.F64_FACTOR, qp_check.ENVELOPE_RUNS) on each
MOVED_SEEDS = (1, 2, 3, 4)
MOVE_M = 1e-6


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def gpu_line():
    return sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])


cuda_ms = admm_timing.cuda_ms


def run_checkpointed(sim, max_iter, ck_dir, steps=CK_STEPS, on_save=None):
    """`sim.run()` to the goals in pieces: one call up to each planner
    step of `steps`, a checkpoint after it (then `on_save(path)`), then
    one call for the rest (at most max_iter planner iterations in all, as
    one run() call). Returns (run()'s summary, checkpoint paths)."""
    cks, done = [], 0
    for k in steps:
        sim.run(max_iterations=k - done + 1)
        assert sim.planner_seq == k, (sim.planner_seq, k)
        cks.append(str(ck_dir / f"ck{k}.npz"))
        sim.save_checkpoint(cks[-1])
        if on_save:
            on_save(cks[-1])
        done = k
    return sim.run(max_iterations=max_iter - done), cks


def shares(a, b):
    """|a − b| as a share of the tolerance rtol 1e-4 / atol 1e-5 about b:
    (element by element, per agent against its largest |b|)."""
    from lsc_dr_planner_tpu_torch.ops.qp_check import agent_shares

    d, m = (a - b).abs().flatten(1), b.abs().flatten(1)
    return (d / (1e-5 + 1e-4 * m)).max().item(), agent_shares(a, b).max().item()


def loop_check(qp, cfg, li, feas_tol, what, max_iter=None, float64_clause=False, strict=True):
    """The kernel against the plain loop on one QP batch (qp.LoopInputs).

    - Every 8-iteration chunk of the kernel's run up to its own exit,
      launched alone from the kernel's state at the chunk's start (the
      first from the QP's inputs), against the plain chunk from the same
      state: every agent within rtol 1e-4 of the agent's largest entry /
      atol 1e-5. Element by element the tolerance is out of float32's
      reach for the duals: a dual of an inactive row is the difference
      of two terms of the size of the agent's duals, so its error scales
      with those, not with its own value. The shares are reported, for
      the kernel and for the float32 plain loop against the float64
      plain chunk from the same state.
    - With `float64_clause` (the batches of ill-conditioned modes, where
      two float32 loops that sum in different orders land several
      tolerances apart from identical inputs), an agent outside that
      tolerance passes if, for that same agent, chunk and tensor, the
      kernel is within one tolerance of the float64 plain chunk, or no
      more than qp_check.F64_FACTOR times as far from it as the float32
      plain loop strays over qp_check.ENVELOPE_RUNS runs from the chunk's
      state moved by one ulp (`qp_check.float32_envelope`; one run alone
      can land near float64 by luck, and then no factor separates luck
      from error). Reported: the (chunk, tensor, agent) cases outside
      the first rule, those of them more than one tolerance from
      float64, the largest ratio of the kernel's distance to the
      envelope and to the one unmoved plain run among these, and the
      worst cases (ratio, chunk, tensor, kernel, envelope, one run).
      The whole run is held to float64 the same way
      (`qp_check.whole_run_f64`, reported as `whole_run_f64`).
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
    `max_iter`: the run's iteration cap (cfg.max_iter by default;
    cfg.rescue_iter for a rescue batch). `strict=False` reports the
    failures in rec["failures"] instead of raising. Returns the errors."""
    from lsc_dr_planner_tpu_torch.ops import qp_check

    max_iter = max_iter or cfg.max_iter
    got = qp.run_loop(cfg, li, max_iter, feas_tol)
    stop = int(got[4])
    again = qp.run_loop(cfg, li, stop, feas_tol)
    rec = {"A": int(li.z.shape[0]), "O": cfg.n_obs, "rows": int(li.z.shape[1]),
           "kernel_exit": stop}
    sh = dict.fromkeys(("elementwise", "per_agent", "kernel_vs_f64", "plain_vs_f64"), 0.0)
    chunk_err, state, outside, off64, failed, single, ratio, worst = 0.0, li, 0, 0, 0, 0.0, 0.0, []
    for c in range(stop // 8):
        k = qp.run_loop(cfg, state, 8, feas_tol)
        p = qp.admm_loop_plain(cfg, state, 8, feas_tol)
        e = qp.admm_loop_plain(cfg, qp_check.as_f64(state), 8, feas_tol)
        if c == 0:
            rec["itdone_agreement"] = (k[3] == p[3]).float().mean().item()
        env = None
        for t, (a, b, x) in enumerate(zip(k[:3], p[:3], e[:3])):
            chunk_err = max(chunk_err, (a - b).abs().max().item())
            new = (*shares(a, b), shares(a.double(), x)[0], shares(b.double(), x)[0])
            sh = {n: max(v, w) for (n, v), w in zip(sh.items(), new)}
            far = qp_check.agent_shares(a, b) > 1.0
            outside += int(far.sum())
            k64 = qp_check.agent_shares(a.double(), x)
            p64 = qp_check.agent_shares(b.double(), x)
            off = far & (k64 > 1.0)  # outside, and more than a tolerance from float64
            if not (float64_clause and off.any()):
                continue
            if env is None:
                env = qp_check.float32_envelope(cfg, state, 8, feas_tol, p, e, c)
            off64 += int(off.sum())
            single = max(single, (k64[off] / p64[off]).max().item())
            r = k64[off] / env[t][off]
            ratio = max(ratio, r.max().item())
            failed += int((r > qp_check.F64_FACTOR).sum())
            for i in r.argsort(descending=True)[:3].tolist():
                worst.append((r[i].item(), c, "xzy"[t], k64[off][i].item(),
                              env[t][off][i].item(), p64[off][i].item()))
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    rec["max_abs_err_chunk"] = chunk_err
    rec.update({f"chunk_share_{n}": v for n, v in sh.items()})
    rec.update(float64_clause=float64_clause, chunk_agents_outside_tolerance=outside,
               chunk_agents_off_float64=off64, chunk_ratio_to_one_plain_run=single,
               chunk_ratio_to_envelope=ratio, chunk_agents_failed=failed,
               chunk_worst_cases=sorted(worst, reverse=True)[:5])
    chained = all(torch.equal(a, b) for a, b in zip(got[:3], (state.xi, state.z, state.y)))

    want = qp.admm_loop_plain(cfg, li, stop, 0.0)
    exact = qp.admm_loop_plain(cfg, qp_check.as_f64(li), stop, 0.0)
    rec["plain_exit"] = int(qp.admm_loop_plain(cfg, li, max_iter, feas_tol)[4])
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
    if float64_clause:
        rec["whole_run_f64"] = qp_check.whole_run_f64(cfg, li, got)
    print(what, json.dumps(rec))
    fails = []
    if float64_clause:
        if failed:
            fails.append(f"{failed} chunk cases over F64_FACTOR (ratio {ratio:.3f})")
        if rec["whole_run_f64"]["agents_failed"]:
            fails.append(f"whole run: {rec['whole_run_f64']['agents_failed']} cases over "
                         f"F64_FACTOR (ratio {rec['whole_run_f64']['ratio_max']:.3f})")
    elif sh["per_agent"] > 1.0:
        fails.append(f"a chunk's agent at {sh['per_agent']:.3f} tolerances")
    if not chained:
        fails.append("the run is not its chain of single chunks")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fails.append("launches after the exit moved")
    if rec["whole_run_held_by"] is None:
        fails.append("the whole run is held neither by the chunks nor by float64")
    rec["failures"] = fails
    assert not (strict and fails), (what, rec)
    return rec


def moved_states(planner, fleet, inp, seeds):
    """(tag, seed, QP inputs) of the fleet state `inp` as it is and with
    every agent's position moved by MOVE_M m in a random direction of its
    world's dimensions (seeded per state): the QP of the next step
    (planner._step_impl(..., defer_qp=True)), built on the card."""
    dim = planner.param.world_dimension
    out = [("unmoved", None, planner._step_impl(fleet, inp, defer_qp=True).qp_inp)]
    for seed in seeds:
        g = torch.Generator(device=inp.pos.device).manual_seed(seed)
        d = torch.zeros_like(inp.pos)
        d[:, :dim] = torch.randn((inp.pos.shape[0], dim), generator=g, device=inp.pos.device)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        moved = dataclasses.replace(inp, pos=inp.pos + MOVE_M * d)
        out.append((f"moved{seed}", seed, planner._step_impl(fleet, moved, defer_qp=True).qp_inp))
    return out


def step_qp(param, mission, base, ck, log_dir):
    """The planner and QP inputs of the step after checkpoint `ck`, on
    the card: a fresh simulator restores it and runs the step up to the
    QP (merging the known maps first in local-sensing mode, as plan()
    does)."""
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

    s = MultiSyncSimulator(param, mission, log_dir=log_dir, share_static_from=base,
                           device=base.device)
    s.load_checkpoint(ck)
    s.do_step()
    s.decentralized_mapp()
    if s.local_maps:
        s.merge_maps()
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


def stage_ms_mean(sim):
    """A flight's mean device ms per planner stage over the sampled steps
    (planner step 2 and every 25th; CUDA events)."""
    pt = sim.planning_time
    return {k: getattr(pt, f).average * 1e3 for k, f in (
        ("prediction", "obstacle_prediction_time"),
        ("initial_traj", "initial_traj_planning_time"),
        ("lsc", "lsc_generation_time"), ("sfc", "sfc_generation_time"),
        ("goal", "goal_planning_time"), ("qp", "traj_optimization_time"))}


def check_audit(r, what):
    assert not r["is_collided"] and not r["qp_failed"], (what, r)
    assert r["safety_ratio_agent"] >= 1.0, (what, r)
    assert r["vel_excess_ratio"] == 0.0 and r["acc_excess_ratio"] == 0.0, (what, r)
    assert np.isfinite(r["total_flight_time"]), (what, r)
    assert r["mapf_backend"] == "native", (what, r)


def step_parity(param, mission, cuda_sim, cks, log_dir, tag="phase7"):
    """From each checkpoint, one step of a fresh simulator on the card
    and one on the CPU. Positions, waypoints and corridors come before the
    QP: identical, they show the host path and the SFC stage agree across
    devices; so do the known maps in local-sensing mode (sensed and
    merged on each device). Control points, the QP's output, within 0.1 m
    where both QPs converged (the kernel itself is held by `loop_check`).
    Returns the per-step comparison."""
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
        if g.local_maps:
            rec["known_equal"] = torch.equal(g.map_manager.known.cpu(), c.map_manager.known)
            rec["known_cells"] = int(c.map_manager.known.sum())
            assert rec["known_equal"], rec
        print(f"{tag} parity", json.dumps(rec))
        assert rec["pos_equal"] and rec["waypoint_equal"], rec
        assert rec["max_dctrl"] < 0.1, rec
        assert both.mean() >= 0.9, rec
        out.append(rec)
    return out


class Builds:
    """Per-build records of the ADMM kernel: the dim·K range each template
    build takes, its launches on the main paths (`add_path_launches` after
    each path), its largest error against the plain loop, and its timing
    at its A=1024 shape; and a record per geometry kernel: `sfc` (the
    expansion, sfc_expand: the 'point' and 'substep' SFC modes),
    `sfc_hull` (the fused 'hull' SFC update), `hull` (the hull query,
    build_lsc's) and `clsc` (the fused CLSC construction): its launches
    on the main paths, the calls and items its check held to the plain
    version, and its timing at the main path's shape; and `prep`, the QP
    preparation kernel's (qp_prepare): its launches, the calls and agents
    `prepare_check` held to the plain body, and its timing."""

    def __init__(self, qp, qp_cuda, sfc_cuda, hull_cuda, geometry, lsc, sfc, dev,
                 qp_prepare_cuda, stages, step_cuda):
        self.qp, self.qp_cuda, self.sfc_cuda, self.dev = qp, qp_cuda, sfc_cuda, dev
        self.qp_prepare_cuda, self.stages, self.step_cuda = qp_prepare_cuda, stages, step_cuda
        self.hull_cuda, self.geometry, self.lsc, self.sfc_ops = hull_cuda, geometry, lsc, sfc
        self.lib = qp_cuda.build()
        # the six builds (the register builds up to dim·K 96, chosen by the
        # library from the shape: <128,30> to 60, the triple build's
        # nine-warp width to 90 and its ten-warp width above; past them, or
        # where the rows pass one block's shared memory, the memory build
        # for a batch that fills the card twice over with two agents an SM,
        # else the cluster build, and the global build for the shapes the
        # cluster build cannot take: qp_cuda.loop_plan); "dk": the least and
        # largest dim·K this run's checks and timings held each to
        self.rec = {name: {"dk": None, "launches": 0, "max_abs_err": 0.0, "calls_checked": 0,
                           "ms": None}
                    for name in ("<128,30>", "<288,30>", "<320,32>", qp_cuda.MEMORY_BUILD,
                                 qp_cuda.CLUSTER_BUILD, qp_cuda.GLOBAL_BUILD)}
        self.sfc = {"launches": 0, "max_abs_err": 0, "calls_checked": 0, "lanes_checked": 0,
                    "ms": None}
        self.sfc_hull = {"launches": 0, "max_abs_err": 0.0, "calls_checked": 0,
                         "agents_checked": 0, "elements_checked": 0, "per_agent_images": [],
                         "ms": None}
        self.hull = {"launches": 0, "max_abs_err": 0.0, "calls_checked": 0, "hulls_checked": 0,
                     "callers": [], "dims": [], "ms": None}
        self.clsc = {"launches": 0, "max_abs_err": 0.0, "calls_checked": 0, "pairs_checked": 0,
                     "elements_checked": 0, "dims": [], "ms": None}
        # the hull kernels' run-time builds (hull_query_rt: K > 8, and CLSC
        # stages past 48 KB): the same records; `hull` and `clsc` keep the
        # template builds' alone
        self.hull_rt = {"launches": 0, "max_abs_err": 0.0, "calls_checked": 0,
                        "hulls_checked": 0, "callers": [], "dims": [], "ms": None}
        self.clsc_rt = {"launches": 0, "max_abs_err": 0.0, "calls_checked": 0,
                        "pairs_checked": 0, "elements_checked": 0, "dims": [], "ms": None}
        self.prep = {"launches": 0, "max_abs_err": 0.0, "calls_checked": 0, "agents_checked": 0,
                     "elements_checked": 0, "max_share_of_tolerance": 0.0,
                     "max_kinv_ratio": 0.0, "dims": [], "max_agents": 0, "ms": None}
        # the step's stage kernels (csrc/step_stages.cu): launches, the calls,
        # elements and phases their checks held to the plain bodies, timing
        self.stage = {e: {"launches": 0, "max_abs_err": 0.0, "calls_checked": 0,
                          "elements_checked": 0, "phases": [], "ms": None}
                      for e in STAGE_ENTRIES}
        # the wide builds of the selection and the prediction (OA > 32 with
        # the selection, O > 64), and the QP preparation's global build (its
        # tiles past shared memory): the same records
        self.wide = {e: {"launches": 0, "max_abs_err": 0.0, "calls_checked": 0,
                         "elements_checked": 0, "phases": [], "ms": None}
                     for e in WIDE_ENTRIES}
        self.prep_global = {"launches": 0, "max_abs_err": 0.0, "calls_checked": 0,
                            "agents_checked": 0, "elements_checked": 0,
                            "max_share_of_tolerance": 0.0, "max_kinv_ratio": 0.0, "ms": None}

    def name(self, cfg, A):
        return self.qp_cuda.build_name(self.lib, *admm_shape(self.qp, cfg, self.dev), A)

    def build_rec(self, cfg, A):
        """The record of the build of a batch of A agents of cfg's shape,
        its dim·K range widened to cfg's."""
        r = self.rec[self.name(cfg, A)]
        dk = cfg.dim * admm_shape(self.qp, cfg, self.dev)[4]
        r["dk"] = [dk, dk] if r["dk"] is None else [min(r["dk"][0], dk), max(r["dk"][1], dk)]
        return r

    def reset_launches(self):
        self.qp_cuda.reset_launches()
        self.sfc_cuda.reset_launches()
        self.hull_cuda.reset_launches()
        self.geometry.reset_counts()
        self.lsc.reset_counts()
        self.sfc_ops.reset_counts()
        self.qp.reset_counts()
        self.qp_prepare_cuda.reset_launches()
        self.step_cuda.reset_launches()
        self.stages.reset_counts()

    def add_path_launches(self):
        """Adds the launches counted since the last reset, per ADMM build,
        of the SFC expansion ("sfc_expand"), the fused 'hull' SFC update
        ("sfc_update_hull"), the hull query ("hull_closest") and the fused
        CLSC construction ("clsc_build") and the QP preparation
        ("qp_prepare"), the launches of the hull kernels' run-time builds
        among them ("hull_closest_rt", "clsc_build_rt"), and returns them
        with the plain versions run on CUDA tensors: hull enumerations
        ("hull_plain_on_cuda"), CLSC bodies ("clsc_plain_on_cuda"), 'hull'
        SFC bodies ("sfc_hull_plain_on_cuda") and QP preparations
        ("prepare_plain_on_cuda"); and the step's stage kernels
        ("neighbor_slots", "step_front", "front_with_neighbors",
        "goal_qp_inputs") with their plain bodies on CUDA tensors
        ("neighbor_plain_on_cuda", "front_plain_on_cuda",
        "fused_plain_on_cuda", "goal_plain_on_cuda"); and the launches of the
        selection's and the prediction's wide builds among them
        ("<entry>_wide") and of the preparation's global build
        ("qp_prepare_global")."""
        out = dict(self.qp_cuda.build_launches)
        for name, n in out.items():
            self.rec[name]["launches"] += n
        for key, n, rec in (("sfc_expand", self.sfc_cuda.launches, self.sfc),
                            ("sfc_update_hull", self.sfc_cuda.hull_launches, self.sfc_hull),
                            ("hull_closest", self.hull_cuda.launches, self.hull),
                            ("clsc_build", self.hull_cuda.clsc_launches, self.clsc),
                            ("qp_prepare", self.qp_prepare_cuda.launches, self.prep)):
            out[key] = n
            rec["launches"] += n
        for key, rec, template in (("hull_closest", self.hull_rt, self.hull),
                                   ("clsc_build", self.clsc_rt, self.clsc)):
            n = self.hull_cuda.rt_launches[key]
            out[key + "_rt"] = n
            rec["launches"] += n
            template["launches"] -= n
        out["hull_plain_on_cuda"] = self.geometry.plain_cuda_calls
        out["clsc_plain_on_cuda"] = self.lsc.plain_cuda_calls
        out["sfc_hull_plain_on_cuda"] = self.sfc_ops.plain_cuda_calls
        out["prepare_plain_on_cuda"] = self.qp.plain_cuda_calls
        for key, n in (("neighbor_slots", self.step_cuda.neighbor_launches),
                       ("step_front", self.step_cuda.front_launches),
                       ("front_with_neighbors", self.step_cuda.fused_launches),
                       ("goal_qp_inputs", self.step_cuda.goal_launches)):
            out[key] = n
            self.stage[key]["launches"] += n
        for key, n in self.step_cuda.wide_launches.items():
            out[key + "_wide"] = n
            self.wide[key]["launches"] += n
        n = self.qp_prepare_cuda.build_launches.get(self.qp_prepare_cuda.GLOBAL_BUILD, 0)
        out["qp_prepare_global"] = n
        self.prep_global["launches"] += n
        for key in ("neighbor_plain_on_cuda", "front_plain_on_cuda", "fused_plain_on_cuda",
                    "goal_plain_on_cuda"):
            out[key] = getattr(self.stages, key)
        return out

    @staticmethod
    def assert_launched(launches, what, sfc=True, hull=True, clsc=False, sfc_hull=False,
                        neighbors=True):
        """The kernels launched on the path: the ADMM kernel; the step's
        prediction (with its own selection or not) and goal kernels, and
        a neighbour selection, alone or in the prediction's launch (not
        with `neighbors` False: the sharded steps bring their own
        neighbour slots, a fleet of one has none); an SFC kernel
        (not with `sfc` False: a path with no world map, world_use_octomap
        off, has no SFC update); a hull kernel, the query or the fused
        CLSC construction (not with `hull` False: BVC and RSFC build no
        LSC rows); the fused CLSC kernel with `clsc` (the LSC family with
        DR goals), the fused 'hull' SFC kernel with `sfc_hull` (DR goals
        with a world map, not in DLSC sub-step); and no plain hull
        enumeration, CLSC body, 'hull' SFC body or stage body on a CUDA
        tensor."""
        admm = sum(n for k, n in launches.items() if k not in NOT_ADMM)
        assert admm > 0, f"{what} never launched the ADMM kernel"
        assert launches["step_front"] + launches["front_with_neighbors"] > 0 \
            and launches["goal_qp_inputs"] > 0, \
            f"{what} never launched the prediction or the goal kernel"
        assert launches["neighbor_slots"] + launches["front_with_neighbors"] > 0 \
            or not neighbors, f"{what} never launched the neighbour selection"
        assert launches["sfc_expand"] + launches["sfc_update_hull"] > 0 or not sfc, \
            f"{what} never launched an SFC kernel"
        assert launches["hull_closest"] + launches["clsc_build"] > 0 or not hull, \
            f"{what} never launched a hull kernel"
        assert launches["clsc_build"] > 0 or not clsc, f"{what} never launched the CLSC kernel"
        assert launches["sfc_update_hull"] > 0 or not sfc_hull, \
            f"{what} never launched the fused 'hull' SFC kernel"
        for key in PLAIN_ON_CUDA:
            assert launches[key] == 0, f"{what} ran a plain version on the card: {key}"

    def note_check(self, cfg, rec):
        r = self.build_rec(cfg, rec["A"])
        r["max_abs_err"] = max(r["max_abs_err"], rec["max_abs_err_chunk"])
        r["calls_checked"] += 1

    def note_hull_check(self, recs):
        for r in recs:
            h = self.hull_rt if r["rt"] else self.hull
            h["max_abs_err"] = max(h["max_abs_err"], r["max_abs_err"])
            h["calls_checked"] += 1
            h["hulls_checked"] += r["hulls"]
            for key, v in (("callers", r["caller"]), ("dims", r["dim"])):
                if v not in h[key]:
                    h[key].append(v)

    def note_sfc_check(self, recs):
        for r in recs:
            self.sfc["max_abs_err"] = max(self.sfc["max_abs_err"], r["max_abs_err"])
            self.sfc["calls_checked"] += 1
            self.sfc["lanes_checked"] += r["lanes"]

    def note_sfc_hull_check(self, recs):
        h = self.sfc_hull
        for r in recs:
            h["max_abs_err"] = max(h["max_abs_err"], r["max_abs_err"])
            h["calls_checked"] += 1
            h["agents_checked"] += r["agents"]
            h["elements_checked"] += r["elements"]
            if r["per_agent_images"] not in h["per_agent_images"]:
                h["per_agent_images"].append(r["per_agent_images"])

    def note_clsc_check(self, recs):
        for r in recs:
            c = self.clsc_rt if r["rt"] else self.clsc
            c["max_abs_err"] = max(c["max_abs_err"], r["max_abs_err"])
            c["calls_checked"] += 1
            c["pairs_checked"] += r["pairs"]
            c["elements_checked"] += r["elements"]
            if r["dim"] not in c["dims"]:
                c["dims"].append(r["dim"])

    def note_prepare_check(self, recs):
        for r in recs:
            if r["build"] == self.qp_prepare_cuda.GLOBAL_BUILD:
                self._note_prepare(self.prep_global, r)
            self._note_prepare(self.prep, r)

    @staticmethod
    def _note_prepare(c, r):
        c["max_abs_err"] = max(c["max_abs_err"], r["max_abs_err"])
        c["max_share_of_tolerance"] = max(c["max_share_of_tolerance"],
                                          max(r["share_of_tolerance"].values()))
        c["max_kinv_ratio"] = max(c["max_kinv_ratio"], r["kinv_ratio_max"])
        c["calls_checked"] += 1
        c["agents_checked"] += r["agents"]
        c["elements_checked"] += r["elements"]
        if "dims" in c:
            c["max_agents"] = max(c["max_agents"], r["agents"])
            if r["dim"] not in c["dims"]:
                c["dims"].append(r["dim"])

    def note_stage_check(self, rec, what):
        r = (self.wide if rec.get("wide") else self.stage)[rec["entry"]]
        r["max_abs_err"] = max(r["max_abs_err"], rec["max_abs_err"])
        r["calls_checked"] += rec["calls"]
        r["elements_checked"] += rec["elements"]
        if what not in r["phases"]:
            r["phases"].append(what)

    def note_timing(self, cfg, timing, plain_ms):
        """The build's first timing; with the launch the wrapper recorded
        (`qp_cuda.last_launch`: cluster size C, shared bytes and CTAs an
        SM, resident clusters)."""
        r = self.build_rec(cfg, timing["A"])
        if r["ms"] is None:
            r.update(ms=timing["ms"], device_ms=timing.get("device_ms"), plain_ms=plain_ms,
                     iters=timing["iters"],
                     A=timing["A"], R=timing["R"], bound_ms=timing["bound_ms"],
                     bound_by=timing["bound_by"], bound_share=timing["bound_share"],
                     **{k: timing[k] for k in ("C", "smem_bytes", "ctas_per_sm",
                                               "active_clusters") + GLOBAL_KEYS
                        if k in timing})


# the global build's timing beside its bounds (`global_loop_timing`)
GLOBAL_KEYS = ("queued_ms", "floor_gb", "floor_ms", "floor_share", "moved_gb", "moved_tb_per_s")


def admm_ptxas(qp_cuda, name):
    """The kernel of ADMM build `name` in ptxas's summary (`kernel_name`):
    the triple build's template holds its Kinv columns less those in
    shared memory."""
    S = qp_cuda.TRIPLE_SHARED_COLUMNS
    return {"<128,30>": "admm_chunk_kernel<128,30>",
            "<288,30>": f"admm_triple_kernel<9,{30 - S}>",
            "<320,32>": f"admm_triple_kernel<10,{32 - S}>",
            "<256,0>": "admm_chunk_kernel<256,0>", "<256,cluster>": "admm_cluster_kernel<256>",
            "<256,0,global>": "admm_global_kernel<256>"}[name]


PLAIN_ON_CUDA = ("hull_plain_on_cuda", "clsc_plain_on_cuda", "sfc_hull_plain_on_cuda",
                 "prepare_plain_on_cuda", "neighbor_plain_on_cuda", "front_plain_on_cuda",
                 "fused_plain_on_cuda", "goal_plain_on_cuda")
# planner/stages.py's entries (the step calls the third, the multi-device
# steps the second; `separate_launches` the first two in the third's place)
STAGE_ENTRIES = ("neighbor_slots", "step_front", "front_with_neighbors", "goal_qp_inputs")
WIDE_ENTRIES = STAGE_ENTRIES[:3]  # the entries with wide builds (step_cuda.wide_launches)
NOT_ADMM = ("sfc_expand", "sfc_update_hull", "hull_closest", "clsc_build", "hull_closest_rt",
            "clsc_build_rt", "qp_prepare", "qp_prepare_global", *STAGE_ENTRIES,
            *(e + "_wide" for e in WIDE_ENTRIES), *PLAIN_ON_CUDA)


def admm_shape(qp, cfg, dev):
    """(dim, O, M, N, K, R_stat) of cfg's QP: the ADMM builds' shape."""
    K = qp.torch_statics(cfg, dev)["K"]
    return cfg.dim, cfg.n_obs, cfg.M, cfg.N, K, qp.n_rows(cfg) - cfg.n_obs * cfg.M * cfg.N


def stage_build(step_cuda, entry, a):
    """The build a recorded stage call (its positional arguments `a`) took,
    as its wrapper's query names it: the selection's list K, 8 for the
    prediction without one, 0 for the wide builds; None for the goal
    kernel (one build)."""
    if entry == "goal_qp_inputs":
        return None
    if entry == "neighbor_slots":
        pos, S, cfg = a[:3]
        return step_cuda.selection_build(pos.shape[0] // S, cfg.OA)
    cfg, inp = a[0], a[2]
    fused = entry == "front_with_neighbors"
    S = (a[3] if len(a) > 3 else 1) if fused else (a[6] if len(a) > 6 else 1)
    return step_cuda.front_build(inp.pos.shape[0], S, cfg.O, cfg.OA, cfg.M, cfg.n, cfg.mode,
                                 fused)


def wide_call(step_cuda, entry, a):
    """Whether a recorded stage call (its positional arguments `a`) took
    a wide build."""
    return stage_build(step_cuda, entry, a) == 0


@contextlib.contextmanager
def separate_launches(stages):
    """For the duration, the step's front_with_neighbors as two launches:
    the neighbour selection alone (neighbor_slots), then the prediction on
    its slots (step_front), each looked up at its call so that recorders
    see them; the fused route's yardstick. A tree without the fused entry
    (an older one) runs its own two launches as it is."""
    fused = getattr(stages, "front_with_neighbors", None)

    def front(cfg, fleet, inp, scenarios=1):
        order, valid = stages.neighbor_slots(inp.pos, scenarios, cfg)
        return order, valid, stages.step_front(cfg, fleet, inp, order, valid, None, scenarios)

    if fused is not None:
        stages.front_with_neighbors = front
    try:
        yield
    finally:
        if fused is not None:
            stages.front_with_neighbors = fused


def assert_one_launch_a_call(launches, recorders, what, stage_recorders=()):
    """Each geometry kernel launched once per call of its function on the
    path (`path_calls`' recorders): the 'hull' SFC updates, the
    expansions, the CLSC constructions, the hull queries; and each stage
    kernel once per call of its entry (`stage_recorders`, where given)."""
    got = tuple(launches[k] for k in ("sfc_update_hull", "sfc_expand", "clsc_build",
                                      "hull_closest"))
    assert got == tuple(r.n for r in recorders), (what, got, [r.n for r in recorders])
    got = tuple(launches[r.name] for r in stage_recorders)
    assert got == tuple(r.n for r in stage_recorders), (what, got,
                                                        [r.n for r in stage_recorders])


class Calls:
    """While active, records the inputs, outputs and caller of calls of
    `module.name` (the sampled steps of a check): of the calls that
    `accept(args, kwargs)` lets through (all by default), every `every`-th
    from the first, at most `keep` of them; `n` counts every call let
    through. The port looks these functions up in their modules at each
    call, so the recorder sees every call of the path."""

    def __init__(self, module, name, every=1, keep=2, accept=None):
        self.module, self.name, self.accept = module, name, accept
        self.every, self.keep = every, keep
        self.calls, self.n = [], 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def record(*a, **k):
            out = self.orig(*a, **k)
            if self.accept is None or self.accept(a, k):
                if self.n % self.every == 0 and len(self.calls) < self.keep:
                    self.calls.append((a, k, out, sys._getframe(1).f_code.co_name))
                self.n += 1
            return out

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def hull_mode(a, k):
    """Lets through the SFC updates (sfc.update_sfc) in 'hull' mode."""
    return (a[1] if len(a) > 1 else k.get("mode")) == "hull"


def path_calls(sfc, lsc, geometry, every=1, keep=2):
    """The recorders of a path's kernel calls: the 'hull' SFC updates, the
    SFC expansions ('point', 'substep'), the CLSC constructions and the
    hull queries (build_lsc's)."""
    return (Calls(sfc, "update_sfc", every, keep, hull_mode), Calls(sfc, "expand_box", every, keep),
            Calls(lsc, "build_clsc", every, keep),
            Calls(geometry, "closest_point_origin_to_hull", every, keep))


def stage_recorders(stages, every=1, keep=2):
    """The recorders of the step's stage entries (planner/stages.py:
    neighbor_slots, step_front, front_with_neighbors, goal_qp_inputs; an
    older tree's that it has), each keeping at most `keep` calls, every
    `every`-th from the first."""
    return tuple(Calls(stages, name, every, keep) for name in STAGE_ENTRIES
                 if hasattr(stages, name))


def restart(recorders, every, accept=None):
    """Clears the recorders for the next phase, with its stride and filter."""
    for r in recorders:
        r.calls, r.n, r.every, r.accept = [], 0, every, accept


def _stage_fields(entry, out):
    if entry == "neighbor_slots":
        return list(zip(("order", "valid"), out))
    if entry == "front_with_neighbors":
        return [("order", out[0]), ("valid", out[1])] + _stage_fields("step_front", out[2])
    return [(f.name, getattr(out, f.name)) for f in dataclasses.fields(out)]


def stage_check(builds, calls, what):
    """The recorded calls of one stage entry (each ran its kernel on the
    card) against its plain body on the same inputs (plain=True): every
    output equal element for element, by value (a NaN equal to a NaN).
    Returns the check's record, noted in `builds`."""
    entry = calls.name
    wide = {wide_call(builds.step_cuda, entry, c[0]) for c in calls.calls}
    assert len(wide) == 1, (what, entry, "narrow and wide calls in one check")
    rec = {"entry": entry, "calls": 0, "elements": 0, "differing": 0, "max_abs_err": 0.0,
           "callers": sorted({c[3] for c in calls.calls}), "wide": wide.pop()}
    for a, k, got, _ in calls.calls:
        assert not k.get("plain"), (what, entry)
        want = calls.orig(*a, **k, plain=True)
        for (name, x), (_, y) in zip(_stage_fields(entry, got), _stage_fields(entry, want)):
            assert (x is None) == (y is None), (what, entry, name)
            if x is None:
                continue
            assert x.device.type == "cuda" and x.dtype == y.dtype and x.shape == y.shape, \
                (what, entry, name, x.dtype, y.dtype, tuple(x.shape), tuple(y.shape))
            rec["differing"] += differing(x, y)
            rec["elements"] += x.numel()
            rec["max_abs_err"] = max(rec["max_abs_err"], max_err(x, y))
        rec["calls"] += 1
    torch.cuda.synchronize()
    print(f"{what} {entry} check", json.dumps(rec))
    assert rec["differing"] == 0, (what, rec)
    builds.note_stage_check(rec, what)
    return rec


def neighbor_check(builds, recorders, what):
    return stage_check(builds, recorders[0], what)


def front_check(builds, recorders, what):
    return stage_check(builds, recorders[1], what)


def fused_check(builds, recorders, what):
    return stage_check(builds, recorders[2], what)


def goal_inputs_check(builds, recorders, what):
    return stage_check(builds, recorders[3], what)


def stage_checks(builds, recorders, what):
    """neighbor_check, front_check, fused_check and goal_inputs_check on
    the calls a phase made and its recorders kept."""
    return {r.name: check(builds, recorders, what) for check, r in zip(
        (neighbor_check, front_check, fused_check, goal_inputs_check), recorders) if r.calls}


def stage_io(entry, a, k, got):
    """(bytes, operations) of one stage call: each tensor the kernel reads
    counted once and each output once, and its least arithmetic."""
    seen, nbytes = set(), 0

    def add(t):
        nonlocal nbytes
        if t is not None and (t.data_ptr(), t.numel()) not in seen:
            seen.add((t.data_ptr(), t.numel()))
            nbytes += t.numel() * t.element_size()

    outs = [x for _, x in _stage_fields(entry, got)]
    for t in outs:
        add(t)
    if entry == "neighbor_slots":
        pos, S = a[0], a[1]
        add(pos)
        A = pos.shape[0] // S
        return nbytes, S * A * A * 9  # 3 differences, 3 abs, 2 max, the range test
    if entry == "front_with_neighbors":  # the selection's and the prediction's, pos once
        cfg, fleet, inp, S = a[:4]
        order, valid, front = got
        n_sel, ops_sel = stage_io("neighbor_slots", (inp.pos, S), {}, (order, valid))
        n_front, ops_front = stage_io("step_front", (cfg, fleet, inp, None, None, None), {},
                                      front)
        return n_front + n_sel - inp.pos.numel() * 4, ops_sel + ops_front
    if entry == "step_front":
        cfg, fleet, inp, order, valid, nd = a[:6]
        for t in (order, valid, inp.prev_ctrl, inp.has_prev, inp.pos, inp.vel, inp.is_disturbed,
                  fleet.max_acc, cfg.growth, cfg.sub, *(getattr(inp, "dynobs_" + f) for f in (
                      "pos", "vel", "radius", "downwash", "max_acc", "valid"))):
            add(t)
        for t in ((nd.prev_ctrl, nd.has_prev, nd.pos, nd.vel, nd.radius, nd.downwash, nd.goal,
                   nd.valid) if nd is not None else (fleet.radius, fleet.downwash,
                                                     inp.current_goal)):
            add(t)
        return nbytes, 2 * got.obs_pred.numel() + 2 * got.initial_ctrl.numel()
    cfg, fleet, inp, normals, anchors, margins, obs_valid, lo_w, hi_w = a[:9]
    for t in (inp.pos, inp.vel, inp.current_goal, inp.desired_goal, inp.next_waypoint,
              inp.is_disturbed, inp.has_prev, fleet.nominal_velocity, fleet.radius, normals,
              anchors, margins, obs_valid, *((lo_w, hi_w) if cfg.use_sfc else ()),
              inp.qp_y0 if cfg.warm_duals else None):
        add(t)
    return nbytes, 2 * cfg.dim * got.lsc_rhs.numel() + 4 * got.lb.numel()


def one_buffer_outputs(dev, specs):
    """step_cuda._outputs' alternative: every output a view of one byte
    buffer at a 16-byte aligned offset (one allocation, three tensor
    operations a view)."""
    offsets, at = [], 0
    for _, shape, dtype in specs:
        offsets.append(at)
        at += -(-int(np.prod(shape)) * dtype.itemsize // 16) * 16
    buf = torch.empty(max(at, 16), dtype=torch.uint8, device=dev)
    return {name: buf[o:o + int(np.prod(shape)) * dtype.itemsize].view(dtype).view(shape)
            for (name, shape, dtype), o in zip(specs, offsets)}


def stage_resources(step_cuda, entry, a):
    """The kernel a stage call launched (its name in ptxas's summary), its
    registers and static shared memory (ptxas, where this process built
    the library), its dynamic shared memory a block and its blocks an SM."""
    from lsc_dr_planner_tpu_torch.ops import cuda_build

    lib = step_cuda.build()
    cfg = a[2] if entry == "neighbor_slots" else a[0]
    six = cfg.n == 5
    sel = entry == "front_with_neighbors" and cfg.OA > 0
    K = stage_build(step_cuda, entry, a)
    kernel, query = {
        "neighbor_slots": (f"neighbor_slots_kernel<{K}>", 0),
        "step_front": ("step_front_kernel" + ("<6,8,0>" if six else "<0,8,0>"), 1),
        "front_with_neighbors": (f"step_front_kernel<{6 if six else 0},{K if sel else 8},"
                                 f"{int(sel)}>", 2 if sel else 1),
        "goal_qp_inputs": ("goal_qp_inputs_kernel", 3)}[entry]
    if K == 0:
        kernel = ("neighbor_slots_wide_kernel" if entry == "neighbor_slots"
                  else f"step_front_wide_kernel<{6 if six else 0},{int(sel)}>")
    log = cuda_build.build_log.get("step_stages.cu")
    res = {"kernel": kernel, **(ptxas_summary(log[1]).get(kernel, {}) if log else {})}
    if entry == "neighbor_slots":
        dyn = lib.neighbor_slots_smem_bytes(a[0].shape[0] // a[1], cfg.OA)
    elif entry == "goal_qp_inputs":
        dyn = 0
    else:
        inp = a[2]
        fused = entry == "front_with_neighbors"
        S = (a[3] if len(a) > 3 else 1) if fused else (a[6] if len(a) > 6 else 1)
        dyn = lib.step_front_smem_bytes(inp.pos.shape[0], S, cfg.O, cfg.OA, cfg.M, cfg.n,
                                        cfg.mode, int(sel))
    res.update(dynamic_smem_bytes=dyn,
               blocks_per_sm=step_cuda.occupancy(query, cfg.n, K or 0, dyn))
    if K == 0 and entry != "neighbor_slots" and hasattr(lib, "step_front_parts"):
        res["blocks_an_agent"] = lib.step_front_parts(a[2].pos.shape[0])
    return res


def stage_timing(builds, recorders, gpu, what):
    """Each stage kernel on its first recorded call (of the entries that
    were called): its own device ms a launch and a call's ms queued back
    to back (`kernel_times`), the host ms to issue a call (also with
    `one_buffer_outputs`), its plain body's ms on the card, its bound
    (bytes at HBM_BYTES_PER_S, operations at FP32_OPS_PER_S, `stage_io`),
    registers, shared memory and blocks an SM (`stage_resources`)."""
    out = {}
    for r in recorders:
        if not r.calls:
            continue
        a, k, got, _ = r.calls[0]
        fn = lambda: r.orig(*a, **k)  # noqa: E731
        nbytes, ops = stage_io(r.name, a, k, got)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        res = stage_resources(builds.step_cuda, r.name, a)
        t = {**kernel_times(fn, builds.dev, res["kernel"].split("<")[0]),
             "host_ms": host_ms(fn, KERNEL_REPS),
             "plain_ms": cuda_ms(lambda: r.orig(*a, **k, plain=True), 5), "bytes": nbytes,
             "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        # the host's time with the outputs carved out of one buffer, against
        # the wrapper's one torch.empty an output, and the wrapper's again
        outputs = builds.step_cuda._outputs
        builds.step_cuda._outputs = one_buffer_outputs
        try:
            t["host_ms_one_buffer"] = host_ms(fn, KERNEL_REPS)
        finally:
            builds.step_cuda._outputs = outputs
        t["host_ms_again"] = host_ms(fn, KERNEL_REPS)
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t.update(res)
        t["wide"] = wide_call(builds.step_cuda, r.name, a)
        out[r.name] = t
        (getattr(builds, "wide", {}) if t["wide"] else builds.stage)[r.name].update(t)
    print(f"{what} stage kernel timing", json.dumps(out), f"[{gpu}]")
    return out


def stage_timing_main():
    """The stage kernels alone, of the checkout whose package is imported
    (an older one, as `stages_ab_main` does): built (ptxas's record
    kept), then `stage_timing` on the calls of one step after WARMUP
    evolving steps at A=1024, in the main path's layout (2-D) and in 8b's
    (3-D), the neighbour selection inside the prediction's launch and, as
    separate launches (`separate_launches`; a tree without the fused
    entry: its own two launches).
    One JSON line."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.ops import step_cuda
    from lsc_dr_planner_tpu_torch.planner import stages

    dev, gpu = torch.device("cuda", 0), gpu_line()
    build_all(step_cuda)
    out = {"package": str(Path(step_cuda.__file__).resolve().parents[1]), "gpu": gpu}
    for tag, overrides in (("main", {}), ("8b", dict(world_dimension=3)), ("8f", P8F)):
        planner, fleet, inp = main_path_state(workload, dev, **overrides)
        for fuse in ((True, False) if hasattr(stages, "front_with_neighbors") else (False,)):
            recs = stage_recorders(stages)
            with contextlib.ExitStack() as stack:
                for r in recs:
                    stack.enter_context(r)
                if not fuse:
                    stack.enter_context(separate_launches(stages))
                planner._step_impl(fleet, inp, defer_qp=True)
            builds = types.SimpleNamespace(dev=dev, step_cuda=step_cuda,
                                           stage={e: {} for e in STAGE_ENTRIES})
            what = f"{tag} {'fused' if fuse else 'separate'}"
            out[what] = stage_timing(builds, recs, gpu, what)
    print("stage timing", json.dumps(out))
    return out


def front_states(workload, dev, tags, slots):
    """[(tag, (planner, fleet, inp))]: the main path's layouts of `tags`
    ("main", "8b": 3-D, "8f": P8F) after WARMUP evolving steps, and 8g's
    2-D fleets of O + 6 agents with O = OA slots for O in `slots` after
    one ("8g O=..")."""
    layouts = {"main": {}, "8b": dict(world_dimension=3), "8f": P8F}
    states = [(tag, main_path_state(workload, dev, **layouts[tag])) for tag in tags]
    for O in slots:
        p, planner, fleet, inp = workload.build_fleet(O + 6, device=dev, max_obstacles=O,
                                                      communication_range=20.0)
        inp, _ = workload.make_evolve_step(p, planner, fleet)(inp)
        states.append((f"8g O={O}", (planner, fleet, inp)))
    return states


def recorded_front_calls(stages, states):
    """{"<tag> <entry>": (recorder, its first call)} of the selection and
    prediction entries on each state's step to qp.solve's entry, with the
    selection inside the prediction's launch and as two launches
    (`separate_launches`)."""
    calls = {}
    for tag, (planner, fleet, inp) in states:
        for fuse in (True, False):
            recs = stage_recorders(stages)
            with contextlib.ExitStack() as stack:
                for r in recs:
                    stack.enter_context(r)
                if not fuse:
                    stack.enter_context(separate_launches(stages))
                planner._step_impl(fleet, inp, defer_qp=True)
            for r in recs[:3]:
                if r.calls:
                    calls[f"{tag} {r.name}"] = (r, r.calls[0])
    return calls


def lattice_selections(stages, cfg, dev, As, OAs):
    """{"select A=.. OA=.. range=..": (recorder-like, call)} of the
    selection alone on the 0.75 m lattice (`square_lattice`) at each A and
    OA, with a 3 m range and without, on `cfg` (a StageConfig)."""
    selection = types.SimpleNamespace(name="neighbor_slots", orig=stages.neighbor_slots)
    calls = {}
    for A in As:
        pos = square_lattice(A, dev)
        for OA in OAs:
            for rng in (3.0, -1.0):
                c = dataclasses.replace(cfg, OA=OA, comm_range=rng, cache={})
                calls[f"select A={A} OA={OA} range={rng}"] = (selection,
                                                              ((pos, 1, c), {}, None, None))
    return calls


def stage_sources_main(sources):
    """The neighbour selection and the prediction kernels built from other
    `step_stages.cu` sources (of this tree's argument layout) on the same
    calls, in the order given: the calls of one step after WARMUP evolving
    steps at A=1024 in the main path's layout (2-D), in 8b's (3-D) and in
    8f's, and after one on 8g's fleets of 65 and 256 slots, fused and
    separate, and the selection alone on the 0.75 m lattice at A = 1,024
    and 5,000 (OA = 80 and 255, with and without a 3 m range); per
    source ptxas, each call's ms queued back to back and device ms
    (profiler), and its elements that differ from the plain body's (a
    variant with a part cut out, a timing breakdown, may differ). One
    JSON line a source."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.ops import step_cuda
    from lsc_dr_planner_tpu_torch.planner import stages

    dev, gpu = torch.device("cuda", 0), gpu_line()
    build_all()
    states = front_states(workload, dev, ("main", "8b", "8f"), (P8G_SLOTS[1], P8G_SLOTS[-1]))
    calls = recorded_front_calls(stages, states)
    calls.update(lattice_selections(stages, states[-1][1][0].stage_cfg, dev, (1024, 5000),
                                    (80, 255)))
    out = []
    for src in sources:
        with built_from(step_cuda, src) as ptxas:
            rec = {"source": str(src), "gpu": gpu, "ptxas": ptxas}
            for what, (r, (a, k, _, _)) in calls.items():
                fn = lambda: r.orig(*a, **k)  # noqa: E731
                got, want = fn(), r.orig(*a, **k, plain=True)
                torch.cuda.synchronize()
                kernel = stage_resources(step_cuda, r.name, a)["kernel"].split("<")[0]
                rec[what] = {
                    "queued_ms": queued_ms(fn, KERNEL_REPS),
                    "device_ms": profiled_ms(fn, dev, kernel)["own_ms"],
                    "differing": sum(differing(x, y) for (_, x), (_, y) in zip(
                        _stage_fields(r.name, got), _stage_fields(r.name, want))
                        if x is not None)}
        print("stage source", json.dumps(rec))
        out.append(rec)
    return out


def front_host_main(rounds=6):
    """The host ms of one main-path step up to qp.solve's entry
    (`_step_impl(defer_qp=True)`, behind a sleep kernel) in turns with the
    neighbour selection inside the prediction's launch and as its own
    launch (`separate_launches`; a tree without the fused entry: its one
    route),
    `rounds` times, one process, one state. One JSON line."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.planner import stages

    dev, gpu = torch.device("cuda", 0), gpu_line()
    build_all()
    planner, fleet, inp = main_path_state(workload, dev)
    rec = {"package": str(Path(workload.__file__).resolve().parent), "gpu": gpu}
    front = lambda: planner._step_impl(fleet, inp, defer_qp=True)  # noqa: E731
    for _ in range(rounds):
        for fuse in ((True, False) if hasattr(stages, "front_with_neighbors") else (False,)):
            with contextlib.nullcontext() if fuse else separate_launches(stages):
                rec.setdefault("fused" if fuse else "separate", []).append(host_ms(front, 10))
    print("front host", json.dumps(rec))
    return rec


def kernels_ab_main():
    """For the checkout whose package is imported (the parent's or this
    tree's, for an A/B in one call: import the package from its tree
    before chip_smoke): its kernels built, then in the main path's layout
    in 8b's (3-D), in 8e's (DLSC in 3-D), in 8f's (3-D past the narrow
    builds) and in 8h's (Bézier degree 8), on one step's calls after
    WARMUP evolving steps, the device ms of each kernel queued back to
    back: the ADMM loop (`admm_timing.timed_call`, max_iter iterations)
    and the build it took, in 8b, 8e, 8f and 8h also on the compacted
    rescue batch of its iterate
    (`qp.rescue_batch`, rescue_iter iterations; the wrapper's launch
    record where the tree has one), the QP preparation kernel, the step's
    stage kernels, the fused CLSC kernel and the hull query on its hulls;
    the QP preparation kernel on 8g's dim·K 246 batch (A = 168, 160 slots:
    the global build) and on the first step's QP of the other global-build
    shapes of P8G_PREP_AB; the fused CLSC kernel on 8h's layout in 3-D and
    on scattered pairs of CLSC_AB_N points a segment in 2-D and 3-D
    (`clsc_scattered`), each held to the plain body element for element;
    the wide fronts, the wide selection and the hull query's run-time
    build on their own calls (`fronts_ab`);
    in a tree with the loop's global build, that build on 8g's 480 slots
    (`global_loop_timing`), at A = 481 and on its first qp.RESCUE agents;
    the ADMM loop on the triple build's other shapes (`triple_ab_cases`);
    and ptxas's record of the ADMM kernels, the hull kernels and the
    preparation's. One JSON line."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.ops import (
        cuda_build, geometry, hull_cuda, lsc, qp, qp_cuda, qp_prepare_cuda, step_cuda,
    )
    from lsc_dr_planner_tpu_torch.planner import stages

    dev, gpu = torch.device("cuda", 0), gpu_line()
    build_all(hull_cuda, qp_prepare_cuda, qp_cuda, step_cuda)
    out = {"package": str(Path(qp_cuda.__file__).resolve().parents[1]), "gpu": gpu,
           "hull_ptxas": ptxas_summary(cuda_build.build_log.get("hull_closest.cu", (0, ""))[1]),
           "stage_ptxas": ptxas_summary(cuda_build.build_log.get("step_stages.cu", (0, ""))[1])}
    out["admm_ptxas"] = ptxas_summary(cuda_build.build_log.get("admm.cu", (0, ""))[1])
    out["prepare_ptxas"] = ptxas_summary(cuda_build.build_log.get("qp_prepare.cu", (0, ""))[1])
    over, A = next((o, a) for t, o, a in phase8g_qp_cases() if t == "dk246_O160")
    p, planner, fleet, inp = workload.build_fleet(A, device=dev, **over)
    inp, _ = workload.make_evolve_step(p, planner, fleet)(inp)
    cfg, qin = planner.qp_cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp
    ts, sc = qp.torch_statics(cfg, dev), qp.prepare_scalars(cfg)
    out["8g_dk246"] = {"A": A, "qp_prepare_ms": queued_ms(
        lambda: qp_prepare_cuda.prepare_cuda(cfg, ts, qin, sc), KERNEL_REPS)}
    for tag, over, A in P8G_PREP_AB:
        p, planner, fleet, inp = workload.build_fleet(A, device=dev, **over)
        cfg, qin = planner.qp_cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp
        ts, sc = qp.torch_statics(cfg, dev), qp.prepare_scalars(cfg)
        shape = admm_shape(qp, cfg, dev)
        out[tag] = {"A": A, "dk": cfg.dim * shape[4],
                    "build": qp_prepare_cuda.build_name(*shape[:5]),
                    "qp_prepare_ms": queued_ms(
                        lambda: qp_prepare_cuda.prepare_cuda(cfg, ts, qin, sc), KERNEL_REPS)}
    planner, fleet, inp = main_path_state(workload, dev, **dict(P8H, world_dimension=3))
    with Calls(lsc, "build_clsc") as clscs:
        planner._step_impl(fleet, inp, defer_qp=True)
    cases = {"8h_3d": clsc_args(clscs.calls[0])}
    cases.update({f"N{N}_{dim}d": (clsc_scattered(50 + N, dim, N, dev), dim)
                  for N in CLSC_AB_N for dim in (2, 3)})
    for tag, (a, dim) in cases.items():
        a = tuple(t.contiguous() for t in a)
        want = lsc.build_clsc(*a, world_dimension=dim, plain=True)
        got = hull_cuda.build_clsc_cuda(*a, dim)
        out["clsc_" + tag] = {
            "ms": queued_ms(lambda: hull_cuda.build_clsc_cuda(*a, dim), KERNEL_REPS),
            "differing": sum(differing(g, w) for g, w in zip(
                got, (want.normals, want.anchors, want.margins)))}
    if hasattr(qp_cuda, "GLOBAL_BUILD"):
        over, A = next((o, a) for t, o, a in phase8g_qp_cases() if t == P8G_GLOBAL)
        p, planner, fleet, inp = workload.build_fleet(A, device=dev, **over)
        step = workload.make_evolve_step(p, planner, fleet)
        for _ in range(2):
            inp, _ = step(inp)
        cfg = planner.qp_cfg
        li = qp.prepare(cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp).loop
        out["8g_" + P8G_GLOBAL + "_loop"] = global_loop_timing(
            qp, qp_cuda, cfg, li, planner.feas_tol, dev, P8G_GLOBAL)
        sub = li.take(torch.arange(qp.RESCUE, device=dev))  # a rescue-sized batch
        out["8g_" + P8G_GLOBAL + f"_loop_A{qp.RESCUE}"] = global_loop_timing(
            qp, qp_cuda, cfg, sub, planner.feas_tol, dev, P8G_GLOBAL + f" A={qp.RESCUE}")
    from lsc_dr_planner_tpu_torch.config import PlannerMode

    for tag, overrides in (("main", {}), ("8b", dict(world_dimension=3)),
                           ("8e", dict(world_dimension=3, planner_mode=PlannerMode.DLSC)),
                           ("8f", P8F), ("8h", P8H)):
        planner, fleet, inp = main_path_state(workload, dev, **overrides)
        recs = stage_recorders(stages)
        with contextlib.ExitStack() as stack:
            for r in recs:
                stack.enter_context(r)
            clscs = stack.enter_context(Calls(lsc, "build_clsc"))
            d = planner._step_impl(fleet, inp, defer_qp=True)
        cfg, tol = planner.qp_cfg, planner.feas_tol
        li = qp.prepare(cfg, d.qp_inp).loop
        qp_cuda.reset_launches()
        shape, lib = admm_shape(qp, cfg, dev), qp_cuda.build()
        rec = {"admm": admm_timing.timed_call(qp, cfg, li, cfg.max_iter, tol, tag, 10),
               "admm_builds": sorted(qp_cuda.build_launches)}
        rec["admm"].update(getattr(qp_cuda, "last_launch", None) or {
            "smem_bytes": lib.admm_smem_bytes(*shape),
            "ctas_per_sm": lib.admm_blocks_per_sm(*shape)})
        if tag != "main":
            xi, z, y = qp.run_loop(cfg, li, cfg.max_iter, tol)[:3]
            sub = qp.rescue_batch(cfg, li, xi, z, y, tol)[2]
            rec["admm_rescue"] = admm_timing.timed_call(qp, cfg, sub, cfg.rescue_iter, tol,
                                                        tag + " rescue", 10)
            rec["admm_rescue"].update(getattr(qp_cuda, "last_launch", None) or {})
        ts, sc = qp.torch_statics(cfg, dev), qp.prepare_scalars(cfg)
        rec["qp_prepare_ms"] = queued_ms(
            lambda: qp_prepare_cuda.prepare_cuda(cfg, ts, d.qp_inp, sc), KERNEL_REPS)
        for r in recs:
            if r.calls:
                a, k = r.calls[0][:2]
                rec[r.name + "_ms"] = queued_ms(lambda: r.orig(*a, **k), KERNEL_REPS)
        a, dim = clsc_args(clscs.calls[0])
        a = tuple(t.contiguous() for t in a)
        rec["clsc_build_ms"] = queued_ms(lambda: hull_cuda.build_clsc_cuda(*a, dim), KERNEL_REPS)
        x = clsc_plain_query(lsc, geometry, a, dim)
        rec["hull_closest_ms"] = queued_ms(
            lambda: hull_cuda.closest_point_origin_to_hull_cuda(x), KERNEL_REPS)
        out[tag] = rec
    for tag, overrides, A in triple_ab_cases():
        p, planner, fleet, inp = workload.build_fleet(A, device=dev, **overrides)
        step = workload.make_evolve_step(p, planner, fleet)
        for _ in range(WARMUP):
            inp, _ = step(inp)
        cfg, tol = planner.qp_cfg, planner.feas_tol
        li = qp.prepare(cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp).loop
        qp_cuda.reset_launches()
        rec = admm_timing.timed_call(qp, cfg, li, cfg.max_iter, tol, tag, 10)
        rec.update(getattr(qp_cuda, "last_launch", None) or {}, A=A,
                   dk=cfg.dim * admm_shape(qp, cfg, dev)[4], builds=sorted(qp_cuda.build_launches))
        out[tag] = {"admm": rec}
    out["fronts"] = fronts_ab(dev)
    print("kernels ab", json.dumps(out))
    return out


P8G_SELECT_AB = (33, 80, 128, 255)  # the wide selection's OA of P8G_SELECT


def stage_ab_record(step_cuda, entry, a, fn, plain_fn, dev):
    """One stage call's A/B record: its kernel's own device ms a launch and
    the call's (`kernel_times`), the kernel and its build's name, and the
    elements that differ from the plain body's on the same inputs."""
    kernel = stage_resources(step_cuda, entry, a)["kernel"]
    got, want = fn(), plain_fn()
    torch.cuda.synchronize()
    rec = {"kernel": kernel, **kernel_times(fn, dev, kernel.split("<")[0]),
           "differing": sum(differing(x, y) for (_, x), (_, y) in zip(
               _stage_fields(entry, got), _stage_fields(entry, want)) if x is not None)}
    return rec


def fronts_ab(dev):
    """For the checkout whose package is imported, on one step's calls:
    the wide prediction and the wide fused front (the selection inside
    the prediction's launch, and as two launches: `separate_launches`) at
    8f after WARMUP evolving steps (and the narrow builds at 8b's, 3-D)
    and at 8g's 2-D fleets of O + 6 agents
    with O = OA slots (P8G_SLOTS) after one; the wide selection alone on
    the 0.75 m lattice at P8G_SELECT's A and P8G_SELECT_AB's OA, with and
    without a 3 m range; and the hull query's run-time build on the hulls
    of 8h's plain-LSC query (build_fleet(1024, n=8) with static goals,
    the step after WARMUP evolving steps). Each: `stage_ab_record` (the
    hull query: its own device ms, the call's, the hulls that differ from
    the plain enumeration's)."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.ops import geometry, hull_cuda, step_cuda
    from lsc_dr_planner_tpu_torch.planner import stages

    out = {}
    states = front_states(workload, dev, ("8b", "8f"), P8G_SLOTS)
    calls = recorded_front_calls(stages, states)
    calls.update(lattice_selections(stages, states[-1][1][0].stage_cfg, dev, P8G_SELECT[0],
                                    P8G_SELECT_AB))
    for what, (r, (a, k, _, _)) in calls.items():
        out[what] = stage_ab_record(step_cuda, r.name, a, lambda: r.orig(*a, **k),
                                    lambda: r.orig(*a, **k, plain=True), dev)
    x = p8h_query_hulls(workload, dev)
    out["8h query"] = hull_ab_record(hull_cuda, geometry, x, dev)
    return out


def source_variant(src, subs, name):
    """A copy of the kernel source `src` under build/variants/, named
    `name`, with each (pattern, replacement) of `subs` made once."""
    text = Path(src).read_text()
    for pattern, replacement in subs:
        text, n = re.subn(pattern, replacement, text)
        assert n == 1, (name, pattern, n)
    path = ROOT / "build" / "variants" / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


# the wide prediction's stream with other runs of four a thread in flight
# (kUnroll); the wide selection with eight candidates' loads at once
# (kBitsUnroll), and with one atomic a distinct digit a warp in its later
# passes too (hist_add, not one a lane)
STAGE_VARIANTS = {
    **{f"unroll{u}": ((r"constexpr int kUnroll = \d+;", f"constexpr int kUnroll = {u};"),)
       for u in (1, 4)},
    "bits8": ((r"constexpr int kBitsUnroll = \d+;", "constexpr int kBitsUnroll = 8;"),),
    "warp_atomics": ((r"if \(in\) atomicAdd\(hist \+ \(\(b >> shift\) & 255\), 1u\);",
                      "hist_add(hist, (b >> shift) & 255, in, lane);"),)}


def stage_variants_main(variants=STAGE_VARIANTS):
    """`stage_sources_main` on this tree's csrc/step_stages.cu and on its
    copies with the substitutions of `variants` (`source_variant`)."""
    from lsc_dr_planner_tpu_torch.ops import step_cuda

    return stage_sources_main([step_cuda.SOURCE] + [
        source_variant(step_cuda.SOURCE, subs, f"step_stages_{name}.cu")
        for name, subs in variants.items()])


# clock64 marks in a copy of csrc/step_stages.cu (`front_marks_main`): thread
# 0 of each block of the wide prediction stores clock64() at these points
# into g_marks[block][point]
FRONT_MARKS = ("entry", "bits", "passes", "placed", "selected", "slots", "attributes",
               "predictions", "end")


def front_marks_source():
    """A copy of csrc/step_stages.cu under build/variants/ whose wide
    prediction kernel (and select_wide) stores clock64() at FRONT_MARKS
    into a device array while marking is on (front_marks_read(zeros, n,
    1) clears it and turns it on, front_marks_read(buf, n, 0) reads it
    and turns it off); a barrier before the last mark, so that it is the
    block's end."""
    from lsc_dr_planner_tpu_torch.ops import step_cuda

    def mark(k):
        return (f"if (threadIdx.x == 0 && g_marking) g_marks[blockIdx.x * {len(FRONT_MARKS)} + "
                f"{k}] = clock64();\n")

    at = {name: k for k, name in enumerate(FRONT_MARKS)}
    subs = (
        (r"(namespace \{\n\nconstexpr int kBlockThreads)",
         r"__device__ long long g_marks[" + str(len(FRONT_MARKS)) + r" * 65536];\n"
         r"__device__ int g_marking;\n\1"),
        (r"(  // the distance bits of the OA-th smallest key: `prefix` its bits under)",
         "  " + mark(at["bits"]) + r"\1"),
        (r"(  // the keys below the threshold \(OA - need of them\) and the `need` lowest)",
         "  " + mark(at["passes"]) + r"\1"),
        (r"(  // ascending\. Where the threshold is one distance)",
         "  " + mark(at["placed"]) + r"\1"),
        (r"(step_front_wide_kernel\(FrontArgs a\) \{\n)", r"\1  " + mark(at["entry"])),
        (r"(    const u64\* s_key = select_wide\(P.src_pos \+ first \* 3, per, ag - s \* per, "
         r"OA, a.range,\n\s+a.use_range != 0, s_t \+ L.u\);\n)", r"\1    " + mark(at["selected"])),
        (r"(  // 2. one thread a slot)", "  " + mark(at["slots"]) + r"\1"),
        (r"(  const u64\* s_key = select_wide\(pos \+ first \* 3, A, i, OA, range, use_range != 0,"
         r"\n\s+reinterpret_cast<float\*>\(smem4\)\);\n)",
         "  " + mark(at["entry"]) + r"\1  " + mark(at["selected"])),
        (r"(  // 3. the attributes from the tables)", "  " + mark(at["attributes"]) + r"\1"),
        (r"(  // 4. the predictions)", "  " + mark(at["predictions"]) + r"\1"),
        (r"(    \}, none\);\n  \}\n)(\}\n\n// -+\n// stage 5)",
         r"\1  __syncthreads();\n  " + mark(at["end"]) + r"\2"),
        (r"(extern \"C\" int goal_qp_inputs_launch)",
         r'extern "C" int front_marks_read(long long* host, int n, int on) {\n'
         r"  if (cudaMemcpyToSymbol(g_marking, &on, sizeof(int)) != cudaSuccess) return -1;\n"
         r"  const size_t bytes = n * sizeof(long long);\n"
         r"  return static_cast<int>(on ? cudaMemcpyToSymbol(g_marks, host, bytes)\n"
         r"                             : cudaMemcpyFromSymbol(host, g_marks, bytes));\n}\n\n\1"))
    return source_variant(step_cuda.SOURCE, subs, "step_stages_marks.cu")


def front_marks_main():
    """The wide fused front, the wide prediction alone and the wide
    selection alone at 8f (after WARMUP evolving steps) and at 8g's 65
    and 256 slots, and the selection on the 0.75 m lattice at A = 1,024
    and 5,000 (OA = 80 and 255, with and without a 3 m range), built from
    `front_marks_source`: per call, each FRONT_MARKS point's clock64
    cycles after the block's entry, the mean and the largest over the
    blocks (clock64 counts an SM's cycles: each block's marks against
    its own entry); the call's own device ms beside the unmarked
    kernel's (`profiled_ms`). One JSON line."""
    import ctypes

    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.ops import step_cuda
    from lsc_dr_planner_tpu_torch.planner import stages

    dev, gpu = torch.device("cuda", 0), gpu_line()
    src = front_marks_source()
    states = front_states(workload, dev, ("8f",), (P8G_SLOTS[1], P8G_SLOTS[-1]))
    recorded = recorded_front_calls(stages, states)
    recorded.update(lattice_selections(stages, states[-1][1][0].stage_cfg, dev, (1024, 5000),
                                       (80, 255)))
    lib = step_cuda.build()
    calls = {}  # what: (fn, blocks of its launch, kernel)
    for what, (r, (a, k, _, _)) in recorded.items():
        alone = r.name == "neighbor_slots"
        A = a[0].shape[0] if alone else a[2].pos.shape[0]
        calls[what] = (functools.partial(r.orig, *a, **k),
                       A if alone else A * lib.step_front_parts(A),
                       "neighbor_slots_wide_kernel" if alone else "step_front_wide_kernel")
    rec = {"gpu": gpu}
    for what, (fn, _, kernel) in calls.items():
        rec[what] = {"unmarked_ms": profiled_ms(fn, dev, kernel)["own_ms"]}
    P = len(FRONT_MARKS)
    with built_from(step_cuda, src) as ptxas:
        lib = step_cuda.build()
        lib.front_marks_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        for what, (fn, blocks, kernel) in calls.items():
            rec[what]["marked_ms"] = profiled_ms(fn, dev, kernel)["own_ms"]
            buf = np.zeros(blocks * P, np.int64)
            torch.cuda.synchronize()
            assert lib.front_marks_read(buf.ctypes.data, blocks * P, 1) == 0
            fn()
            torch.cuda.synchronize()
            assert lib.front_marks_read(buf.ctypes.data, blocks * P, 0) == 0
            m = buf.reshape(blocks, P)
            assert (m[:, 0] > 0).all(), what
            hit = m > 0
            rel = m - m[:, :1]
            rec[what].update(
                blocks=blocks,
                cycles_mean={name: float(rel[hit[:, i], i].mean())
                             for i, name in enumerate(FRONT_MARKS) if hit[:, i].any()},
                cycles_max={name: int(rel[hit[:, i], i].max())
                            for i, name in enumerate(FRONT_MARKS) if hit[:, i].any()})
        rec["ptxas"] = {key: v for key, v in ptxas.items() if "wide" in key}
    print("front marks", json.dumps(rec))
    return rec


def p8h_query_hulls(workload, dev):
    """The hulls of 8h's plain-LSC query (build_lsc's, [A, O, M, 9, 3]):
    build_fleet(1024, n=8) with static goals, the step after WARMUP
    evolving steps."""
    from lsc_dr_planner_tpu_torch.config import GoalMode
    from lsc_dr_planner_tpu_torch.ops import geometry

    p, planner, fleet, inp = workload.build_fleet(A_MAIN, device=dev,
                                                  goal_mode=GoalMode.STATIC, **P8H)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(WARMUP):
        inp, _ = step(inp)
    with Calls(geometry, "closest_point_origin_to_hull") as hulls:
        planner._step_impl(fleet, inp, defer_qp=True)
    return hulls.calls[0][0][0]


def hull_ab_record(hull_cuda, geometry, x, dev):
    """The hull query's kernel on the hulls x: its own device ms a launch
    and the call's (`kernel_times`), and the hulls that differ from the
    plain enumeration's."""
    rt = hull_cuda.hull_closest_plan(x.shape[-2])[0]
    fn = lambda: hull_cuda.closest_point_origin_to_hull_cuda(x)  # noqa: E731
    got, want = fn(), geometry.closest_point_origin_to_hull(x, plain=True)
    torch.cuda.synchronize()
    H = want[1].numel()
    rec = {"shape": list(x.shape),
           **kernel_times(fn, dev, "hull_closest_rt_kernel" if rt else "hull_closest_kernel"),
           "hulls_differing": int(sum(((g != w) & ~(g.isnan() & w.isnan())).view(H, -1).any(1)
                                      for g, w in zip(got, want)).bool().sum())}
    return rec


# the query's run-time build in other layouts: (hulls a block, the blocks an
# SM its __launch_bounds__ caps the registers for)
HULL_RT_VARIANTS = ((128, 10), (128, 8), (128, 1), (96, 14), (64, 20), (64, 16))


def hull_rt_variants_main(variants=HULL_RT_VARIANTS):
    """The hull query's run-time build from copies of csrc/hull_closest.cu
    under build/variants/ with other hulls a block and __launch_bounds__
    minimum blocks (its kRtHulls, kRtMinBlocks), built together, on the
    hulls of 8h's plain-LSC query (`p8h_query_hulls`): per variant
    ptxas's registers and spills, hulls a block and blocks an SM, and
    `hull_ab_record`. One JSON line."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.ops import cuda_build, geometry, hull_cuda

    dev, gpu = torch.device("cuda", 0), gpu_line()
    paths = [source_variant(hull_cuda.SOURCE, (
        (r"constexpr int kRtHulls = \d+;", f"constexpr int kRtHulls = {hulls};"),
        (r"constexpr int kRtMinBlocks = \d+;", f"constexpr int kRtMinBlocks = {blocks};")),
        f"hull_closest_h{hulls}_b{blocks}.cu") for hulls, blocks in variants]
    with ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(lambda path: cuda_build.compile_source(path, True), paths))
    x = p8h_query_hulls(workload, dev)
    rec = {"gpu": gpu}
    for (hulls, blocks), path in zip(variants, paths):
        with built_from(hull_cuda, path) as ptxas:
            rec[f"{hulls}x{blocks}"] = {
                "ptxas": ptxas.get("hull_closest_rt_kernel"),
                "hulls_a_block, blocks_per_sm": hull_cuda.hull_closest_occupancy(x.shape[-2]),
                **hull_ab_record(hull_cuda, geometry, x, dev)}
    print("hull rt variants", json.dumps(rec))
    return rec


def fronts_ab_main():
    """`fronts_ab` alone, for the checkout whose package is imported (as
    `kernels_ab_main`), with ptxas's record of the stage and hull kernels.
    One JSON line."""
    from lsc_dr_planner_tpu_torch.ops import cuda_build, hull_cuda, step_cuda

    dev, gpu = torch.device("cuda", 0), gpu_line()
    build_all(hull_cuda, step_cuda)
    out = {"package": str(Path(step_cuda.__file__).resolve().parents[1]), "gpu": gpu,
           **{f"{src}_ptxas": ptxas_summary(cuda_build.build_log.get(src + ".cu", (0, ""))[1])
              for src in ("step_stages", "hull_closest")},
           **fronts_ab(dev)}
    print("fronts ab", json.dumps(out))
    return out


def triple_ab_cases():
    """(tag, build_fleet overrides, agents) of `kernels_ab_main`'s other
    shapes of the triple build's range (dim·K 61–96): 3-D at M = 11 (dim·K
    93, the ten-warp width) at 8g's 64 agents and at 1,024, and 2-D at M =
    12 (68) and in DLSC at M = 16 (96, the ten-warp width) at 1,024."""
    from lsc_dr_planner_tpu_torch.config import PlannerMode

    return (("8g_dk93", dict(world_dimension=3, M=11), 64),
            ("dk93", dict(world_dimension=3, M=11), A_MAIN),
            ("2d_dk68", dict(M=12), A_MAIN),
            ("2d_dk96", dict(M=16, planner_mode=PlannerMode.DLSC), A_MAIN))


# 8g's preparation at its other global-build shapes, on the first step's QP
# (the parent's loop refuses 480 slots, so no evolving step): 481 agents at
# 480 slots, past the 264 blocks of 512 threads the card holds at once; 3-D
# at M = 25 (dim·K 219), the shortest horizon that takes the global build,
# at 168 and 1,024 agents
P8G_PREP_AB = (("8g_dk246_O480", dict(world_dimension=3, M=28, communication_range=30.0,
                                      max_obstacles=480), 481),
               ("8g_dk219", dict(world_dimension=3, M=25), 168),
               ("8g_dk219_A1024", dict(world_dimension=3, M=25), 1024))
CLSC_AB_N = (9, 10, 11, 12)  # the CLSC run-time build's N in the `cuda` tests


def clsc_scattered(seed, dim, N, dev, A=256, O=16, M=10):
    """build_clsc's ten inputs on `dev`, from `seed`: A agents' M segments
    of N control points, O neighbours each scattered about them (some of
    them obstacles, some slots masked), goals beside the last segments so
    that the last segment's guard holds for some pairs; in 2-D every point
    at z = 0.6 (the spread of tests/test_torch_clsc_kernel.py's `clsc_inputs`)."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    init = f32(A, M, N, 3)
    obs = init[:, None] + 0.8 + f32(A, O, M, N, 3, scale=0.5)
    obs_goal = f32(A, O, 3)
    if dim == 2:
        init[..., 2] = obs[..., 2] = obs_goal[..., 2] = 0.6
    x = (init, obs, obs_goal, 0.15 + f32(A, scale=0.01), np.full(A, 2.0, np.float32),
         0.15 + f32(A, O, scale=0.02),
         np.where(rng.uniform(size=(A, O)) < 0.5, 2.0, 1.0).astype(np.float32),
         rng.uniform(size=(A, O)) < 0.7,
         (init[:, -1, -1] + 3.0 * (init[:, -1, -1] - obs[:, 0, -1, -1])).astype(np.float32),
         rng.uniform(size=(A, O)) < 0.7)
    return tuple(torch.as_tensor(v).to(dev) for v in x)


def build_all(*verbose):
    """Builds the imported package's kernel libraries, one nvcc each, all
    at once (the wrappers `verbose` names keep ptxas's record)."""
    from lsc_dr_planner_tpu_torch.ops import hull_cuda, qp_cuda, qp_prepare_cuda, sfc_cuda

    wrappers = [qp_cuda, sfc_cuda, hull_cuda, qp_prepare_cuda]
    try:
        from lsc_dr_planner_tpu_torch.ops import step_cuda
        wrappers.append(step_cuda)
    except ImportError:  # a tree without the stage kernels
        pass
    with ThreadPoolExecutor(len(wrappers)) as pool:
        for done in [pool.submit(w.build, w in verbose) for w in wrappers]:
            done.result()


def stages_ab_main():
    """For the checkout whose package is imported (an older one, the
    parent's, as `qp_ab_main` does): its kernels built, then in the main
    path's layout and in 8a's (DLSC sub-step) WARMUP and TIMED evolving
    steps (step p50, mean stage ms, QP convergence), and one step from
    its start to qp.solve's entry (`_step_impl(defer_qp=True)`) under the
    profiler: the device kernels and copies it issued, and its host ms
    (behind a sleep kernel); in a tree with the fused entry also the main
    path with the neighbour selection and the prediction as two launches
    ("main_separate", `separate_launches`). One JSON line."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.config import PlannerMode
    from lsc_dr_planner_tpu_torch.ops import qp_cuda
    from lsc_dr_planner_tpu_torch.planner import stages as stage_ops
    from lsc_dr_planner_tpu_torch.tools import sfc_bench

    dev, gpu = torch.device("cuda", 0), gpu_line()
    build_all()
    rec = {"package": str(Path(qp_cuda.__file__).resolve().parents[1]), "gpu": gpu}
    for tag, overrides in (("main", {}),
                           ("8a", dict(planner_mode=PlannerMode.DLSC, multisim_time_step=0.1)),
                           ("main_separate", {})):  # last: the parent's runs have none
        separate = tag == "main_separate"
        if separate and not hasattr(stage_ops, "front_with_neighbors"):
            continue
        with separate_launches(stage_ops) if separate else contextlib.nullcontext():
            p, planner, fleet, inp = workload.build_fleet(A_MAIN, device=dev, timing=True,
                                                          **overrides)
            step = workload.make_evolve_step(p, planner, fleet)
            for _ in range(WARMUP):
                inp, _ = step(inp)
            inp, lat, stages, convs = admm_timing.timed_steps(step, planner, inp, TIMED)
            front = lambda: planner._step_impl(fleet, inp, defer_qp=True)  # noqa: E731
            prof = sfc_bench.launch_counts(front, dev)
            rec[tag] = {"p50_ms": float(np.percentile(lat, 50) * 1e3),
                        "stage_ms": admm_timing.mean_stages(stages),
                        "qp_convergence": float(np.mean(convs)),
                        "before_solve": {**{key: prof[key] for key in (
                            "device_kernels", "device_copies", "device_busy_ms",
                            "host_launch_calls")}, "host_ms": host_ms(front, 10)}}
    print("stages ab", json.dumps(rec))
    return rec


SLEEP_CYCLES = 100_000_000  # ~50 ms of the card's clock: time to queue the timed calls


def queued_ms(fn, reps):
    """Mean device ms of fn() over `reps` calls queued behind a sleep
    kernel (torch.cuda._sleep), after one warm-up call: the calls run
    back to back on the card, so the host's time to issue each (the
    wrapper's checks and allocations) does not count."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn, reps):
    """Mean host ms to issue fn() over `reps` calls queued behind a sleep
    kernel, after one warm-up call: the card is busy all along, so no call
    waits for it and the time is the host's alone (Python, the
    allocations, the launches)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def differing(a, b):
    """Elements of a and b that differ by value (a NaN equal to a NaN)."""
    if a.is_floating_point():
        return int(((a != b) & ~(a.isnan() & b.isnan())).sum())
    return int((a != b).sum())


def max_err(a, b):
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().nan_to_num(0.0).max())


def hull_check(geometry, hull_cuda, builds, calls, what):
    """The hull kernel against the plain enumeration on the card, on the
    hulls of the recorded calls of a path: the path's own result (the
    kernel's), one more launch of the kernel and the plain enumeration
    (plain=True) on the same points give equal points and distances by
    value, hull for hull; the kernel on the negated points gives the
    negated points and the same distances. Returns the per-call records."""
    assert calls.calls, f"{what}: no hull query recorded"
    recs = []
    for a, k, got, caller in calls.calls:
        assert not k.get("plain") and a[0].device.type == "cuda", what
        recs.append(hull_record(geometry, hull_cuda, a[0], got, caller))
    print(f"{what} hull_check", json.dumps(recs))
    assert all(r["hulls_differing"] == 0 and r["not_odd"] == 0 for r in recs), (what, recs)
    builds.note_hull_check(recs)
    return recs


def hull_record(geometry, hull_cuda, x, got, caller):
    """One call's record of `hull_check`: the kernel's result `got` on the
    hulls `x` against one more launch and the plain enumeration, and its
    oddness."""
    again = hull_cuda.closest_point_origin_to_hull_cuda(x)
    want = geometry.closest_point_origin_to_hull(x, plain=True)
    neg = hull_cuda.closest_point_origin_to_hull_cuda(-x)
    H = want[1].numel()

    def ne(a, b):  # by value, a NaN equal to a NaN: per hull
        return ((a != b) & ~(a.isnan() & b.isnan())).view(H, -1).any(1)

    differ = torch.zeros(H, dtype=torch.bool, device=x.device)
    for a, b in zip(got, want):
        differ |= ne(a, b)
    for a, b in zip(again, got):
        differ |= ne(a, b)
    odd = ne(neg[0], -got[0]) | ne(neg[1], got[1])
    return {"caller": caller, "hulls": H, "K": x.shape[-2],
            "rt": hull_cuda.hull_closest_plan(x.shape[-2])[0],
            "dim": 2 if not bool(x[..., 2].any()) else 3,
            "inside": int((want[1] == 0).sum()), "hulls_differing": int(differ.sum()),
            "not_odd": int(odd.sum()), "max_abs_err": max(max_err(a, b) for a, b in zip(got, want))}


KERNEL_REPS = 50  # launches of a kernel timed back to back


# profiles of a call before `profiled_ms` gives up on the named kernel (on the
# H100 the profiler has once seen none of a call's 50 ctypes launches)
PROFILE_TRIES = 3


def device_event_name(name):
    """A device event's kernel name without its namespace, template
    arguments and parameters (e.g. step_front_wide_kernel); a copy's
    event name as it is."""
    m = re.search(r"(?:^|::|\s)(\w+)[<(]", name)
    return m.group(1) if m else name


def profiled_ms(fn, dev, kernel, reps=KERNEL_REPS):
    """`reps` calls of fn() under torch.profiler: "own_ms", the device ms
    of one launch of `kernel` (its name without template arguments), the
    mean over that kernel's own events (None where the profiler saw none;
    it may miss some ctypes launches, so this is not a busy time over the
    launches); "call_device_ms", the device ms a call of every kernel and
    copy the calls ran; "kernels_a_call", each kernel's and copy's events
    a call by name (profiled again, PROFILE_TRIES times at most, where the
    kernel was not seen). A wrapper that copies an input first (3-D's
    prev_ctrl, a permuted view) shows the copy's kernel beside its own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(dev)
        own, busy_us, seen = [], 0.0, {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            busy_us += us
            name = device_event_name(e.name)
            seen[name] = seen.get(name, 0) + 1 / reps
            if name == kernel:
                own.append(us)
        if own:
            break
    return {"own_ms": sum(own) / len(own) / 1e3 if own else None,
            "call_device_ms": busy_us / reps / 1e3, "kernels_a_call": seen}


def kernel_times(fn, dev, kernel, reps=KERNEL_REPS):
    """A kernel's times on the calls fn(): "ms" and "device_ms", its own
    device ms a launch (`profiled_ms`; asserted seen); "queued_ms", a call's
    ms queued back to back (CUDA events: every kernel and copy of the
    call, `queued_ms`); "call_device_ms" and "kernels_a_call" as
    `profiled_ms` gives them."""
    prof = profiled_ms(fn, dev, kernel, reps)
    assert prof["own_ms"] is not None, (kernel, prof["kernels_a_call"])
    return {"ms": prof["own_ms"], "device_ms": prof["own_ms"],
            "queued_ms": queued_ms(fn, reps), "call_device_ms": prof["call_device_ms"],
            "kernels_a_call": prof["kernels_a_call"]}


def hull_timing(geometry, hull_cuda, builds, x, gpu, what):
    """The hull kernel (hull_closest, build_lsc's query) on the hulls `x`
    of a path's CLSC construction (its plain body's query): the kernel
    against the plain enumeration (`hull_record`, noted as a check), its
    own device ms a launch and a call's ms queued back to back
    (`kernel_times`), the plain enumeration's ms on the card, its
    registers, spills, shared memory and blocks an SM (`hull_resources`)
    and the bound of this call's work (`hull_bound`)."""
    got = hull_cuda.closest_point_origin_to_hull_cuda(x)
    check = hull_record(geometry, hull_cuda, x, got, "build_clsc (plain body)")
    assert check["hulls_differing"] == 0 and check["not_odd"] == 0, (what, check)
    builds.note_hull_check([check])
    rt = hull_cuda.hull_closest_plan(x.shape[-2])[0]
    t = kernel_times(lambda: hull_cuda.closest_point_origin_to_hull_cuda(x), x.device,
                     "hull_closest_rt_kernel" if rt else "hull_closest_kernel")
    plain_ms = cuda_ms(lambda: geometry.closest_point_origin_to_hull(x, plain=True), 10)
    rec = {"shape": list(x.shape), "dim": check["dim"], **t, "plain_ms": plain_ms, "rt": rt,
           **hull_resources(hull_cuda, x.shape[-2]), **hull_bound(x)}
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    print(f"{what} hull timing", json.dumps(rec), f"[{gpu}]")
    return rec


def hull_resources(hull_cuda, K):
    """The hull query's build for K-point hulls: its registers and spills
    (ptxas, where this process built the library), its shared memory and
    hulls a block, and its blocks an SM."""
    from lsc_dr_planner_tpu_torch.ops import cuda_build

    rt, smem = hull_cuda.hull_closest_plan(K)
    hulls, blocks = hull_cuda.hull_closest_occupancy(K)
    log = cuda_build.build_log.get("hull_closest.cu")
    kernel = "hull_closest_rt_kernel" if rt else f"hull_closest_kernel<{K}>"
    return {"kernel": kernel, "ptxas": ptxas_summary(log[1]).get(kernel) if log else None,
            "smem_bytes": smem, "hulls_a_block": hulls, "blocks_per_sm": blocks}


def clsc_args(call):
    """(the 10 tensors, world_dimension) of a recorded build_clsc call."""
    a, k = call[0], call[1]
    return a[:10], k.get("world_dimension", a[10] if len(a) > 10 else None)


def clsc_check(lsc, builds, calls, what):
    """The fused CLSC kernel against the plain body on the card, on the
    recorded build_clsc calls of a path: the path's own result (the
    kernel's), one more launch and the plain body (plain=True) on the
    same inputs give equal normals, anchors and margins by value, element
    for element. Returns the per-call records."""
    from lsc_dr_planner_tpu_torch.ops import hull_cuda

    assert calls.calls, f"{what}: no build_clsc call recorded"
    recs = []
    for call in calls.calls:
        a, dim = clsc_args(call)
        got = call[2]
        assert not call[1].get("plain") and a[1].device.type == "cuda", what
        again = lsc.build_clsc(*a, world_dimension=dim)
        want = lsc.build_clsc(*a, world_dimension=dim, plain=True)
        names = ("normals", "anchors", "margins")
        n_diff = sum(differing(getattr(got, n), getattr(want, n))
                     + differing(getattr(again, n), getattr(got, n)) for n in names)
        A, O, M, N = a[1].shape[:4]
        recs.append({"agents": A, "pairs": A * O, "hulls": A * O * M, "N": N, "dim": dim,
                     "rt": hull_cuda.clsc_build_plan(A, O, M, N)[0],
                     "elements": sum(getattr(want, n).numel() for n in names),
                     "masked_pairs": int((~a[9]).sum()), "elements_differing": n_diff,
                     "max_abs_err": max(max_err(getattr(got, n), getattr(want, n))
                                        for n in names)})
    print(f"{what} clsc_check", json.dumps(recs))
    assert all(r["elements_differing"] == 0 for r in recs), (what, recs)
    builds.note_clsc_check(recs)
    return recs


def clsc_plain_query(lsc, geometry, a, dim):
    """The hull query's points of build_clsc's plain body on `a` (the
    kernel queries the same hulls inside)."""
    seen = []
    query = geometry.closest_point_origin_to_hull

    def record(points, **k):
        seen.append(points)
        return query(points, **k)

    geometry.closest_point_origin_to_hull = record
    try:
        lsc.build_clsc(*a, world_dimension=dim, plain=True)
    finally:
        geometry.closest_point_origin_to_hull = query
    (x,) = seen
    return x


# The CLSC construction's least operations beyond its hull queries
# (`hull_ops`), counted as `hull_ops` counts: per hull, the 3·N
# differences rel = init − obs, in 3-D the 2·N z-scalings, the normal's 3
# divisions, N projections and margins (a dot product, an addition, a
# halving each) and the world normal's division; per pair, the downwash
# (5), the segment construction in full (69: 9 differences, 5 dot
# products, the parameters' 13, both points' 12, the distance's 6),
# normal_last (3), margin_last (2), the guard (1, then N differences and
# dot products), in 3-D the goals' 2 z-scalings. Bytes: each input read
# once (a pair's neighbour points, goal, radius, downwash, flags; an
# agent's initial points, radius, downwash, goal), each output written once.
CLSC_PAIR_OPS = 5 + 69 + 3 + 2 + 1


def clsc_bound(a, dim, x):
    """The least time of build_clsc on its inputs `a` (the hulls' points
    `x` from its plain body) on an H100 SXM: the larger of its least
    operations at FP32_OPS_PER_S and its bytes at 3.35 TB/s."""
    A, O, M, N = a[1].shape[:4]
    pairs, hulls = A * O, A * O * M
    pts = M * N * 3 * 4
    bytes_ = pairs * (pts + 12 + 4 + 4 + 1 + 1 + pts + M * 3 * 4 + M * N * 4) + A * (pts + 20)
    hull = hull_ops(x)[0]
    ops = (hull + hulls * (3 * N + (2 * N if dim == 3 else 0) + 3 + N * (DOT + 2) + 1)
           + pairs * (CLSC_PAIR_OPS + N * (3 + DOT) + (2 if dim == 3 else 0)))
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bytes_ms = bytes_ / 3.35e12 * 1e3
    return {"pairs": pairs, "hulls": hulls, "N": N, "bytes": bytes_, "ops": ops,
            "hull_ops": hull, "ops_per_hull": ops / hulls, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def clsc_timing(lsc, hull_cuda, geometry, calls, gpu, what):
    """The fused CLSC kernel on the first recorded build_clsc call: its own
    device ms a launch and a call's ms queued back to back
    (`kernel_times`), the plain body's ms on the card,
    and the bound of this call's work (`clsc_bound`). Returns the record
    and the hulls' points (for `hull_timing`)."""
    a, dim = clsc_args(calls.calls[0])
    a = tuple(t.contiguous() for t in a)

    def launch():
        return hull_cuda.build_clsc_cuda(*a, dim)

    rt, smem = hull_cuda.clsc_build_plan(*a[1].shape[:4])
    t = kernel_times(launch, a[1].device, "clsc_build_rt_kernel" if rt else "clsc_build_kernel")
    plain_ms = cuda_ms(lambda: lsc.build_clsc(*a, world_dimension=dim, plain=True), 5)
    x = clsc_plain_query(lsc, geometry, a, dim)
    rec = {"shape": list(a[1].shape), "dim": dim, **t, "plain_ms": plain_ms, "rt": rt,
           "smem_bytes": smem, "blocks_per_sm": hull_cuda.clsc_build_occupancy(*a[1].shape[:4]),
           **clsc_bound(a, dim, x)}
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    print(f"{what} clsc timing", json.dumps(rec), f"[{gpu}]")
    return rec, x


def sfc_update_args(call):
    """(args, kwargs) of a recorded update_sfc call, without `plain`."""
    return call[0], {x: v for x, v in call[1].items() if x != "plain"}


def sfc_hull_check(sfc, builds, calls, what, radius=None):
    """The fused 'hull' SFC kernel against the plain body on the card, on
    the recorded 'hull'-mode update_sfc calls of a path (`radius`
    replaces their clamp): the path's own boxes (the kernel's), one more
    launch and the plain body (plain=True: torch seeding and selection
    around the plain loop, then sfc_to_world) give equal lattice boxes,
    world boxes and lanes (seeds, results, seed-free flags), element for
    element. Returns the per-call records."""
    assert calls.calls, f"{what}: no 'hull' SFC update recorded"
    recs = []
    for call in calls.calls:
        a, k = sfc_update_args(call)
        got = call[2]
        assert a[2].device.type == "cuda", what
        if radius is not None:
            k = {**k, "max_radius_cells": radius}
            got = sfc.update_sfc(*a, **k)
        again = sfc.update_sfc(*a, **k)
        lanes = sfc.last_lanes
        want = sfc.update_sfc(*a, **{**k, "plain": True})
        n_diff = (sum(differing(g, w) + differing(r, g) for g, r, w in zip(got, again, want))
                  + sum(differing(g, w) for g, w in zip(lanes, sfc.last_lanes)))
        live = sfc.lane_trips(*sfc.last_lanes)
        recs.append({"agents": a[2].shape[0], "lanes": len(live),
                     "per_agent_images": a[0].blocked_cumsum.dim() == 4,
                     "radius": k.get("max_radius_cells", 0), "seed_free": int(lanes[4].sum()),
                     "longest_lane_trips": int(live.max()) if len(live) else 0,
                     "elements": sum(t.numel() for t in (*want, *lanes)),
                     "elements_differing": n_diff,
                     "max_abs_err": max(max_err(g, w) for g, w in zip(got, want))})
    print(f"{what} sfc_hull_check", json.dumps(recs))
    assert all(r["elements_differing"] == 0 for r in recs), (what, recs)
    builds.note_sfc_hull_check(recs)
    return recs


def sfc_check(sfc, builds, calls, what, radius=None):
    """The SFC expansion kernel against the plain loop on the card, on the
    lanes of the recorded expand_box calls of a path ('point' and
    'substep' modes; `radius` replaces their clamp): the path's own
    result (the kernel's), one more launch of the kernel and the plain
    loop (plain=True) on the same inputs give equal boxes and seed-free
    flags, lane for lane. Returns the per-call records."""
    assert calls.calls, f"{what}: no SFC call recorded"
    recs = []
    for a, k, got, _ in calls.calls:
        assert not k.get("plain"), what
        if radius is not None:
            k = {**k, "max_radius_cells": radius}
            got = sfc.expand_box(*a, **k)
        again = sfc.expand_box(*a, **k)
        want = sfc.expand_box(*a, **{**k, "plain": True})
        assert got[0].device.type == "cuda", what
        differ = torch.zeros(len(want[2]), dtype=torch.bool, device=want[2].device)
        err = 0
        for x, y, z in zip(got, again, want):
            x, y, z = (t.long().view(len(differ), -1) for t in (x, y, z))
            d = (x - z).abs().amax(1)
            differ |= (d > 0) | (y != z).any(1)
            err = max(err, int(d.max()))
        live = sfc.lane_trips(a[1], a[2], *want)
        recs.append({"lanes": len(differ), "per_agent_images": k.get("agent") is not None,
                     "radius": k.get("max_radius_cells", 0), "seed_free": int(want[2].sum()),
                     "longest_lane_trips": int(live.max()), "lanes_differing": int(differ.sum()),
                     "max_abs_err": err})
    print(f"{what} sfc_check", json.dumps(recs))
    assert all(r["lanes_differing"] == 0 for r in recs), (what, recs)
    builds.note_sfc_check(recs)
    return recs


def stage_split(fn, counters, dev, reps=20):
    """One call of a stage's function fn() under torch.profiler (device
    kernels and copies, device-busy ms, host launch calls), the launches
    it added to each wrapper counter (`counters`: name -> fn() -> count),
    and its ms by CUDA events over `reps` calls."""
    from lsc_dr_planner_tpu_torch.tools import sfc_bench

    fn()
    torch.cuda.synchronize()
    before = {n: c() for n, c in counters.items()}
    prof = sfc_bench.launch_counts(fn, dev)
    res = {key: prof[key] for key in ("device_kernels", "device_copies", "device_busy_ms",
                                      "host_launch_calls")}
    res["wrapper_launches"] = {n: c() - before[n] for n, c in counters.items()}
    res["ms"] = cuda_ms(fn, reps)
    return res


def main_path_state(workload, dev, **overrides):
    """The planner and state of `build_fleet(A_MAIN, **overrides)` after
    WARMUP evolving steps."""
    p, planner, fleet, inp = workload.build_fleet(A_MAIN, device=dev, **overrides)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(WARMUP):
        inp, _ = step(inp)
    return planner, fleet, inp


def clsc_split(workload, dev, gpu, reps=20):
    """The main path's CLSC stage on the inputs of the step after WARMUP
    evolving steps at A=1024, by `stage_split`: build_clsc, and its plain
    body."""
    from lsc_dr_planner_tpu_torch.ops import hull_cuda, lsc

    planner, fleet, inp = main_path_state(workload, dev)
    with Calls(lsc, "build_clsc") as c:
        planner._step_impl(fleet, inp)
    a, k = c.calls[0][:2]
    counters = {"hull_closest": lambda: hull_cuda.launches,
                "clsc_build": lambda: hull_cuda.clsc_launches}
    res = {"gpu": gpu,
           "build_clsc": stage_split(lambda: lsc.build_clsc(*a, **k), counters, dev, reps),
           "plain_body": stage_split(lambda: lsc.build_clsc(*a, **k, plain=True), counters,
                                     dev, reps)}
    print("clsc split", json.dumps(res), f"[{gpu}]")
    return res


def sfc_split(workload, dev, gpu, reps=20):
    """The main path's SFC stage ('hull' mode, sfc.update_sfc: the boxes
    and their world boxes) on the inputs of the step after WARMUP
    evolving steps at A=1024, by `stage_split`, and its plain body."""
    from lsc_dr_planner_tpu_torch.ops import sfc, sfc_cuda

    planner, fleet, inp = main_path_state(workload, dev)
    with Calls(sfc, "update_sfc", accept=hull_mode) as c:
        planner._step_impl(fleet, inp)
    a, k = sfc_update_args(c.calls[0])
    counters = {"sfc_update_hull": lambda: sfc_cuda.hull_launches,
                "sfc_expand": lambda: sfc_cuda.launches}
    res = {"agents": a[2].shape[0], "gpu": gpu,
           "update_sfc": stage_split(lambda: sfc.update_sfc(*a, **k), counters, dev, reps),
           "plain_body": stage_split(lambda: sfc.update_sfc(*a, **k, plain=True), counters,
                                     dev, 2)}
    print("sfc split", json.dumps(res), f"[{gpu}]")
    return res


def prepare_check(qp, qp_prepare_cuda, builds, calls, what):
    """The QP preparation kernel against the plain body on the card, on the
    recorded qp.prepare calls of a path (`qp_check.prepare_agreement`): the
    path's own Prepared (the kernel's) against the plain body
    (plain=True) on the same inputs: l, u, ρ, scale, tvec, qflat and the
    copies (y, normals) equal, element for element; each sum within its
    tolerance (`qp_check.prepare_tolerances`: L·2⁻²³·Σ|terms|, L the sum's
    chain of float32 roundings); per agent, the largest relative distance
    of Kinv from the float64 inverse of the kernel's own KKT matrix (one
    more launch, which writes it) at most twice the plain body's float32
    Kinv's from the inverse of its own, or 1e-5; one more
    launch equal to the path's in every output; every info 0. Returns the
    per-call records."""
    from lsc_dr_planner_tpu_torch.ops import qp_check

    assert calls.calls, f"{what}: no QP preparation recorded"
    recs = []
    for a, k, got, _ in calls.calls:
        cfg, inp = a[0], a[1]
        assert not (a[2:] and a[2]) and not k.get("plain") and inp.p0.device.type == "cuda", what
        dev = inp.p0.device
        ts = qp.torch_statics(cfg, dev)
        A, dk = inp.p0.shape[0], cfg.dim * ts["K"]
        want = qp.prepare(cfg, inp, plain=True)
        rec = qp_check.prepare_agreement(cfg, inp, got, want)
        kmat = torch.empty(A, dk, dk, dtype=torch.float64, device=dev)
        again = qp_prepare_cuda.prepare_cuda(cfg, ts, inp, qp.prepare_scalars(cfg), kmat=kmat)
        d_k = qp_check.kinv_distance(again["Kinv"], kmat)
        d_p = qp_check.kinv_distance(want.loop.Kinv, qp.kkt_matrix(cfg, inp)[0])
        fields = (*qp_check.EQUAL_FIELDS, *qp_check.SUM_FIELDS)
        fld = qp_check.field
        errs = [max_err(*(torch.where(fld(want, n).abs() < 1e19, fld(p, n), 0.0)
                          for p in (got, want))) for n in fields]
        rec.update(agents=A, dim=cfg.dim, dk=dk, O=cfg.n_obs, R=got.l.shape[1],
                   build=qp_prepare_cuda.build_name(cfg.dim, cfg.n_obs, cfg.M, cfg.N, ts["K"]),
                   y0=inp.y0 is not None,
                   elements=sum(fld(want, n).numel() for n in fields) + A * dk * dk,
                   again_differing=sum(differing(again[n], fld(got, n))
                                       for n in qp_prepare_cuda.OUTPUTS),
                   info_nonzero=int((got.info != 0).sum()) + int((want.info != 0).sum()),
                   kinv_dist_max=float(d_k.max()), kinv_dist_plain_max=float(d_p.max()),
                   kinv_dist_plain_p50=float(d_p.median()),
                   kinv_ratio_max=float((d_k / torch.clamp(2 * d_p, min=1e-5)).max()),
                   max_abs_err=max(errs))
        recs.append(rec)
    print(f"{what} prepare_check", json.dumps(recs))
    for r in recs:
        assert all(n == 0 for n in r["differing"].values()), (what, r)
        assert all(n == 0 for n in r["vacuous_differing"].values()), (what, r)
        assert all(x <= 1.0 for x in r["share_of_tolerance"].values()), (what, r)
        assert r["kinv_ratio_max"] <= 1.0 and r["info_nonzero"] == 0, (what, r)
        assert r["again_differing"] == 0, (what, r)
    builds.note_prepare_check(recs)
    return recs


def prepare_bound(qp, cfg, inp):
    """The least time of the QP preparation of `inp` on an H100 SXM: the
    larger of its bytes at 3.35 TB/s (each input read once, y0 where
    given, the statics once for the fleet; each output written once) and
    its least operations at FP32_OPS_PER_S, the function's type: per
    agent the inverse of an SPD matrix of order dk (the factor, the
    triangular inverse and the product: dk³ flops, as LAPACK's potrf,
    trtri and lauum count them), the KKT assembly (a multiply-add per
    segment per lower entry, the diagonal block's M + 3 terms), the sums
    (xpart, b_off, qn with the block diagonal P_base·xpart, xi0, z0 as
    qp._fwd forms it, Pn, the LSC Gram) at a multiply-add each term, and
    a few
    operations a row (bounds, offsets, scale)."""
    ts = qp.torch_statics(cfg, inp.p0.device)
    A, dim, O, M, N, K = inp.p0.shape[0], cfg.dim, cfg.n_obs, cfg.M, cfg.N, ts["K"]
    MN, dk = M * N, dim * K
    R_stat = ts["stencil"]["idx"].shape[0]
    R_lsc = O * MN
    R = R_lsc + R_stat
    in_bytes = A * (4 * (6 * dim + M + O * M * dim + R_lsc + 3 * dim * MN + 1
                         + (R if inp.y0 is not None else 0)) + R_lsc)
    statics = list(ts["prep"].values())
    statics += [ts["stencil"]["idx"], ts["stencil"]["coef"]]
    static_bytes = sum(t.numel() * t.element_size() for t in statics)
    out_bytes = A * 4 * (O * M * dim + dk * dk + K * K + 2 * dk + 9 * R + 2 * dim * MN + MN + 1)
    bytes_ = in_bytes + static_bytes + out_bytes
    per_agent = (dk ** 3  # the SPD inverse
                 + 2 * M * dk * (dk + 1) // 2 + dim * K * K * 2 * (M + 3)  # KKT assembly
                 + 2 * (3 * dim * MN + dim * MN * N + 2 * dk * MN + K * K * M  # sums
                        + O * M * dim * dim + R_lsc * dim + R_lsc * K * (dim + 1) + R_stat * K)
                 + 3 * dk * MN + 2 * dim * MN + 6 * R)  # differences, rows
    ops = A * per_agent
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bytes_ms = bytes_ / 3.35e12 * 1e3
    return {"A": A, "dk": dk, "R": R, "bytes": bytes_, "ops": ops, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def prepare_timing(qp, qp_prepare_cuda, calls, gpu, what):
    """The QP preparation kernel on the first recorded qp.prepare call of a
    path (`prepare_kernel_record`) and the host's time to issue it:
    prepare_cuda's and qp.prepare's (`host_ms`)."""
    cfg, inp = calls.calls[0][0][:2]
    rec = prepare_kernel_record(qp, qp_prepare_cuda, cfg, inp)
    ts, sc = qp.torch_statics(cfg, inp.p0.device), qp.prepare_scalars(cfg)
    rec["host_ms"] = host_ms(lambda: qp_prepare_cuda.prepare_cuda(cfg, ts, inp, sc), KERNEL_REPS)
    rec["prepare_host_ms"] = host_ms(lambda: qp.prepare(cfg, inp), KERNEL_REPS)
    print(f"{what} prepare timing", json.dumps(rec), f"[{gpu}]")
    return rec


def prepare_kernel_record(qp, qp_prepare_cuda, cfg, inp, library=True):
    """The QP preparation kernel on `inp`: its own device ms a launch and a
    call's ms queued back to back (`kernel_times`), the plain body's ms on
    the card (plain=True), the library call beside it
    (`torch.cholesky_inverse` of
    `torch.linalg.cholesky_ex` on the plain body's KKT matrix in float64:
    the inverse alone, in the kernel's precision, which the port never
    calls; and in float32; not with `library` False), the bound of this
    call's work (`prepare_bound`), the kernel's shared memory and
    resident agents per SM."""
    dev = inp.p0.device
    ts, sc = qp.torch_statics(cfg, dev), qp.prepare_scalars(cfg)

    def launch():
        return qp_prepare_cuda.prepare_cuda(cfg, ts, inp, sc)

    lib = qp_prepare_cuda.build()
    shape = (cfg.dim, cfg.n_obs, cfg.M, cfg.N, ts["K"])
    rec = {"dim": cfg.dim, "O": cfg.n_obs, **kernel_times(launch, dev, "qp_prepare_kernel"),
           "smem_bytes": lib.qp_prepare_smem_bytes(*shape),
           "blocks_per_sm": lib.qp_prepare_blocks_per_sm(*shape), **prepare_bound(qp, cfg, inp)}
    if library:
        kmat32 = qp.kkt_matrix(cfg, inp)[0]
        kmat = kmat32.double()
        rec.update(
            plain_ms=cuda_ms(lambda: qp.prepare(cfg, inp, plain=True), 5),
            library_ms=queued_ms(
                lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(kmat).L), 20),
            library_ms_float32=queued_ms(
                lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(kmat32).L), 20))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


@contextlib.contextmanager
def built_from(wrapper, src):
    """For the duration, the kernel library of `wrapper` (qp_cuda,
    qp_prepare_cuda, ...) built from the source file `src` in its place;
    yields ptxas's registers and spills of its build (the build log is
    keyed by file name: give each source its own). The shipped source is
    restored afterwards."""
    from lsc_dr_planner_tpu_torch.ops import cuda_build

    shipped = wrapper.SOURCE
    wrapper.SOURCE, wrapper._lib = Path(src).resolve(), None
    try:
        wrapper.build(verbose=True)
        yield ptxas_summary(cuda_build.build_log.get(Path(src).name, (0, ""))[1])
    finally:
        wrapper.SOURCE, wrapper._lib = shipped, None


def prepare_sources_main(sources):
    """The QP preparation kernel built from each of `sources`
    (qp_prepare.cu files of one PrepArgs layout: an older tree's, this
    tree's, variants), in the order given (for an A/B: parent, change,
    change, parent), on the same batches: the main path's QP (2-D,
    A=1024, after WARMUP evolving steps), 8b's (3-D) and the main path's
    eight times over (A=8,192, mc_pod_bench's batch). Per source its
    ptxas registers and spills, and per batch `prepare_kernel_record`
    (no library call) and its agreement with the plain body
    (`qp_check.prepare_agreement`: elements differing, largest share of
    tolerance; Kinv's distance from the float64 inverse of the source's
    own KKT matrix over twice the plain body's, `kinv_ratio_max`; info
    nonzero); Kinv's entries that differ from the first source's and
    from the float32 rounding of `torch.linalg.inv` of the KKT matrix in
    float64. One JSON line a source; returns the records."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.ops import (hull_cuda, qp, qp_check, qp_cuda, qp_prepare_cuda,
                                              sfc_cuda)

    dev, gpu = torch.device("cuda", 0), gpu_line()
    wrappers = (qp_cuda, sfc_cuda, hull_cuda, qp_prepare_cuda)
    with ThreadPoolExecutor(len(wrappers)) as pool:
        for done in [pool.submit(w.build) for w in wrappers]:
            done.result()
    batches = {}
    for tag, overrides in (("2d", {}), ("3d", dict(world_dimension=3))):
        planner, fleet, inp = main_path_state(workload, dev, **overrides)
        batches[tag] = (planner.qp_cfg,
                        planner._step_impl(fleet, inp, defer_qp=True).qp_inp)
    cfg, inp = batches["2d"]
    batches["A8192"] = (cfg, qp.QPInputs(**{
        f.name: None if getattr(inp, f.name) is None else getattr(inp, f.name).repeat(
            P14_MC_S, *[1] * (getattr(inp, f.name).dim() - 1))
        for f in dataclasses.fields(inp)}))
    plain = {}
    for tag, (cfg, inp) in batches.items():
        want = qp.prepare(cfg, inp, plain=True)
        plain[tag] = want, qp_check.kinv_distance(want.loop.Kinv, qp.kkt_matrix(cfg, inp)[0])
    torch.cuda.synchronize()
    recs, first_kinv = [], {}
    for src in sources:
        with built_from(qp_prepare_cuda, src) as ptxas:
            rec = {"source": str(src), "gpu": gpu, "ptxas": ptxas}
            for tag, (cfg, inp) in batches.items():
                ts = qp.torch_statics(cfg, dev)
                A, dk = inp.p0.shape[0], cfg.dim * ts["K"]
                kmat = torch.empty(A, dk, dk, dtype=torch.float64, device=dev)
                out = qp_prepare_cuda.prepare_cuda(cfg, ts, inp, qp.prepare_scalars(cfg),
                                                   kmat=kmat)
                got = qp.prepare(cfg, inp)
                want, d_p = plain[tag]
                agree = qp_check.prepare_agreement(cfg, inp, got, want)
                d_k = qp_check.kinv_distance(out["Kinv"], kmat)
                first = first_kinv.setdefault(tag, out["Kinv"])
                rec[tag] = {
                    **prepare_kernel_record(qp, qp_prepare_cuda, cfg, inp, library=False),
                    "differing": sum(agree["differing"].values())
                    + sum(agree["vacuous_differing"].values()),
                    "max_share_of_tolerance": max(agree["share_of_tolerance"].values()),
                    "kinv_ratio_max": float((d_k / torch.clamp(2 * d_p, min=1e-5)).max()),
                    "kinv_dist_max": float(d_k.max()),
                    "kinv_symmetric": bool(torch.equal(out["Kinv"], out["Kinv"].transpose(1, 2))),
                    "info_nonzero": int((out["info"] != 0).sum()),
                    "kinv_entries": out["Kinv"].numel(),
                    "kinv_differing_from_first": differing(out["Kinv"], first),
                    "kinv_differing_from_f64_inverse": differing(
                        out["Kinv"], torch.linalg.inv(kmat).float())}
        print("prepare source", json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


SYNC_WORDS = "synchroniz"  # in the warning of torch.cuda.set_sync_debug_mode("warn")
SYNC_COUNT_REPS = 2  # qp_split's steps that count host syncs


def qp_split(workload, dev, gpu, overrides=None, reps=10, count_reps=SYNC_COUNT_REPS):
    """The QP stage of the main path's step (or of its layout with
    `overrides`) on the state after WARMUP evolving steps at A=1024, from
    the goal stage's end (`_mark("goal")`, planner/pipeline.py) to qp.solve's
    return: CUDA events at the goal stage's end, at qp.solve's entry and
    at the returns of qp.prepare, the main run_loop, rescue_batch, the
    rescue run_loop and qp.solve split it on the device's timeline into
    the QP-input assembly, prepare, the main loop, rescue_batch, the
    rescue loop and the scatter and finish (mean ms over `reps` steps on
    the same state, after one, with no sync debug mode); the host
    synchronisations in that span, per step, in `count_reps` further
    steps (torch.cuda.set_sync_debug_mode("warn"), the warnings counted:
    each costs a Python warning, so these steps are not timed); qp.solve and qp.prepare under the profiler (device kernels,
    copies, host launch calls, wrapper launches); and whether qp.solve
    runs under set_sync_debug_mode("error"). It runs on older checkouts
    (the parent's) as `clsc_split` does: it wraps functions by name."""
    import warnings

    from lsc_dr_planner_tpu_torch.ops import qp, qp_cuda

    try:
        from lsc_dr_planner_tpu_torch.ops import qp_prepare_cuda
    except ImportError:  # a tree without the preparation kernel
        qp_prepare_cuda = None
    overrides = overrides or {}
    planner, fleet, inp = main_path_state(workload, dev, **overrides)
    marks, counting, caught = [], [False], {"now": []}  # the warnings of the running step

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, sum(SYNC_WORDS in str(w.message) for w in caught["now"])))

    def wrap(name, orig):
        def f(*a, **k):
            if name == "solve":
                mark("solve_entry")
            out = orig(*a, **k)
            mark(name)
            if name == "solve" and counting[0]:
                torch.cuda.set_sync_debug_mode(0)
            return out
        return f

    names = ("solve", "prepare", "run_loop", "rescue_batch")
    origs = {n: getattr(qp, n) for n in names}
    planner_mark = planner._mark

    def goal_mark(name):
        planner_mark(name)
        if name == "goal":
            mark("goal")
            if counting[0]:
                torch.cuda.set_sync_debug_mode("warn")

    rows, syncs, by_part = [], [], []
    with Calls(qp, "solve", keep=1) as solves:
        planner._step_impl(fleet, inp)  # warm-up, and the QP's inputs
    planner._mark = goal_mark
    try:
        for n in names:
            setattr(qp, n, wrap(n, origs[n]))
        for rep in range(1 + reps + count_reps):
            marks.clear()
            counting[0] = rep > reps
            with warnings.catch_warnings(record=True) as caught["now"]:
                warnings.simplefilter("always")
                planner._step_impl(fleet, inp)
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            if counting[0]:
                syncs.append(sum(SYNC_WORDS in str(w.message) for w in caught["now"]))
                by_part.append([c2 - c1 for (_, _, c1), (_, _, c2) in zip(marks, marks[1:])])
            elif rep > 0:
                rows.append([(f"{n1}->{n2}", e1.elapsed_time(e2))
                             for (n1, e1, _), (n2, e2, _) in zip(marks, marks[1:])])
    finally:
        for n in names:
            setattr(qp, n, origs[n])
        del planner._mark
    labels = {"goal->solve_entry": "assembly", "solve_entry->prepare": "prepare",
              "prepare->run_loop": "main_loop", "run_loop->rescue_batch": "rescue_batch",
              "rescue_batch->run_loop": "rescue_loop", "run_loop->solve": "finish"}
    split = {labels.get(k, k): float(np.mean([r[i][1] for r in rows]))
             for i, (k, _) in enumerate(rows[0])}
    split["stage"] = float(np.mean([sum(ms for _, ms in r) for r in rows]))
    syncs_by_part = {labels.get(k, k): by_part[-1][i] for i, (k, _) in enumerate(rows[0])}
    a, k = solves.calls[0][:2]
    cfg, qp_inp = a[0], a[1]
    counters = {"admm": lambda: qp_cuda.launches}
    if qp_prepare_cuda is not None:
        counters["qp_prepare"] = lambda: qp_prepare_cuda.launches
    res = {"overrides": {x: getattr(v, "name", v) for x, v in overrides.items()},
           "A": qp_inp.p0.shape[0], "ms": split, "host_syncs_per_step": syncs,
           "host_syncs_by_part": syncs_by_part,
           "solve": stage_split(lambda: qp.solve(*a, **k), counters, dev, 5),
           "prepare": stage_split(lambda: qp.prepare(cfg, qp_inp), counters, dev, 20),
           "prepare_host_ms": host_ms(lambda: qp.prepare(cfg, qp_inp), 20),
           "gpu": gpu}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        qp.solve(*a, **k)
        res["solve_under_sync_error_mode"] = "ok"
    except RuntimeError as e:
        res["solve_under_sync_error_mode"] = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("qp split", json.dumps(res), f"[{gpu}]")
    return res


def qp_ab_main():
    """For the checkout whose package is imported (an older one, the
    parent's, as `sfc_probe_main` does): its kernels built, then in the
    main path's layout and in 8b's (3-D) WARMUP and TIMED evolving steps
    (step p50, mean stage ms, QP convergence) and `qp_split`; one JSON
    line."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.ops import hull_cuda, qp_cuda, sfc_cuda

    dev, gpu = torch.device("cuda", 0), gpu_line()
    wrappers = [qp_cuda, sfc_cuda, hull_cuda]
    try:
        from lsc_dr_planner_tpu_torch.ops import qp_prepare_cuda
        wrappers.append(qp_prepare_cuda)
    except ImportError:
        pass
    with ThreadPoolExecutor(len(wrappers)) as pool:
        for done in [pool.submit(w.build) for w in wrappers]:
            done.result()
    rec = {"package": str(Path(qp_cuda.__file__).resolve().parents[1]), "gpu": gpu}
    for tag, overrides in (("main", {}), ("8b", dict(world_dimension=3))):
        p, planner, fleet, inp = workload.build_fleet(A_MAIN, device=dev, timing=True,
                                                      **overrides)
        step = workload.make_evolve_step(p, planner, fleet)
        for _ in range(WARMUP):
            inp, _ = step(inp)
        inp, lat, stages, convs = admm_timing.timed_steps(step, planner, inp, TIMED)
        rec[tag] = {"p50_ms": float(np.percentile(lat, 50) * 1e3),
                    "stage_ms": admm_timing.mean_stages(stages),
                    "qp_convergence": float(np.mean(convs)),
                    "qp_split": qp_split(workload, dev, gpu, overrides)}
    print("qp ab", json.dumps(rec))
    return rec


def admm_sums_main(sources, seeds=MOVED_SEEDS):
    """The ADMM loop kernel built from each of `sources` (admm.cu files:
    this tree's, an older tree's, a variant of its sums) on the same
    batches, reached once by this tree's kernels: phase 8e's DLSC 3-D
    state (A=1024) as it is and moved by MOVE_M m (`moved_states`, one
    state a seed of `seeds`) under loop_check's float64 clause and
    `qp_check.whole_run_f64`; the QP of the 4th step of
    forest_mission(10) (tests/test_torch_cuda.py's `sim_qp`) under
    whole_run_f64 and the element-wise share of the whole run against
    the float32 plain loop (the clause it replaced); the loop timed
    (`admm_timing.timed_call`) on the main path's batch (2-D, A=1024),
    its compacted rescue and 8b's (3-D); the QPs of TIMED evolving steps
    of the main path and of 8b (as `qp.solve` got them, steps of this
    tree's kernels) solved again: each solve's rescue exit, the sum of
    the exits, mean solve ms (CUDA events) and convergence; ptxas's
    registers and spills. One JSON line a source."""
    import tempfile

    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.config import Param, PlannerMode
    from lsc_dr_planner_tpu_torch.ops import (hull_cuda, qp, qp_check, qp_cuda, qp_prepare_cuda,
                                              sfc_cuda)
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

    dev, gpu = torch.device("cuda", 0), gpu_line()
    wrappers = (qp_cuda, sfc_cuda, hull_cuda, qp_prepare_cuda)
    with ThreadPoolExecutor(len(wrappers)) as pool:
        for done in [pool.submit(w.build, True) for w in wrappers]:
            done.result()
    batches = {}
    for tag, overrides in (("2d", {}), ("3d", dict(world_dimension=3)),
                           ("8e", dict(world_dimension=3, planner_mode=PlannerMode.DLSC))):
        p, planner, fleet, inp = workload.build_fleet(A_MAIN, device=dev, **overrides)
        step = workload.make_evolve_step(p, planner, fleet)
        for _ in range(WARMUP):
            inp, _ = step(inp)
        cfg, feas_tol = planner.qp_cfg, planner.feas_tol
        states = moved_states(planner, fleet, inp, seeds if tag == "8e" else ())
        batches[tag] = (cfg, feas_tol, [(name, qp.prepare(cfg, qi).loop)
                                        for name, _, qi in states])
    cfg, feas_tol, ((_, li),) = batches["2d"]
    xi, z, y = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)[:3]
    batches["rescue"] = (cfg, feas_tol, [("rescue", qp.rescue_batch(cfg, li, xi, z, y,
                                                                    feas_tol)[2])])
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as log_dir:
        sim = MultiSyncSimulator(Param(multisim_save_result=False), workload.forest_mission(10),
                                 log_dir=log_dir, device="cuda")
        for it in range(3):
            if it:
                sim.do_step()
            sim.decentralized_mapp()
            assert sim.plan()
        sim.do_step()
        sim.decentralized_mapp()
        qi = sim.planner._step_impl(sim.fleet, sim._build_step_inputs(), defer_qp=True).qp_inp
        batches["simqp"] = (sim.planner.qp_cfg, sim.planner.feas_tol,
                            [("simqp", qp.prepare(sim.planner.qp_cfg, qi).loop)])
    solves = {}
    for tag, overrides in (("2d", {}), ("3d", dict(world_dimension=3))):
        p, planner, fleet, inp = workload.build_fleet(A_MAIN, device=dev, **overrides)
        step = workload.make_evolve_step(p, planner, fleet)
        for _ in range(WARMUP):
            inp, _ = step(inp)
        with Calls(qp, "solve", keep=TIMED) as calls:
            for _ in range(TIMED):
                inp, _ = step(inp)
        solves[tag] = [(a, k) for a, k, _, _ in calls.calls]
    torch.cuda.synchronize()
    for src in sources:
        with built_from(qp_cuda, src) as ptxas:
            rec = {"source": str(src), "gpu": gpu, "ptxas": ptxas}
            cfg, feas_tol, states = batches["8e"]
            rec["8e"] = []
            for name, li in states:
                r = loop_check(qp, cfg, li, feas_tol, f"sums {Path(src).name} 8e {name}",
                               float64_clause=True, strict=False)
                rec["8e"].append({"state": name,
                                  "chunk_ratio_to_envelope": r["chunk_ratio_to_envelope"],
                                  "chunk_agents_failed": r["chunk_agents_failed"],
                                  "whole_run_f64": r["whole_run_f64"],
                                  "failures": r["failures"]})
            cfg, feas_tol, ((_, li),) = batches["simqp"]
            got = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)
            want = qp.admm_loop_plain(cfg, li, int(got[4]), 0.0)
            rec["simqp"] = {"whole_run_f64": qp_check.whole_run_f64(cfg, li, got),
                            "elementwise_share_vs_float32_plain": max(
                                shares(a, b)[0] for a, b in zip(got[:3], want[:3]))}
            rec["timing"] = {}
            for tag in ("2d", "rescue", "3d"):
                cfg, feas_tol, ((_, li),) = batches[tag]
                iters = cfg.rescue_iter if tag == "rescue" else cfg.max_iter
                rec["timing"][tag] = admm_timing.timed_call(qp, cfg, li, iters, feas_tol,
                                                            tag, 10)
            rec["steps"] = {}
            for tag, calls in solves.items():
                with Calls(qp, "run_loop", keep=len(calls),
                           accept=lambda a, k: a[2] != a[0].max_iter) as rescues:
                    conv = [float(qp.solve(*a, **k).converged.float().mean()) for a, k in calls]
                ms = [cuda_ms(lambda: qp.solve(*a, **k), 2) for a, k in calls]
                exits = [int(out[4]) for _, _, out, _ in rescues.calls]
                rec["steps"][tag] = {"rescue_exits": exits, "rescue_iters": sum(exits),
                                     "solve_ms": sum(ms) / len(ms),
                                     "qp_convergence": sum(conv) / len(conv)}
        print("admm sums", json.dumps(rec), f"[{gpu}]", flush=True)


def build_sources_main(sources, tags, reps=5):
    """The ADMM loop kernel built from each of `sources` (admm.cu files of
    one Args layout: this tree's, an older tree's, variants of it), in the
    order given, on the batches of `tags` ("8b", "8e" and the tags of
    `triple_ab_cases` for the triple build, "8f" and "8h" for the shapes
    past the register builds): each main loop (A=1024 or the case's
    agents, max_iter iterations, after WARMUP evolving steps) and its
    compacted rescue (A = RESCUE,
    rescue_iter iterations, from the main loop's iterate of the shipped
    build). Per source and batch: the build that took it and the
    wrapper's launch record, one chunk's largest |kernel − plain| and
    per-agent share of the tolerance, and the loop timed
    (`admm_timing.timed_call`); ptxas's registers and spills. One JSON
    line a source."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.config import PlannerMode
    from lsc_dr_planner_tpu_torch.ops import qp, qp_cuda

    dev, gpu = torch.device("cuda", 0), gpu_line()
    build_all()
    cases = {"8b": (dict(world_dimension=3), A_MAIN),
             "8e": (dict(world_dimension=3, planner_mode=PlannerMode.DLSC), A_MAIN),
             "8f": (P8F, A_MAIN), "8h": (P8H, A_MAIN)}
    cases.update({tag: (over, A) for tag, over, A in triple_ab_cases()})
    batches = []
    for tag in tags:
        over, A = cases[tag]
        p, planner, fleet, inp = workload.build_fleet(A, device=dev, **over)
        step = workload.make_evolve_step(p, planner, fleet)
        for _ in range(WARMUP):
            inp, _ = step(inp)
        cfg, tol = planner.qp_cfg, planner.feas_tol
        li = qp.prepare(cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp).loop
        xi, z, y = qp.run_loop(cfg, li, cfg.max_iter, tol)[:3]
        sub = qp.rescue_batch(cfg, li, xi, z, y, tol)[2]
        batches += [(tag, cfg, tol, li, cfg.max_iter),
                    (tag + " rescue", cfg, tol, sub, cfg.rescue_iter)]
    torch.cuda.synchronize()
    out = []
    for src in sources:
        with built_from(qp_cuda, src) as ptxas:
            rec = {"source": str(src), "gpu": gpu, "ptxas": ptxas, "batches": {}}
            for tag, cfg, tol, li, iters in batches:
                got = qp.run_loop(cfg, li, 8, tol)
                want = qp.admm_loop_plain(cfg, li, 8, tol)
                r = admm_timing.timed_call(qp, cfg, li, iters, tol, tag, reps)
                r.update(build=qp_cuda.build_name(qp_cuda.build(), *admm_shape(qp, cfg, dev),
                                                  li.xi.shape[0]),
                         chunk_max_abs_err=max((a - b).abs().max().item()
                                               for a, b in zip(got[:3], want[:3])),
                         chunk_share=max(shares(a, b)[1] for a, b in zip(got[:3], want[:3])))
                r.update(getattr(qp_cuda, "last_launch", {}))
                rec["batches"][tag] = r
        print("build sources", json.dumps(rec), f"[{gpu}]", flush=True)
        out.append(rec)
    return out


def rounding_check(dev, n=1 << 20, seed=0):
    """The rounding the plain versions pin is the same on `dev` as on the
    CPU, bit for bit, on n random float32 inputs (normal): the 3-term
    sums, cross products and square roots of the hull query and of
    build_clsc's projections (geometry.py::_dot3, _cross, the float64
    sqrt), build_clsc's segment construction
    (geometry.closest_between_segments), and the SFC seeds
    (world/grid.py's point_to_lattice_*: p / res a true division) with
    the world boxes (sfc_to_world): what lets the CPU's twins and plain
    versions stand for the card's. Also counts the values where the ops
    the pinning replaces (torch.sum of the products, torch.linalg.cross,
    the float32 sqrt, torch.einsum's projection, torch.linalg.vector_norm,
    p divided by a Python float) differ on `dev` from the pinned ones."""
    from lsc_dr_planner_tpu_torch.ops import geometry, sfc
    from lsc_dr_planner_tpu_torch.world import grid

    g = torch.Generator().manual_seed(seed)
    a, b, c, d = (torch.randn(n, 3, generator=g) for _ in range(4))
    pts = 20.0 * torch.randn(n, 3, generator=g)
    boxes = torch.randint(-5, 110, (n, 3), generator=g, dtype=torch.int32)
    world = grid.build_grid_world(np.zeros((0, 6)), [-5.0, -5.0, 0.0], [5.0, 5.0, 3.0], 0.1,
                                  0.15, "cpu")

    def pinned(w, a, b, c, d, pts, boxes):
        return (geometry._dot3(a, b), geometry._cross(a, b),
                torch.sqrt(geometry._dot3(a, a).double()).float(),
                *geometry.closest_between_segments(a, b, c, d),
                w.point_to_lattice_floor(pts), w.point_to_lattice_ceil(pts),
                w.point_to_lattice_round(pts), *sfc.sfc_to_world(w, boxes, boxes + 7, 0.15))

    names = ("dot3", "cross", "sqrt", "segment_cp", "segment_cq", "segment_dist",
             "lattice_floor", "lattice_ceil", "lattice_round", "world_lo", "world_hi")
    cpu = pinned(world, a, b, c, d, pts, boxes)
    w_dev = grid.local_grid_world(world, world.blocked_cumsum.to(dev))
    a, b, c, d, pts, boxes = (t.to(dev) for t in (a, b, c, d, pts, boxes))
    card = pinned(w_dev, a, b, c, d, pts, boxes)
    for name, x, y in zip(names, card, cpu):
        assert torch.equal(x.cpu(), y), f"pinned {name} differs between {dev} and the CPU"
    # build_clsc's projection: [hulls, N, 3] points against [hulls, 3] normals
    rel, nrm = a.view(-1, 4, 3), b.view(-1, 4, 3)[:, 0]
    res = {"n": n, "device": str(dev), "pinned_equal_to_cpu": list(names),
           "sum_vs_dot3": int((torch.sum(a * b, dim=-1) != card[0]).sum()),
           "linalg_cross_vs_cross": int((torch.linalg.cross(a, b, dim=-1) != card[1]).sum()),
           "sqrt_vs_float64_sqrt": int((torch.sqrt(geometry._dot3(a, a)) != card[2]).sum()),
           "einsum_vs_dot3_projection": int((torch.einsum("hnd,hd->hn", rel, nrm)
                                             != geometry._dot3(rel, nrm[:, None])).sum()),
           "vector_norm_vs_float64_sqrt": int((torch.linalg.vector_norm(a, dim=-1)
                                               != card[2]).sum()),
           "scalar_division_vs_pinned_floor": int(
               (torch.floor(pts / 0.1 + 1e-6).to(torch.int32) - w_dev._origin_i
                != card[6]).sum()),
           "scalar_division_vs_pinned_round": int(
               (torch.round(pts / 0.1).to(torch.int32) - w_dev._origin_i != card[8]).sum())}
    print("rounding check", json.dumps(res))
    return res


# The SFC kernels' operations per live lane-trip: 12 bound tests, 12
# clamps of the 8-corner query, 24 index operations (x·SY + y)·SZ + z,
# the count's 7 additions and its test, 6 state updates
SFC_OPS_PER_TRIP = 62
FP32_OPS_PER_S = 67e12  # H100 SXM outside the tensor cores; its int32 rate is no higher
HBM_BYTES_PER_S = 3.35e12  # H100 SXM's device memory


# The hull query of build_clsc (ops/geometry.py::closest_point_origin_to_hull,
# the JAX package's :192-237; no Pallas original) does work that depends on
# its points. `hull_ops` counts the least of it on a run's hulls: the float
# additions, subtractions, multiplications, divisions and square roots of
# the plain enumeration's formulas, each distinct subexpression once (an
# edge's difference and its dot products with its end points, shared by the
# edge and its triangles; a cross product shared by tetrahedra), terms with
# a zero operand dropped, and only what the data asks for: the tetrahedra
# first, in order up to the first that holds the origin, each up to its
# first failing test (the volume, then the four signs); for a hull that
# holds no origin, the vertices' norms, each edge's point where its
# parameter is above 0, each triangle's tests in the plain version's
# precedence, each condition in order up to the first false, and the one
# point the tests pick, each candidate's squared norm, one square root.
# Comparisons, clamps, selects and sign flips count nothing. Bytes per hull
# of K points: its points read, its closest point and distance written.
DOT, CROSS, AXPY, DIFF = 5, 9, 6, 3
HULL_VOL_EPS = 1e-10


def hull_ops(x):
    """The least float operations of the hull query on the hulls of `x`
    ([..., K, 3] float32), summed over the hulls (see above): (all of them,
    those of the tetrahedra's tests, the hulls that hold the origin)."""
    from itertools import combinations

    from lsc_dr_planner_tpu_torch.ops import geometry as g

    p = x.reshape(-1, *x.shape[-2:])
    H, K = p.shape[:2]
    v = [p[:, i] for i in range(K)]
    E = {e: v[e[1]] - v[e[0]] for e in combinations(range(K), 2)}
    need = {}  # distinct subexpression -> (its operations, the hulls that need it)

    def use(key, ops, mask):
        need[key] = (ops, mask if key not in need else need[key][1] | mask)

    def total():
        return sum(ops * int(m.sum()) for ops, m in need.values())

    eps = HULL_VOL_EPS
    reach = torch.ones(H, dtype=torch.bool, device=p.device)  # no earlier tetrahedron holds 0
    for i, j, k, m in combinations(range(K), 4):
        for e in ((i, j), (i, k), (i, m)):
            use(("E", *e), DIFF, reach)
        C = g._cross(E[i, k], E[i, m])
        use(("C", i, k, m), CROSS, reach)
        use(("v0", i, j, k, m), DOT, reach)
        v0 = g._dot3(E[i, j], C)
        alive, pos = reach & (v0.abs() > eps), v0 > 0
        # signed_vol with a zero vertex: v1 = b·(c×d), v2 = −a·C, v3, v4
        for n, (cross_key, vol) in enumerate((
                (("X", k, m), lambda: g._dot3(v[j], g._cross(v[k], v[m]))),
                (None, lambda: g._dot3(-v[i], C)),
                (("Y", i, m), lambda: g._dot3(E[i, j], g._cross(-v[i], E[i, m]))),
                (("Z", i, k), lambda: g._dot3(E[i, j], g._cross(E[i, k], -v[i])))), 1):
            if cross_key:
                use(cross_key, CROSS, alive)
            use((f"v{n}", i, j, k, m), DOT, alive)
            s = vol()
            alive = alive & torch.where(pos, s >= -eps, s <= eps)
        reach = reach & ~alive
    tetra_ops = total()
    out = reach  # the hulls that hold no origin
    use(("N",), DOT * K, out)
    use(("sqrt",), 1, out)
    S = {}
    for i, j in combinations(range(K), 2):
        use(("E", i, j), DIFF, out)
        use(("G", i, j), DOT, out)
        use(("S", i, j), DOT, out)
        G = g._dot3(E[i, j], E[i, j])
        S[i, j] = g._dot3(-v[i], E[i, j])
        live = out & (G > g._EPS)
        use(("t", i, j), 1, live)
        t = S[i, j] / G.clamp(min=g._EPS)
        # the point a + t·ab and its norm: a's for t ≤ 0, a + ab for t ≥ 1
        use(("ep", i, j), AXPY + DOT, live & (t > 0) & (t < 1))
        use(("ep1", i, j), DIFF + DOT, live & (t >= 1))
    for i, j, k in combinations(range(K), 3):
        b, c, ab, ac = v[j], v[k], E[i, j], E[i, k]
        d = {"d1": S[i, j], "d2": S[i, k], "d3": g._dot3(ab, -b), "d4": g._dot3(ac, -b),
             "d5": g._dot3(ab, -c), "d6": g._dot3(ac, -c)}
        d["vc"] = d["d1"] * d["d4"] - d["d3"] * d["d2"]
        d["vb"] = d["d5"] * d["d2"] - d["d1"] * d["d6"]
        d["va"] = d["d3"] * d["d6"] - d["d5"] * d["d4"]
        d["d43"], d["d56"] = d["d4"] - d["d3"], d["d5"] - d["d6"]
        # (key, operations, what it needs); d1, d2 are the edges' S
        q = {"d1": (None, 0, ()), "d2": (None, 0, ()), "d3": (("T", i, j), DOT, ()),
             "d6": (("T", i, k), DOT, ()), "d4": (("D", i, j, k, 4), DOT, ()),
             "d5": (("D", i, j, k, 5), DOT, ()),
             "vc": (("V", i, j, k, "c"), 3, ("d1", "d4", "d3", "d2")),
             "vb": (("V", i, j, k, "b"), 3, ("d5", "d2", "d1", "d6")),
             "va": (("V", i, j, k, "a"), 3, ("d3", "d6", "d5", "d4")),
             "d43": (("V", i, j, k, 43), 1, ("d4", "d3")),
             "d56": (("V", i, j, k, 56), 1, ("d5", "d6"))}

        def needs(name, mask):
            key, ops, deps = q[name]
            if key:
                use(key, ops, mask)
            for dep in deps:
                needs(dep, mask)

        alive = out
        # the Voronoi tests in the plain version's precedence, the point each
        # picks (a vertex's norm is the vertex's), then the interior
        for region, conds, ops in (
                ("a", (("d1", d["d1"] <= 0), ("d2", d["d2"] <= 0)), 0),
                ("b", (("d3", d["d3"] >= 0), ("d4", d["d4"] <= d["d3"])), 0),
                ("c", (("d6", d["d6"] >= 0), ("d5", d["d5"] <= d["d6"])), 0),
                ("ab", (("vc", d["vc"] <= 0), ("d1", d["d1"] >= 0), ("d3", d["d3"] <= 0)),
                 2 + AXPY + DOT),
                ("ac", (("vb", d["vb"] <= 0), ("d2", d["d2"] >= 0), ("d6", d["d6"] <= 0)),
                 2 + AXPY + DOT),
                ("bc", (("va", d["va"] <= 0), ("d43", d["d43"] >= 0), ("d56", d["d56"] >= 0)),
                 2 + AXPY + DOT)):
            sel = alive
            for name, cond in conds:
                needs(name, sel)
                sel = sel & cond
            use(("P", i, j, k, region), ops, sel)
            alive = alive & ~sel
        for name in ("va", "vb", "vc"):
            needs(name, alive)
        use(("P", i, j, k, "in"), 4 + 2 * AXPY + DOT, alive)
    return total(), tetra_ops, int((~out).sum())


def hull_bound(x):
    """The least time of the hull query on the hulls of `x` ([..., K, 3])
    on an H100 SXM: the larger of its least operations (`hull_ops`) at
    FP32_OPS_PER_S and its bytes at 3.35 TB/s."""
    K = x.shape[-2]
    hulls = x[..., 0, 0].numel()
    ops, tetra_ops, inside = hull_ops(x)
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bytes_ms = hulls * (K * 3 * 4 + 4 * 4) / 3.35e12 * 1e3
    return {"hulls": hulls, "K": K, "ops": ops, "ops_per_hull": ops / hulls,
            "tetra_ops": tetra_ops, "candidate_ops": ops - tetra_ops, "hulls_inside": inside,
            "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def sfc_timing(sfc, lanes, l2_ns, gpu, what):
    """The SFC expansion kernel (sfc_expand) on the lanes `lanes` = (args,
    kwargs) of an expand_box call: its own device ms a launch and a
    call's ms queued back to back (`kernel_times`, on
    `sfc.expand_box_kernel`, the launch without expand_box's trip
    count), the plain loop's ms on the card on the same lanes,
    and the bounds of this call's work: the bytes
    (`sfc_bench.bound_bytes`: each lane's 8-corner seed query, at most 4
    new corners per live lane-trip, each lane's seed, order and result
    once, at 3.35 TB/s), the operations (SFC_OPS_PER_TRIP per live
    lane-trip at FP32_OPS_PER_S), the larger of which is `bound_ms`, and
    beside them the latency floor (the longest lane's rounds in the
    chain design, one L2 round trip each, `trip_bounds`), which the bytes
    and operations bound do not see."""
    from lsc_dr_planner_tpu_torch.tools import sfc_bench

    a, k = lanes
    k = {x: v for x, v in k.items() if x != "plain"}
    t = kernel_times(lambda: sfc.expand_box_kernel(*a, **k), a[1].device, "sfc_expand_kernel")
    plain_ms = cuda_ms(lambda: sfc.expand_box(*a, **k, plain=True), 2)
    live = sfc.lane_trips(a[1], a[2], *sfc.expand_box_kernel(*a, **k))
    lanes_n, lane_total, longest = len(live), int(live.sum()), int(live.max())
    r = k.get("max_radius_cells", 0)
    outcomes = lane_outcomes(a[0], a[1], a[2], a[3], r, k.get("agent"), int(live.argmax()))
    assert len(outcomes) == longest, (what, len(outcomes), longest)
    bytes_ = sfc_bench.bound_bytes(lanes_n, lane_total)
    rec = {"lanes": lanes_n, "radius": k.get("max_radius_cells", 0),
           "per_agent_images": k.get("agent") is not None, "lane_trips": lane_total,
           "longest_lane_trips": longest, **t, "plain_ms": plain_ms,
           "blocks_per_sm": sfc_occupancy(0),
           **trip_bounds(bytes_, SFC_OPS_PER_TRIP * lane_total, outcomes, l2_ns, t["ms"])}
    print(f"{what} sfc timing", json.dumps(rec), f"[{gpu}]")
    return rec


def sfc_occupancy(kernel):
    from lsc_dr_planner_tpu_torch.ops import sfc_cuda

    return sfc_cuda.occupancy(kernel)


def lane_outcomes(gw, lo, hi, order, r, agent, i):
    """The trip outcomes (True: the box grew) of lane i of an expansion,
    by the sequential loop on the CPU (the plain loop's algorithm, one
    lane)."""
    from lsc_dr_planner_tpu_torch.ops import sfc

    S = gw.blocked_cumsum if agent is None else gw.blocked_cumsum[int(agent[i])]
    S = S.cpu().numpy().astype(np.int64)
    dims = gw.dims

    def free(b):
        x0, y0, z0 = (min(max(v, 0), e - 2) for v, e in zip(b[:3], S.shape))
        x1, y1, z1 = (min(max(v + 1, 0), e - 1) for v, e in zip(b[3:], S.shape))
        return (S[x1, y1, z1] - S[x0, y1, z1] - S[x1, y0, z1] - S[x1, y1, z0] + S[x0, y0, z1]
                + S[x0, y1, z0] + S[x1, y0, z0] - S[x0, y0, z0]) == 0

    b = [int(v) for v in lo[i]] + [int(v) for v in hi[i]]
    o = [int(v) for v in order[i]]
    lim = ([max(0, v - r) if r > 0 else 0 for v in b[:3]]
           + [min(d, v + r) if r > 0 else d for v, d in zip(b[3:], dims)])
    if not (free(b) and min(b[:3]) >= 0 and all(v <= d for v, d in zip(b[3:], dims))):
        return []
    active, ptr, out = 0x3F, 0, []
    while active and len(out) < sfc._max_trips(r):
        slot = next(s_ for p in range(6) for s_ in [(ptr + p) % 6] if (active >> s_) & 1)
        d = o[slot]
        nb = list(b)
        nb[d] += -1 if d < 3 else 1
        ok = (nb[d] >= lim[d] if d < 3 else nb[d] <= lim[d]) and free(nb)
        out.append(ok)
        if ok:
            b, ptr = nb, (slot + 1) % 6
        else:
            active, ptr = active & ~(1 << slot), slot
    return out


def chain_rounds(outcomes, width=32):
    """Rounds of the chain design for a lane with these trip outcomes:
    each resolves the growths up to and with the first failing trip, at
    most `width` trips."""
    rounds = k = 0
    while k < len(outcomes):
        run = 0
        while run < width and k + run < len(outcomes) and outcomes[k + run]:
            run += 1
        k += run + (run < width and k + run < len(outcomes))
        rounds += 1
    return rounds


def trip_bounds(bytes_, ops, outcomes, l2_ns, ms):
    """An SFC kernel's bounds: bytes at 3.35 TB/s, operations at
    FP32_OPS_PER_S, the larger of them (`bound_ms`), and the latency
    floor: the longest lane's rounds in the chain design (its trip
    `outcomes`: `chain_rounds`), one L2 round trip each; each as a share
    of `ms`."""
    bytes_ms = bytes_ / 3.35e12 * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    rounds = chain_rounds(outcomes)
    floor_ms = rounds * l2_ns * 1e-6
    return {"bytes": bytes_, "bytes_ms": bytes_ms, "ops": ops, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_share": max(bytes_ms, ops_ms) / ms, "l2_round_trip_ns": l2_ns,
            "longest_lane_rounds": rounds, "latency_floor_ms": floor_ms,
            "floor_share": floor_ms / ms,
            "ms_per_longest_trip_us": ms * 1e3 / len(outcomes) if outcomes else None}


def fused_lanes(sfc, call):
    """The lanes of a recorded 'hull' update (its seeds in the default
    direction order, each agent's on its own image in a per-agent view)
    as an expand_box call's (args, kwargs)."""
    a, k = sfc_update_args(call)
    sfc.update_sfc(*a, **k)
    lo, hi = sfc.last_lanes[:2]
    gw, dev = a[0], lo.device
    agent = None
    if gw.blocked_cumsum.dim() == 4:
        agent = torch.arange(len(lo) // 3, device=dev).repeat_interleave(3)
    return ((gw, lo, hi, sfc.default_axis_order(len(lo), dev).contiguous()),
            {"max_radius_cells": k.get("max_radius_cells", 0), "agent": agent})


# The fused 'hull' update's work beyond the expansion, per agent: its
# seeds (3 lanes × 6 faces × at most 3 operations), the containment tests
# of lanes 1 and 2 (2 × 3 axes × 6: the world box's face, its shift, the
# 1e-6 slack, both sides), and its M world boxes (6 faces × 3). Bytes per
# agent beyond the expansion's: its 4 points, its M previous boxes and
# init_done read, its M boxes and world boxes and its 3 lanes (seeds,
# results, seed-free flags) written.
SFC_AGENT_OPS = 54 + 36


def sfc_hull_timing(sfc, calls, l2_ns, gpu, what):
    """The fused 'hull' SFC kernel on the first recorded 'hull' update: its
    own device ms a launch and a call's ms queued back to back
    (`kernel_times`, through sfc.update_sfc), the
    plain body's ms on the card, and the bounds of this call's work
    (`trip_bounds`: the expansion's bytes and operations as sfc_timing
    counts them, without a lane's seed and order read, plus the agents'
    own, SFC_AGENT_OPS)."""
    from lsc_dr_planner_tpu_torch.tools import sfc_bench

    a, k = sfc_update_args(calls.calls[0])
    t = kernel_times(lambda: sfc.update_sfc(*a, **k), a[2].device, "sfc_update_hull_kernel")
    plain_ms = cuda_ms(lambda: sfc.update_sfc(*a, **k, plain=True), 2)
    (gw, lo, hi, order), lk = fused_lanes(sfc, calls.calls[0])
    live = sfc.lane_trips(*sfc.last_lanes)
    lanes_n, lane_total, longest = len(live), int(live.sum()), int(live.max())
    outcomes = lane_outcomes(gw, lo, hi, order, lk["max_radius_cells"], lk["agent"],
                             int(live.argmax()))
    assert len(outcomes) == longest, (what, len(outcomes), longest)
    A, M = a[2].shape[:2]
    bytes_ = (sfc_bench.SEED_BYTES * lanes_n + sfc_bench.TRIP_BYTES * lane_total
              + A * (4 * 12 + 2 * M * 12 + 1 + 4 * M * 12 + 3 * (4 * 12 + 1)))
    ops = SFC_OPS_PER_TRIP * lane_total + A * (SFC_AGENT_OPS + 18 * M)
    rec = {"agents": A, "lanes": lanes_n, "radius": k.get("max_radius_cells", 0),
           "per_agent_images": a[0].blocked_cumsum.dim() == 4, "lane_trips": lane_total,
           "longest_lane_trips": longest, **t, "plain_ms": plain_ms,
           "blocks_per_sm": sfc_occupancy(1),
           **trip_bounds(bytes_, ops, outcomes, l2_ns, t["ms"])}
    print(f"{what} sfc_hull timing", json.dumps(rec), f"[{gpu}]")
    return rec


def kernel_name(mangled):
    """A kernel's name and template arguments from its mangled name:
    e.g. hull_closest_kernel<6>."""
    found = None  # the last length-prefixed name that ends in _kernel
    for m in re.finditer(r"\d+", mangled):
        end = m.end()
        for k in range(len(m.group())):  # the length may follow a hash's digits
            n = int(m.group()[k:])
            name = mangled[end:end + n]
            if len(name) == n and name.endswith("_kernel"):
                args = re.findall(r"L[ib](\d+)E", mangled[end + n:])
                found = name + (f"<{','.join(args)}>" if args else "")
                break
    return found or mangled


def ptxas_summary(log):
    """{kernel: {registers, spill_bytes, smem_bytes}} from nvcc's
    -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = {"registers": None, "spill_bytes": 0, "smem_bytes": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            out[name]["smem_bytes"] = int(m.group(2) or 0)
    return out


def sass_counts(lib):
    """Per kernel of the shared library `lib`, from `cuobjdump -sass`: its
    SASS instructions, global loads (LDG) and branches (BRA); None where
    the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    res, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            res[name] = {"instructions": 0, "LDG": 0, "BRA": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
        if name and m:
            op = m.group(2).split(".")[0]
            res[name]["instructions"] += 1
            if op in ("LDG", "BRA"):
                res[name][op] += 1
    return res


def sfc_probe(workload, dev, gpu, l2_ns=None):
    """Why an expansion trip costs what it does, on the main path's lanes
    (the SFC update of the step after WARMUP evolving steps at A=1024,
    with its clamp): the expansion kernel's ms (queued back to back) on
    all lanes and on the longest lane alone, as µs per trip of the
    longest lane and in L2 round trips (`sfc_cuda.l2_round_trip_ns`),
    and one dependent 8-corner query (`query_round_trip_ns`); and the SASS of the kernel
    library (`sass_counts`). It runs on older checkouts of the port (from
    the one with tools/sfc_bench.py on) as `clsc_split` does."""
    from lsc_dr_planner_tpu_torch.ops import cuda_build, sfc, sfc_cuda

    planner, fleet, inp = main_path_state(workload, dev)
    fused = hasattr(sfc, "update_sfc")
    if fused:  # the 'hull' update is one fused launch: its lanes
        with Calls(sfc, "update_sfc", accept=hull_mode) as c:
            planner._step_impl(fleet, inp)
        (gw, lo, hi, order), k = fused_lanes(sfc, c.calls[0])
    else:
        with Calls(sfc, "expand_box") as c:
            planner._step_impl(fleet, inp)
        a, k = c.calls[0][:2]
        gw, lo, hi, order = a[0], a[1], a[2], a[3].to(torch.int64).contiguous()
    r = k.get("max_radius_cells", 0)
    live = sfc.lane_trips(lo, hi, *sfc.expand_box_kernel(gw, lo, hi, order, r))
    i = int(live.argmax())
    longest = int(live[i])
    l2 = l2_ns if l2_ns is not None else sfc_cuda.l2_round_trip_ns(dev)
    rows = []
    for name, lanes in (("all", (lo, hi, order)),
                        ("longest_alone", tuple(t[i:i + 1].contiguous()
                                                for t in (lo, hi, order)))):
        ms = queued_ms(lambda: sfc_cuda.expand_box_cuda(
            gw.blocked_cumsum, gw.dims, *lanes, r, sfc._max_trips(r), None), KERNEL_REPS)
        rows.append({"lanes": name, "n_lanes": len(lanes[0]), "ms": ms,
                     "us_per_trip": ms * 1e3 / longest,
                     "l2_round_trips_per_trip": ms * 1e6 / longest / l2})
    res = {"package": str(Path(sfc.__file__).resolve().parents[1]), "lanes": len(lo),
           "lane_trips": int(live.sum()), "longest_lane_trips": longest, "radius": r,
           "image": list(gw.blocked_cumsum.shape),
           "image_mib": gw.blocked_cumsum.numel() * 4 / 2**20, "l2_round_trip_ns": l2,
           "rows": rows, "gpu": gpu}
    if hasattr(sfc_cuda, "query_round_trip_ns"):
        q = sfc_cuda.query_round_trip_ns(gw.blocked_cumsum)
        res.update(query_ns=q, query_l2_round_trips=q / l2)
    res["sass"] = sass_counts(cuda_build.library_path(sfc_cuda.SOURCE))
    print("sfc probe", json.dumps(res), f"[{gpu}]")
    return res


def sfc_probe_main():
    """`sfc_probe` alone on the card, for the checkout whose package is
    imported (see `sfc_probe`): one JSON line."""
    from lsc_dr_planner_tpu_torch import workload

    sfc_probe(workload, torch.device("cuda", 0), gpu_line())


def min_pair_distance_now(pos, dim, downwash):
    """Smallest distance between two agents of the fleet state: planar in
    2-D; in 3-D with z scaled by 1/downwash (the ellipsoidal collision
    model of equal agents)."""
    q = pos[:, :dim].clone()
    if dim == 3:
        q[:, 2] = q[:, 2] / downwash
    d = torch.cdist(q, q) + torch.eye(len(q), device=q.device) * 1e9
    return d.min().item()


def unconverged_steps(qp, planner, fleet, states, convs, out_dir):
    """For each step whose QP left agents unconverged (`convs`, the
    steps' converged shares; `states`, each step's input state): that
    step's QP solved again from its state by the kernel and by the plain
    loop (qp.solve, plain=True), and the agents each leaves unconverged:
    whether the QP itself, and not the kernel, holds them. The step's QP
    inputs, its QPConfig and tolerance go to
    `out_dir/unconverged_qp_step<i>.npz`, for solvers off the card."""
    out = []
    for i, (inp, conv) in enumerate(zip(states, convs)):
        if conv >= 1.0:
            continue
        cfg, tol = planner.qp_cfg, planner.feas_tol
        qp_inp = planner._step_impl(fleet, inp, defer_qp=True).qp_inp
        got, want = qp.solve(cfg, qp_inp, tol), qp.solve(cfg, qp_inp, tol, plain=True)
        out.append({"step": i, "converged_share": conv,
                    "kernel_unconverged": torch.nonzero(~got.converged).flatten().tolist(),
                    "plain_unconverged": torch.nonzero(~want.converged).flatten().tolist()})
        np.savez_compressed(
            out_dir / f"unconverged_qp_step{i}.npz", feas_tol=tol,
            cfg=json.dumps(dataclasses.asdict(cfg)),
            **{f.name: getattr(qp_inp, f.name).cpu().numpy()
               for f in dataclasses.fields(qp_inp) if getattr(qp_inp, f.name) is not None})
    return out


# ---- phase 8: the fused step in the other planner modes ------------------
# The JAX package on the CPU on the same layout and steps, planning along
# its own plan (tests/cpu_reference.py convergence bvc|rsfc 1024 16): mean
# QP convergence over steps 7-16 (phase 8's timed steps) and the smallest
# planar distance between two agents after them
JAX_CPU_1024 = {"8c": (0.608008, 0.303347), "8d": (0.202930, 0.028253)}
CONV_GAP, SEP_GAP = 0.03, 0.01
# The JAX package on the CPU in a mode whose convergence phase 8 holds the
# port to (no worse, less one straggler a step), on the same layout, fleet
# and steps, planning along its own plan (tests/cpu_reference.py
# convergence degree8 1024 9): mean QP convergence over the steps that phase
# 8h times (5-9), and the fleet. Both packages rescue at most 64 agents
# (qp.RESCUE), so the share depends on the fleet: at A=64 the JAX package
# converges 0.8375 over the same steps (convergence degree8 64 9)
JAX_CPU_CONV = {"8h": (0.105859375, 1024)}


def phase8_modes():
    from lsc_dr_planner_tpu_torch.config import GoalMode, PlannerMode

    # (tag, name, Param overrides, loop_check's float64 clause). BVC and
    # RSFC with static goals jam this dense antipodal layout: as agents
    # meet, their QPs fail and the failsafe keeps the initial trajectory
    # (RSFC's flies on at constant velocity), in the JAX package as in the
    # port, so (c) and (d) are held to the JAX package's convergence and
    # separation (JAX_CPU_1024), (a) and (b) to convergence > 0.9
    static = dict(goal_mode=GoalMode.STATIC, communication_range=-1.0)
    return (
        ("8a", "DLSC sub-step", dict(planner_mode=PlannerMode.DLSC, multisim_time_step=0.1),
         True),
        ("8b", "LSC-DR 3-D", dict(world_dimension=3), True),
        ("8c", "BVC + STATIC", dict(planner_mode=PlannerMode.BVC, **static), False),
        ("8d", "RSFC + STATIC", dict(planner_mode=PlannerMode.RECIPROCAL_RSFC, **static),
         False),
    )


def fused_mode(workload, qp, builds, dev, gpu, tag, overrides, steps=True,
               float64_clause=False, l2_ns=None, moved_seeds=(), warmup=WARMUP, timed=TIMED8,
               stage_recs=(), separate=0):
    """One planner mode at A=1024: loop_check on the QP after 3 evolving
    steps and on its compacted rescue (with `moved_seeds`, also on the
    QPs of that state moved by MOVE_M m, one state a seed: each state's
    largest ratios printed, every state's preparation held to the plain
    body by `prepare_check`), the loop timed, then (with `steps`)
    3 warm-up and 10 timed steps, each geometry kernel launched once a
    call of its function, the SFC kernels held to their plain versions
    on the first and sixth timed steps' SFC calls (`sfc_hull_check` in
    'hull' mode, `sfc_check` in 'point' and 'substep') and timed on the
    first; with DR goals in the LSC family `clsc_check` on the same steps'
    CLSC constructions and the fused CLSC kernel timed on the first (BVC
    and RSFC make none). `warmup` and `timed`: the steps before the
    checks and the timed steps (the first warm-up steps' count too);
    `stage_recs`: the stage recorders, restarted before the timed steps,
    held to one launch a call of each entry, then `stage_checks` and
    `stage_timing` on their calls; `separate`: that many steps more with
    the selection and the prediction as two launches (`separate_launches`),
    checked and timed the same way."""
    from lsc_dr_planner_tpu_torch.config import GoalMode, PlannerMode
    from lsc_dr_planner_tpu_torch.ops import geometry, hull_cuda, lsc, sfc

    p, planner, fleet, inp = workload.build_fleet(A_MAIN, device=dev, timing=True, **overrides)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(warmup):
        inp, _ = step(inp)
    cfg, feas_tol = planner.qp_cfg, planner.feas_tol
    states = moved_states(planner, fleet, inp, moved_seeds)
    with Calls(qp, "prepare", keep=len(states)) as preps:
        lis = [qp.prepare(cfg, qp_inp).loop for _, _, qp_inp in states]
    li = lis[0]
    res = {"mode": tag, "overrides": {k: getattr(v, "name", v) for k, v in overrides.items()},
           "build": builds.name(cfg, li.xi.shape[0]), "dk": cfg.dim * li.Pn.shape[-1],
           "R": li.z.shape[1],
           "feas_tol": feas_tol}
    res["check"] = loop_check(qp, cfg, li, feas_tol, f"phase{tag}",
                              float64_clause=float64_clause, strict=not moved_seeds)
    builds.note_check(cfg, res["check"])
    if moved_seeds:
        res["moved_checks"] = [loop_check(qp, cfg, li_s, feas_tol, f"phase{tag} {name}",
                                          float64_clause=float64_clause, strict=False)
                               for (name, _, _), li_s in zip(states[1:], lis[1:])]
        sweep = [{"state": name, "move_seed": seed,
                  "chunk_ratio_to_envelope": r["chunk_ratio_to_envelope"],
                  "whole_run_ratio_to_envelope": r.get("whole_run_f64", {}).get("ratio_max"),
                  "failures": r["failures"]}
                 for (name, seed, _), r in zip(states, [res["check"], *res["moved_checks"]])]
        res["moved_sweep"] = sweep
        print(f"phase{tag} moved states (by {MOVE_M} m; F64_FACTOR 5)", json.dumps(sweep))
        for r in res["moved_checks"]:
            builds.note_check(cfg, r)
        res["prepare_check"] = prepare_check(qp, builds.qp_prepare_cuda, builds, preps,
                                             f"phase{tag} states")
        assert not any(r["failures"] for r in sweep), (tag, sweep)
    xi, z, y = qp.run_loop(cfg, li, cfg.max_iter, feas_tol)[:3]
    sub = qp.rescue_batch(cfg, li, xi, z, y, feas_tol)[2]
    res["rescue_check"] = loop_check(qp, cfg, sub, feas_tol, f"phase{tag} rescue",
                                     max_iter=cfg.rescue_iter, float64_clause=float64_clause)
    builds.note_check(cfg, res["rescue_check"])
    res["timing"] = admm_timing.timed_call(qp, cfg, li, cfg.max_iter, feas_tol, tag, 10)
    lib = builds.lib
    shape = (cfg.dim, cfg.n_obs, cfg.M, cfg.N, li.Pn.shape[-1], li.z.shape[1] - cfg.n_obs * cfg.M * cfg.N)
    res["timing"].update(builds.qp_cuda.last_launch, threads=lib.admm_threads(*shape),
                         placement=builds.qp_cuda.placement(lib, *shape),
                         blocks_per_sm=builds.qp_cuda.last_launch["ctas_per_sm"])
    plain_ms = cuda_ms(lambda: qp.admm_loop_plain(cfg, li, cfg.max_iter, feas_tol), 2)
    res["timing"]["plain_ms"] = plain_ms
    builds.note_timing(cfg, res["timing"], plain_ms)
    print(f"phase{tag} timing", json.dumps(res["timing"]), f"[{gpu}]")
    assert res["timing"]["blocks_per_sm"] > 0, res["timing"]
    if not steps:
        return res

    for _ in range(warmup):
        inp, _ = step(inp)
    torch.cuda.synchronize()
    builds.reset_launches()
    sfc.reset_counts()
    restart(stage_recs, max(1, timed // 2))
    dists = []

    def check(inp):
        for name in ("pos", "vel", "acc", "prev_ctrl", "current_goal", "qp_y0"):
            assert torch.isfinite(getattr(inp, name)).all(), (tag, name)
        dists.append(min_pair_distance_now(inp.pos, p.world_dimension,
                                           float(fleet.downwash[0])))

    every = max(1, timed // 2)
    recorders = path_calls(sfc, lsc, geometry, every=every)
    sfcs, expands, clscs, hulls = recorders
    with sfcs, expands, clscs, hulls, Calls(qp, "prepare", every=every) as preps:
        inp, lat, stages, convs = admm_timing.timed_steps(step, planner, inp, timed, check)
    launches = builds.add_path_launches()
    lane_trips = sfc.read_lane_trips()
    lat = np.asarray(lat)
    res.update(steps=timed, p50_ms=float(np.percentile(lat, 50) * 1e3),
               p99_ms=float(np.percentile(lat, 99) * 1e3),
               agent_steps_per_s=A_MAIN * timed / float(lat.sum()),
               qp_convergence=float(np.mean(convs)), min_pair_distance=min(dists),
               qp_convergence_per_step=convs, min_pair_distance_per_step=dists,
               kernel_launches=launches, stage_ms=admm_timing.mean_stages(stages), gpu=gpu,
               sfc_trips_per_step=lane_trips / timed, sfc_syncs_per_step=sfc.syncs / timed,
               sfc_plain_trips=sfc.trips)
    print(f"phase{tag}", json.dumps({k: v for k, v in res.items()
                                      if k not in ("check", "rescue_check", "timing")}))
    lsc_family = p.planner_mode in (PlannerMode.LSC, PlannerMode.DLSC)
    dr = lsc_family and p.goal_mode == GoalMode.GRID_BASED_PLANNER
    builds.assert_launched(launches, f"phase {tag}", hull=lsc_family, clsc=dr,
                           sfc_hull=dr and not planner.substep)
    assert_one_launch_a_call(launches, recorders, f"phase {tag}", stage_recs)
    assert sfc.syncs == 0 and sfc.trips == 0, f"phase {tag}: the plain SFC loop ran"
    assert sfcs.n + expands.n == timed and clscs.n == (timed if dr else 0), (tag, clscs.n)
    res["launches_per_call"] = {
        "clsc_build": launches["clsc_build"] / clscs.n if clscs.n else None,
        "sfc_update_hull": launches["sfc_update_hull"] / sfcs.n if sfcs.n else None,
        "sfc_expand": launches["sfc_expand"] / expands.n if expands.n else None}
    assert preps.n == launches["qp_prepare"] == timed, (tag, preps.n, launches["qp_prepare"])
    res["prepare_check"] = prepare_check(qp, builds.qp_prepare_cuda, builds, preps, f"phase{tag}")
    if tag in ("8b", "8f", "8h"):  # the preparation timed, the QP stage split
        res["prepare_timing"] = prepare_timing(qp, builds.qp_prepare_cuda, preps, gpu,
                                               f"phase{tag}")
        res["qp_split"] = qp_split(workload, dev, gpu, overrides, reps=10 if tag == "8b" else 4)
        assert res["qp_split"]["solve_under_sync_error_mode"] == "ok", res["qp_split"]
        assert res["qp_split"]["host_syncs_per_step"] == [0] * SYNC_COUNT_REPS, res["qp_split"]
        ms = res["qp_split"]["ms"]
        print(f"phase{tag} QP split", json.dumps({k: ms.get(k) for k in (
            "assembly", "prepare", "main_loop", "rescue_batch", "rescue_loop", "finish",
            "stage")}), f"[{gpu}]")
    if sfcs.n:
        res["sfc_hull_check"] = sfc_hull_check(sfc, builds, sfcs, f"phase{tag}")
        res["sfc_hull_timing"] = sfc_hull_timing(sfc, sfcs, l2_ns, gpu, f"phase{tag}")
    if expands.n:
        res["sfc_check"] = sfc_check(sfc, builds, expands, f"phase{tag}")
        res["sfc_timing"] = sfc_timing(sfc, expands.calls[0][:2], l2_ns, gpu, f"phase{tag}")
    if clscs.n:
        res["clsc_check"] = clsc_check(lsc, builds, clscs, f"phase{tag}")
        res["clsc_timing"], x = clsc_timing(lsc, hull_cuda, geometry, clscs, gpu, f"phase{tag}")
        res["hull_timing"] = hull_timing(geometry, hull_cuda, builds, x, gpu, f"phase{tag}")
    if stage_recs:
        res["stage_checks"] = stage_checks(builds, stage_recs, f"phase{tag}")
        res["stage_timing"] = stage_timing(builds, stage_recs, gpu, f"phase{tag}")
    if separate:
        from lsc_dr_planner_tpu_torch.planner import stages as stage_ops

        builds.reset_launches()
        restart(stage_recs, 1)
        with separate_launches(stage_ops):
            for _ in range(separate):
                inp, _ = step(inp)
        sep_launches = builds.add_path_launches()
        assert [sep_launches[r.name] for r in stage_recs] == [r.n for r in stage_recs] == [
            separate, separate, 0, separate], [(r.name, r.n) for r in stage_recs]
        res["separate"] = {
            "steps": separate, "kernel_launches": sep_launches,
            "stage_checks": stage_checks(builds, stage_recs, f"phase{tag} separate"),
            "stage_timing": stage_timing(builds, stage_recs[:2], gpu, f"phase{tag} separate")}
    sep = 2 * 0.15 - feas_tol
    if tag in JAX_CPU_1024:
        conv_ref, sep_ref = JAX_CPU_1024[tag]
        res["jax_cpu"] = {"qp_convergence": conv_ref, "min_pair_distance": sep_ref}
        assert abs(res["qp_convergence"] - conv_ref) <= CONV_GAP, (tag, res, conv_ref)
        sep = min(sep, sep_ref - SEP_GAP)
    elif tag in JAX_CPU_CONV:
        conv_ref, A_ref = JAX_CPU_CONV[tag]
        res["jax_cpu"] = {"qp_convergence": conv_ref, "agents": A_ref}
        # no worse than the JAX package's, less one straggler a step
        assert res["qp_convergence"] >= conv_ref - 1 / A_MAIN, (tag, res["qp_convergence"],
                                                                 conv_ref)
    else:
        assert res["qp_convergence"] > 0.9, (tag, res["qp_convergence"])
    assert res["min_pair_distance"] >= sep, (tag, res["min_pair_distance"], sep)
    return res


# ---- phase 8f, 8g: the shapes past the narrow kernels' builds --------------
# 8f: the main path with every agent within 5 m an obstacle, as the reference
# plans (SURVEY §2.6: no cap on the neighbour set; 48-80 agents within 5 m of
# an interior agent of the 1.2 m lattice), in 3-D at a horizon of 12 segments
# (K = 34, dim·K 102): the ADMM kernel's cluster build, the selection's and
# the prediction's wide builds (OA = O = 80)
P8F = dict(world_dimension=3, M=12, communication_range=5.0, max_obstacles=80)
P8F_WARMUP, P8F_TIMED, P8F_SEPARATE = 2, 5, 1
# 8h: the main path at Bézier degree 8, which the JAX package plans (9
# control points a segment: the hull kernels' run-time build; K = 58, dim·K
# 116: the ADMM kernel's memory build, its rescue the cluster build); 8h's
# query: plain LSC (static goals,
# build_lsc: the hull query alone) at degree 8, P8H_QUERY_STEPS steps
P8H = dict(n=8)
P8H_WARMUP, P8H_TIMED, P8H_QUERY_STEPS = 2, 5, 2


def solve_against_plain(workload, qp, dev, gpu, overrides, what):
    """The kernel path's solve (the preparation and loop kernels) against
    the plain path's (qp.solve(plain=True)) on the QP after WARMUP
    evolving steps of `build_fleet(A_MAIN, **overrides)`: the kernel
    converges at least as many agents less 0.5 points (phase 4's
    contract), and where the kernel, the plain path and the float64 plain
    path (`qp_check.solve_f64`) converged, each agent's control points lie
    within 0.1 m of float64 or no farther than F64_FACTOR times the
    float32 plain path's (the float64 clause of
    tests/test_torch_cuda.py)."""
    from lsc_dr_planner_tpu_torch.ops import qp_check

    planner, fleet, inp = main_path_state(workload, dev, **overrides)
    cfg, tol = planner.qp_cfg, planner.feas_tol
    qp_inp = planner._step_impl(fleet, inp, defer_qp=True).qp_inp
    out, ref = qp.solve(cfg, qp_inp, tol), qp.solve(cfg, qp_inp, tol, plain=True)
    exact = qp_check.solve_f64(cfg, qp_inp, tol)
    both = out.converged & ref.converged & exact.converged
    d_k, d_p = ((r.x.double() - exact.x).abs().flatten(1).amax(1)[both] for r in (out, ref))
    ok = (d_k < 0.1) | (d_k <= qp_check.F64_FACTOR * d_p)
    rec = {"converged_kernel": float(out.converged.float().mean()),
           "converged_plain": float(ref.converged.float().mean()),
           "converged_f64": float(exact.converged.float().mean()),
           "agents_compared": int(both.sum()),
           "kernel_vs_f64_max": float(d_k.max()), "plain_vs_f64_max": float(d_p.max()),
           "agents_off_clause": int((~ok).sum())}
    print(f"{what} solve against plain", json.dumps(rec), f"[{gpu}]")
    assert rec["converged_kernel"] >= rec["converged_plain"] - 0.005, (what, rec)
    assert both.any() and ok.all(), (what, rec)
    return rec


def phase8h_query(workload, builds, dev, gpu, steps=P8H_QUERY_STEPS):
    """The hull query's run-time build on a path: plain LSC with static
    goals (build_lsc queries the hulls on their own) at degree 8 and
    A=1024, `steps` evolving steps, each query one launch of the run-time
    build and no plain enumeration on the card; every query held to the
    plain enumeration (`hull_check`), every output finite."""
    from lsc_dr_planner_tpu_torch.config import GoalMode
    from lsc_dr_planner_tpu_torch.ops import geometry, hull_cuda

    p, planner, fleet, inp = workload.build_fleet(A_MAIN, device=dev, goal_mode=GoalMode.STATIC,
                                                  **P8H)
    step = workload.make_evolve_step(p, planner, fleet)
    builds.reset_launches()
    convs = []
    with Calls(geometry, "closest_point_origin_to_hull", keep=steps) as hulls:
        for _ in range(steps):
            inp, conv = step(inp)
            convs.append(float(conv.float().mean()))
    launches = builds.add_path_launches()
    for name in ("pos", "vel", "acc", "prev_ctrl"):
        assert torch.isfinite(getattr(inp, name)).all(), ("phase 8h query", name)
    res = {"steps": steps, "qp_convergence_per_step": convs, "kernel_launches": launches,
           "hull_check": hull_check(geometry, hull_cuda, builds, hulls, "phase8h query")}
    print("phase8h query", json.dumps({k: v for k, v in res.items() if k != "hull_check"}),
          f"[{gpu}]")
    assert hulls.n == launches["hull_closest"] == launches["hull_closest_rt"] == steps, launches
    assert launches["hull_plain_on_cuda"] == 0 and launches["clsc_build"] == 0, launches
    return res


def phase8g_qp_cases():
    """(tag, build_fleet overrides, agents) of 8g's QPs: 3-D at M = 11
    (dim·K 93: the triple build's ten-warp width), DLSC in 3-D at M =
    12 (108), 3-D at M = 16 (138), 3-D at M = 28 with 160 slots
    (246: the KKT tiles, Kinv and the rows past shared memory), and with
    480 slots (246: an agent's rows and Kinv past 8 CTAs' shared memory,
    which the cluster build refuses: the loop's global build; 481 agents,
    the fewest that give 480 slots, each slot another agent)."""
    from lsc_dr_planner_tpu_torch.config import PlannerMode

    return ((P8G_TRIPLE10, dict(world_dimension=3, M=11), 64),
            ("dk108", dict(world_dimension=3, M=12, planner_mode=PlannerMode.DLSC), 64),
            ("dk138", dict(world_dimension=3, M=16), 64),
            ("dk246_O160", dict(world_dimension=3, M=28, communication_range=30.0,
                                max_obstacles=160), 168),
            (P8G_GLOBAL, dict(world_dimension=3, M=28, communication_range=30.0,
                              max_obstacles=480), 481))


P8G_GLOBAL = "dk246_O480"  # 8g's QP past the cluster build's reach
# (tag, build_fleet overrides, agents) where the global build, forced, is held
# to the cluster build bit for bit: 8f's shape (C = 2) and 8g's 160 slots (C = 8)
P8G_BITS_CASES = (("8f", dict(world_dimension=3, M=12, communication_range=5.0,
                              max_obstacles=80), 64),
                  ("dk246_O160", dict(world_dimension=3, M=28, communication_range=30.0,
                                      max_obstacles=160), 168))
P8G_TRIPLE10 = "dk93"  # 8g's QP on the triple build's ten-warp width
GLOBAL_LOOP_REPS = 3  # the loop's global build: calls timed (~0.2-0.5 s each)


def global_loop_bytes(qp_cuda, li, iters, chunk=8):
    """The global build's bytes a call of `iters` iterations: `floor_gb`,
    what any design of the loop must move at this shape, one pass over an
    agent's rows an iteration (z, y, A·xi and l in, z, y and A·xi out: 28
    B a row), its Kinv and its normals read once an iteration; and, where
    the package has `qp_cuda.global_tile_plan` (the streamed build),
    `moved_gb`, what that build moves: those passes, each launch's first
    pass (z, y and the normals in), the chunk's last pass's scale (4 B a
    row) and the first launch's copy of the warm start (z, y and A·xi
    out); None otherwise."""
    A, O, M, dim = li.normals.shape
    R, dk = li.z.shape[1], li.Kinv.shape[-1]
    nrm, launches = 4 * O * M * dim, -(-iters // chunk)
    per_iter = 28 * R + 4 * dk * dk + nrm
    out = {"floor_gb": A * iters * per_iter / 1e9, "moved_gb": None}
    if hasattr(qp_cuda, "global_tile_plan"):
        out["moved_gb"] = A * (iters * per_iter + launches * (8 * R + nrm + 4 * R) + 12 * R) / 1e9
    return out


def global_loop_timing(qp, qp_cuda, cfg, li, feas_tol, dev, what):
    """The loop's global build on `li` (one call: `timed_call`, mean ms by
    CUDA events over GLOBAL_LOOP_REPS calls), the same calls queued behind
    a sleep kernel (`queued_ms`), and GLOBAL_LOOP_REPS calls under
    torch.profiler: the ADMM kernels it saw a call (it may miss some
    ctypes launches: on the H100 it saw 25 and 19.7 of a call's 25 in two
    runs), those that ran iterations (longer than 0.1 ms), their mean
    device ms, and `device_ms`, that mean times the launches the wrapper
    counted a call; the iterations of each call and whether the calls'
    iterates are the same bits; the bytes a call (`global_loop_bytes`),
    the one-pass floor's ms at the card's 3.35 TB/s and its share of the
    call's ms, the rate of the bytes the build moves, and the kernel's
    registers and spills where this process built it with ptxas's
    record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lsc_dr_planner_tpu_torch.ops import cuda_build

    t = admm_timing.timed_call(qp, cfg, li, cfg.max_iter, feas_tol, what, GLOBAL_LOOP_REPS)
    t.update(qp_cuda.last_launch)
    t["queued_ms"] = queued_ms(lambda: qp.run_loop(cfg, li, cfg.max_iter, feas_tol),
                               GLOBAL_LOOP_REPS)
    outs = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(GLOBAL_LOOP_REPS):
            outs.append(qp.run_loop(cfg, li, cfg.max_iter, feas_tol))
        torch.cuda.synchronize(dev)
    # the streamed build's kernel, or an older tree's one-block kernel
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and ("admm_global_kernel" in e.name or "admm_chunk_kernel" in e.name)]
    t["profiled_kernels"] = len(us) / GLOBAL_LOOP_REPS
    t["profiled_working_launches"] = sum(u > 100 for u in us) / GLOBAL_LOOP_REPS
    t["profiled_kernel_ms"] = sum(us) / 1e3 / len(us) if us else None
    t["device_ms"] = t["profiled_kernel_ms"] * t["launches"] if us else None
    t["iters_each"] = [int(o[4]) for o in outs]
    t["same_bits"] = all(differing(a, b) == 0 for o in outs[1:] for a, b in zip(o[:4], outs[0][:4]))
    t.update(global_loop_bytes(qp_cuda, li, t["iters"]))
    t["floor_ms"] = t["floor_gb"] / admm_timing.PEAK_BYTES * 1e12
    t["floor_share"] = t["floor_ms"] / t["ms"]
    t["floor_tb_per_s"] = t["floor_gb"] / t["ms"]
    t["moved_tb_per_s"] = t["moved_gb"] / t["ms"] if t["moved_gb"] else None
    log = cuda_build.build_log.get("admm.cu")
    t["ptxas"] = ptxas_summary(log[1]).get(admm_ptxas(qp_cuda, qp_cuda.GLOBAL_BUILD)) \
        if log else None
    return t


def global_bits_check(workload, qp, qp_cuda, dev, gpu, tag, overrides, A):
    """The global build forced (`admm_loop_cuda(..., C=0)`) against the
    build `loop_plan` gives the batch (the cluster build at the shapes
    where both run), on the QP after one evolving step of
    `build_fleet(A, **overrides)`: one chunk and the run to its exit, xi,
    z, y, itdone and the iterations the same bits (both run the cluster
    build's order of operations). Launches outside any path's window."""
    p, planner, fleet, inp = workload.build_fleet(A, device=dev, **overrides)
    inp, _ = workload.make_evolve_step(p, planner, fleet)(inp)
    cfg, tol = planner.qp_cfg, planner.feas_tol
    li = qp.prepare(cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp).loop
    ts = qp.torch_statics(cfg, dev)
    plan = qp_cuda.launch_plan(admm_shape(qp, cfg, dev), A)

    def run(iters, C):
        return qp_cuda.admm_loop_cuda(li, ts["stencil"], ts["N3k"], ts["N3kT"],
                                      cfg.rho * qp._RHO_SCALE["lsc"], iters, qp.CHUNK,
                                      0.6 * tol, cfg.sigma, cfg.alpha, cfg.eps_abs, C=C)

    rec = {"A": A, "dk": cfg.dim * ts["K"], "R": li.z.shape[1], "build": plan["build"],
           "C": plan["C"]}
    for iters in (qp.CHUNK, cfg.max_iter):
        g, c = run(iters, 0), run(iters, plan["C"])
        torch.cuda.synchronize(dev)
        rec[f"differing_{iters}"] = [differing(a, b) for a, b in zip(g, c)]
        rec[f"iters_{iters}"] = int(g[4])
    print(f"global build against {plan['build']} at C = {plan['C']}, {tag}", json.dumps(rec),
          f"[{gpu}]", flush=True)
    assert plan["build"] == qp_cuda.CLUSTER_BUILD, rec
    assert not any(rec[f"differing_{n}"][i] for n in (qp.CHUNK, cfg.max_iter)
                   for i in range(5)), (tag, rec)
    return rec


P8G_SLOTS = (64, 65, 80, 160, 256)  # O = OA, fleets of O + 6 agents within 20 m (2-D)
P8G_SELECT = ((256, 1024, 5000), (32, 33, 80, 128, 255))  # A, OA on the 0.75 m lattice


def square_lattice(A, dev):
    """A square lattice of 0.75 m (exact in binary: its L∞ distances tie)."""
    side = int(np.ceil(np.sqrt(A)))
    ij = np.stack(np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), -1)
    pos = np.concatenate([ij.reshape(-1, 2)[:A] * 0.75, np.full((A, 1), 0.6)], 1)
    return torch.as_tensor(pos, dtype=torch.float32, device=dev)


def phase8g(workload, qp, builds, dev, gpu, srec):
    """The boundary shapes: (a) 8g's QPs (phase8g_qp_cases): one evolving
    step of each fleet, `prepare_check` on its preparation, `loop_check`
    on the next step's QP (its float64 clause), the builds they took (the
    loop's cluster build and its cluster size); the preparation's global
    build and the loop's cluster build at 246 timed; (b) fleets of O + 6 agents with O = OA slots of
    P8G_SLOTS: a step through the fused entry, a step with the selection
    and the prediction as two launches and the prediction on the
    gathered slots (the multi-device steps' entry), each call held to its
    plain body (`stage_checks`), `loop_check` at 256 slots (2-D rows past
    shared memory); (c) the selection alone on the lattice at every A and
    OA of P8G_SELECT, with and without a range, against the plain body."""
    from lsc_dr_planner_tpu_torch.ops import qp_cuda, qp_prepare_cuda
    from lsc_dr_planner_tpu_torch.planner import stages as stage_ops

    out = {"qp": {}, "slots": {}, "selection": {}}
    lib = qp_cuda.build()
    for tag, over, A in phase8g_qp_cases():
        p, planner, fleet, inp = workload.build_fleet(A, device=dev, **over)
        step = workload.make_evolve_step(p, planner, fleet)
        inp, _ = step(inp)
        builds.reset_launches()
        with Calls(qp, "prepare", keep=1) as preps:
            inp, conv = step(inp)
        launches = builds.add_path_launches()
        cfg, feas_tol = planner.qp_cfg, planner.feas_tol
        shape = admm_shape(qp, cfg, dev)
        rec = out["qp"][tag] = {
            "A": A, "dk": cfg.dim * shape[4], "R": qp.n_rows(cfg), "O": cfg.n_obs,
            "admm_build": qp_cuda.build_name(lib, *shape, A),
            "admm_plan": qp_cuda.launch_plan(shape, A),
            "prepare_build": qp_prepare_cuda.build_name(*shape[:5]),
            "qp_convergence": float(conv.float().mean()), "kernel_launches": launches}
        builds.assert_launched(launches, f"phase 8g {tag}")
        assert launches[rec["admm_build"]] > 0 and launches["qp_prepare"] == 1, (tag, launches)
        rec["prepare_check"] = prepare_check(qp, qp_prepare_cuda, builds, preps,
                                             f"phase8g {tag}")
        li = qp.prepare(cfg, planner._step_impl(fleet, inp, defer_qp=True).qp_inp).loop
        rec["check"] = loop_check(qp, cfg, li, feas_tol, f"phase8g {tag}", float64_clause=True)
        builds.note_check(cfg, rec["check"])
        if tag == P8G_TRIPLE10:  # the triple build's ten-warp width timed
            t = rec["timing"] = admm_timing.timed_call(qp, cfg, li, cfg.max_iter, feas_tol, tag, 5)
            t.update(qp_cuda.last_launch)
            builds.note_timing(cfg, t, cuda_ms(
                lambda: qp.admm_loop_plain(cfg, li, cfg.max_iter, feas_tol), 1))
        if tag == P8G_GLOBAL:  # the loop's global build timed
            assert rec["admm_build"] == qp_cuda.GLOBAL_BUILD, rec
            t = rec["timing"] = global_loop_timing(qp, qp_cuda, cfg, li, feas_tol, dev, tag)
            plain_ms = cuda_ms(lambda: qp.admm_loop_plain(cfg, li, cfg.max_iter, feas_tol), 1)
            builds.note_timing(cfg, t, plain_ms)
        if tag == "dk246_O160":  # the global builds timed
            rec["timing"] = admm_timing.timed_call(qp, cfg, li, cfg.max_iter, feas_tol, tag, 3)
            rec["timing"]["plain_ms"] = cuda_ms(
                lambda: qp.admm_loop_plain(cfg, li, cfg.max_iter, feas_tol), 1)
            assert rec["prepare_build"] == qp_prepare_cuda.GLOBAL_BUILD, rec
            t = prepare_kernel_record(qp, qp_prepare_cuda, cfg, preps.calls[0][0][1])
            rec["prepare_timing"] = t
            builds.prep_global.update({k: t[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
                "library_ms", "smem_bytes", "blocks_per_sm")}, A=A, dk=rec["dk"])
        print(f"phase8g {tag}", json.dumps({k: v for k, v in rec.items()
                                            if k not in ("check", "prepare_check")}),
              f"[{gpu}]")
    for tag, rec in out["qp"].items():  # past the register builds: the cluster build
        want = {P8G_GLOBAL: qp_cuda.GLOBAL_BUILD, P8G_TRIPLE10: "<320,32>"}
        assert rec["admm_build"] == want.get(tag, qp_cuda.CLUSTER_BUILD), rec
    assert out["qp"]["dk246_O160"]["admm_plan"]["C"] == 8, out["qp"]["dk246_O160"]
    # the global build's bits against the cluster build's where both run
    out["global_bits"] = {tag: global_bits_check(workload, qp, qp_cuda, dev, gpu, tag, over, A)
                          for tag, over, A in P8G_BITS_CASES}

    for O in P8G_SLOTS:
        p, planner, fleet, inp = workload.build_fleet(
            O + 6, device=dev, max_obstacles=O, communication_range=20.0)
        assert planner.O == planner.O_agents == O, (O, planner.O)
        step = workload.make_evolve_step(p, planner, fleet)
        inp, _ = step(inp)
        builds.reset_launches()
        restart(srec, 1)
        inp, conv = step(inp)
        with separate_launches(stage_ops):
            d = planner._step_impl(fleet, inp, defer_qp=True)
        order, valid = stage_ops.neighbor_slots(inp.pos, 1, planner.stage_cfg)
        nd = stage_ops.gather_neighbors(fleet, inp, order, valid)
        stage_ops.step_front(planner.stage_cfg, fleet, inp, neighbors=nd)
        launches = builds.add_path_launches()
        rec = out["slots"][O] = {
            "A": O + 6, "O": O, "qp_convergence": float(conv.float().mean()),
            "kernel_launches": launches, "stage_checks": stage_checks(builds, srec,
                                                                      f"phase8g O={O}")}
        assert launches["front_with_neighbors_wide"] == 1 and launches["neighbor_slots_wide"] == 2
        assert launches["step_front_wide"] == (2 if O > 64 else 0), launches
        if O == P8G_SLOTS[-1]:
            cfg = planner.qp_cfg
            shape = admm_shape(qp, cfg, dev)
            rec["admm_plan"] = qp_cuda.launch_plan(shape, O + 6)
            assert rec["admm_plan"]["build"] == qp_cuda.CLUSTER_BUILD, rec
            rec["check"] = loop_check(qp, cfg, qp.prepare(cfg, d.qp_inp).loop, planner.feas_tol,
                                      f"phase8g O={O}")
            builds.note_check(cfg, rec["check"])
        print(f"phase8g O={O}", json.dumps({k: v for k, v in rec.items() if k != "check"}))

    cfg0 = planner.stage_cfg
    check = {"entry": "neighbor_slots", "calls": 0, "elements": 0, "max_abs_err": 0.0,
             "wide": True}
    for A in P8G_SELECT[0]:
        pos = square_lattice(A, dev)
        for OA in P8G_SELECT[1]:
            for rng in (3.0, -1.0):
                cfg = dataclasses.replace(cfg0, OA=OA, comm_range=rng, cache={})
                got = stage_ops.neighbor_slots(pos, 1, cfg)
                want = stage_ops.neighbor_slots(pos, 1, cfg, plain=True)
                n = sum(differing(x, y) for x, y in zip(got, want))
                out["selection"][f"A={A} OA={OA} range={rng}"] = n
                assert n == 0, (A, OA, rng, n)
                if OA > 32:
                    check["calls"] += 1
                    check["elements"] += sum(x.numel() for x in got)
    torch.cuda.synchronize()
    builds.note_stage_check(check, "phase8g lattice")
    print("phase8g selection (differing elements)", json.dumps(out["selection"]))
    return out


# ---- phase 9: forest flights in the new modes ----------------------------
def phase9_flights():
    from lsc_dr_planner_tpu_torch.config import PlannerMode
    from lsc_dr_planner_tpu_torch.mission import ObstacleSpec

    dyn = [
        ObstacleSpec(type="spin", radius=0.2, max_acc=1.0, downwash=1.0,
                     axis_position=np.array([0.0, 0.0, 0.6]),
                     axis_ori=np.array([0.0, 0.0, 1.0]),
                     start=np.array([0.8, 0.0, 0.6]), speed=0.4),
        ObstacleSpec(type="straight", radius=0.15, max_acc=1.0, downwash=1.0,
                     start=np.array([-2.0, 1.5, 0.6]), goal=np.array([2.0, 1.5, 0.6]),
                     speed=0.3),
    ]
    # (tag, Param overrides, dynamic obstacles, max planner iterations)
    return (
        ("9a", dict(planner_mode=PlannerMode.DLSC, multisim_time_step=0.1), [], 600),
        ("9b", dict(world_dimension=3), [], 300),
        ("9c", dict(multisim_observer_stddev=0.03), dyn, 300),
    )


def fly(workload, qp, builds, dev, gpu, work, tag, overrides, obstacles, max_iter):
    from lsc_dr_planner_tpu_torch.config import Param
    from lsc_dr_planner_tpu_torch.mission import Mission
    from lsc_dr_planner_tpu_torch.ops import geometry, lsc, sfc
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

    m = workload.forest_mission(10)
    dim = overrides.get("world_dimension", 2)
    mpath, wpath = str(work / f"forest10_{tag}.json"), str(work / f"forest10_{tag}.csv")
    m.save(mpath)
    np.savetxt(wpath, m.world_boxes, delimiter=",")
    mission = Mission.load(mpath, world_file=wpath, world_dimension=dim, world_z_2d=0.6)
    mission.obstacles.extend(obstacles)
    param = Param(multisim_save_result=False, multisim_max_planner_iteration=max_iter,
                  **overrides)
    sim = MultiSyncSimulator(param, mission, log_dir=str(work), device=dev)
    ck_dir = work / f"phase{tag}"
    ck_dir.mkdir(exist_ok=True)
    builds.reset_launches()
    t0 = time.perf_counter()
    recorders = path_calls(sfc, lsc, geometry, every=25)
    sfcs, expands, clscs, hulls = recorders
    with sfcs, expands, clscs, hulls:
        r, cks = run_checkpointed(sim, max_iter, ck_dir, steps=CK9)
    wall = time.perf_counter() - t0
    d_goal = np.linalg.norm(sim.pos - sim.desired_goal, axis=-1)
    res = {"phase": tag, "agents": 10, "dim": dim, "O": sim.planner.O,
           "build": builds.name(sim.planner.qp_cfg, 10), "feas_tol": sim.planner.feas_tol,
           "planner_steps": sim.planner_seq, "flight_time_s": r["total_flight_time"],
           "agents_home": int((d_goal <= param.goal_threshold).sum()),
           "step_p50_ms": r["step_time_p50_ms"], "step_p99_ms": r["step_time_p99_ms"],
           "plan_p50_ms": r["planning_time_p50_ms"],
           "safety_ratio_agent": r["safety_ratio_agent"],
           "safety_ratio_obs": r["safety_ratio_obs"],
           "qp_convergence": r["qp_converged_mean"],
           "kernel_launches": builds.add_path_launches(), "wall_s": wall, "gpu": gpu}
    if sim.planner.timing:
        res["stage_ms_mean"] = stage_ms_mean(sim)
    print(f"phase{tag}", json.dumps(res))
    check_audit(r, f"phase {tag}")
    builds.assert_launched(res["kernel_launches"], f"phase {tag}", clsc=True,
                           sfc_hull=not sim.planner.substep)
    assert_one_launch_a_call(res["kernel_launches"], recorders, f"phase {tag}")
    if obstacles:
        assert r["safety_ratio_obs"] >= 1.0, res
    res["clsc_check"] = clsc_check(lsc, builds, clscs, f"phase{tag}")
    if sfcs.n:
        res["sfc_hull_check"] = sfc_hull_check(sfc, builds, sfcs, f"phase{tag}")
    else:
        res["sfc_check"] = sfc_check(sfc, builds, expands, f"phase{tag}")
    planner_k, qp_inp_k = step_qp(param, mission, sim, cks[0], str(work))
    cfg_k, tol_k = planner_k.qp_cfg, planner_k.feas_tol
    li_k = qp.prepare(cfg_k, qp_inp_k).loop
    res["kernel_check"] = loop_check(qp, cfg_k, li_k, tol_k,
                                     f"phase{tag} kernel, step after {Path(cks[0]).stem}")
    builds.note_check(cfg_k, res["kernel_check"])
    res["loop_timing"] = admm_timing.timed_call(qp, cfg_k, li_k, cfg_k.max_iter, tol_k,
                                                f"flight10_{tag}", 20)
    print(f"phase{tag} timing", json.dumps(res["loop_timing"]))
    return res


# ---- phase 10: the JAX package's small mode missions ---------------------
NO_HULL_MISSIONS = ("rsfc_crossing", "bvc")  # BVC and RSFC build no LSC rows


def prior_based_forest(dev, work):
    """PRIOR_BASED in forest_mission(10)'s world: every line-of-sight
    query asks the world's distance on the card."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.config import GoalMode, Param
    from lsc_dr_planner_tpu_torch.sim import mode_missions
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

    p = Param(goal_mode=GoalMode.PRIOR_BASED, communication_range=-1.0,
              multisim_max_planner_iteration=40, multisim_save_result=False)
    sim = MultiSyncSimulator(p, workload.forest_mission(10), log_dir=str(work), device=dev)
    res = sim.run()
    assert not res["is_collided"] and res["safety_ratio_agent"] >= 1.0, res
    assert sim.prior_goal_time.N == sim.planner_seq
    return {**mode_missions.summary(sim),
            "prior_goal_ms_p50": sim.prior_goal_time.percentile(50) * 1e3,
            "prior_goal_ms_max": sim.prior_goal_time.max * 1e3}


# ---- phase 11: local sensing ----------------------------------------------
LOCAL = dict(world_use_global_map=False, sensor_range=3.0)
# (tag, agents, mission seed, max planner iterations, checkpoints): (a)
# checks the kernel on the step after step 3, (b) reruns the steps after
# 1-3 on the CPU
LOCAL_FLIGHTS = (("11a", 10, 0, 300, (3,)), ("11b", 64, 1, 400, (1, 2, 3)))


def local_flight(workload, qp, builds, dev, gpu, work, tag, A, seed, max_iter, cks):
    """forest_mission(A, seed) flown to its goals in local-sensing mode by
    `MultiSyncSimulator.run` on the card, checkpointed after the planner
    steps `cks`: the audit, the kernels' launches, `sfc_hull_check` on
    the SFC updates of planner steps 1 and 26 (per-agent images) and
    `clsc_check` on the same steps' CLSC constructions, the maps each
    checkpoint restores (identical to the flight's at that step), and
    `loop_check` on the QP of the step after the last checkpoint.
    Returns (simulator, param, mission, checkpoint paths, record)."""
    from lsc_dr_planner_tpu_torch.config import Param
    from lsc_dr_planner_tpu_torch.ops import geometry, lsc, sfc
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

    mission = workload.forest_mission(A, seed)
    param = Param(multisim_save_result=False, multisim_max_planner_iteration=max_iter, **LOCAL)
    sim = MultiSyncSimulator(param, mission, log_dir=str(work), device=dev)
    mm = sim.map_manager
    ck_dir = work / f"phase{tag}"
    ck_dir.mkdir(exist_ok=True)
    snaps = {}

    def snap(path):
        snaps[path] = (mm.known.clone(), mm._version.copy())

    builds.reset_launches()
    t0 = time.perf_counter()
    recorders = path_calls(sfc, lsc, geometry, every=25)
    sfcs, expands, clscs, hulls = recorders
    with sfcs, expands, clscs, hulls, Calls(qp, "prepare", every=25) as preps:
        r, ck_paths = run_checkpointed(sim, max_iter, ck_dir, steps=cks, on_save=snap)
    wall = time.perf_counter() - t0
    d_goal = np.linalg.norm(sim.pos - sim.desired_goal, axis=-1)
    ms = {name: {"mean": t.average * 1e3, "p50": t.percentile(50) * 1e3, "n": t.N}
          for name, t in (("sense", sim.sense_time), ("merge", sim.merge_time),
                          ("local_map", sim.local_map_time))}
    res = {"phase": tag, "agents": A, "seed": seed, "O": sim.planner.O,
           "planner_steps": sim.planner_seq, "flight_time_s": r["total_flight_time"],
           "agents_home": int((d_goal <= param.goal_threshold).sum()),
           "step_p50_ms": r["step_time_p50_ms"], "step_p99_ms": r["step_time_p99_ms"],
           "plan_p50_ms": r["planning_time_p50_ms"],
           "min_pair_distance": min_pair_distance(sim),
           "safety_ratio_agent": r["safety_ratio_agent"], "qp_convergence": r["qp_converged_mean"],
           "known_cells": int(mm.union_occ().sum()), "true_cells": int(mm.occ_true.sum()),
           "grid": list(mm.occ_true.shape), "map_ms": ms,
           "kernel_launches": builds.add_path_launches(), "wall_s": wall, "gpu": gpu}
    if sim.planner.timing:
        res["stage_ms_mean"] = stage_ms_mean(sim)
        # the SFC stage without the per-agent integral images
        res["sfc_search_ms_mean"] = res["stage_ms_mean"]["sfc"] - ms["local_map"]["mean"]
    print(f"phase{tag}", json.dumps(res))
    check_audit(r, f"phase {tag}")
    builds.assert_launched(res["kernel_launches"], f"phase {tag}", clsc=True, sfc_hull=True)
    assert_one_launch_a_call(res["kernel_launches"], recorders, f"phase {tag}")
    res["sfc_hull_check"] = sfc_hull_check(sfc, builds, sfcs, f"phase{tag}")
    assert all(c["per_agent_images"] for c in res["sfc_hull_check"]), res["sfc_hull_check"]
    res["clsc_check"] = clsc_check(lsc, builds, clscs, f"phase{tag}")
    res["prepare_check"] = prepare_check(qp, builds.qp_prepare_cuda, builds, preps, f"phase{tag}")
    assert res["min_pair_distance"] >= 2 * 0.15 - sim.planner.feas_tol, res
    assert 0 < res["known_cells"] <= res["true_cells"], res
    assert sim.sense_time.N == sim.planner_seq and sim.merge_time.N == sim.planner_seq
    for path, (known, version) in snaps.items():
        s = MultiSyncSimulator(param, mission, log_dir=str(work), share_static_from=sim)
        s.load_checkpoint(path)
        assert torch.equal(s.map_manager.known, known), f"{tag}: {path} restores other maps"
        assert np.array_equal(s.map_manager._version, version), path
    res["checkpoints_restore_maps"] = len(snaps)
    planner_k, qp_inp_k = step_qp(param, mission, sim, ck_paths[-1], str(work))
    cfg_k, tol_k = planner_k.qp_cfg, planner_k.feas_tol
    res["kernel_check"] = loop_check(qp, cfg_k, qp.prepare(cfg_k, qp_inp_k).loop, tol_k,
                                     f"phase{tag} kernel, step after {Path(ck_paths[-1]).stem}")
    builds.note_check(cfg_k, res["kernel_check"])
    return sim, param, mission, ck_paths, res


# ---- phase 12: Monte-Carlo scenario batching --------------------------------
# The noise-free scenario reaches its goals in about 117 iterations; every
# noisy one has a goal pushed past the world's edge by Mission.add_noise's
# one-sided offset and never finishes, so 150 iterations see the outcome
MC_S, MC_NOISE, MC_MAX_ITER = 8, 0.25, 150
MC_CHECK_IT = 4  # loop_check on this iteration's flattened QP and its rescue
MC_BIG_S, MC_BIG_STEPS = 40, 5


def montecarlo_run(workload, qp, builds, dev, gpu, work):
    """(a) MC_S scenarios of forest_mission(64, seed=1) until every one
    finishes or MC_MAX_ITER iterations pass: every scenario's audit, the
    scenarios that arrive and the agents home in each, per step the phase
    times, scenario·agent-steps/s and QP convergence, and
    `loop_check` on one step's flattened QP and its compacted rescue;
    `sfc_hull_check` and `clsc_check` on the SFC updates and CLSC
    constructions of iterations 0 and 50."""
    from lsc_dr_planner_tpu_torch.config import Param
    from lsc_dr_planner_tpu_torch.ops import geometry, lsc, sfc
    from lsc_dr_planner_tpu_torch.sim.montecarlo import MonteCarloSimulator

    param = Param(multisim_save_result=False, multisim_max_planner_iteration=MC_MAX_ITER)
    mc = MonteCarloSimulator(param, workload.forest_mission(64, 1), n_scenarios=MC_S,
                             max_noise=MC_NOISE, log_dir=str(work), device=dev)
    A = mc.sims[0].A
    res = {"S": MC_S, "A": A, "max_noise": MC_NOISE, "gpu": gpu}
    steps, before = [], {}
    recorders = path_calls(sfc, lsc, geometry, every=50)
    sfcs, expands, clscs, hulls = recorders
    check_calls = [0] * len(recorders)
    builds.reset_launches()
    t_run = time.perf_counter()
    with sfcs, expands, clscs, hulls, Calls(qp, "prepare", every=50) as preps:
        for it in range(MC_MAX_ITER):
            if all(sim.is_finished() for sim in mc.sims):
                break
            t0 = time.perf_counter()
            prep = mc.prepare_step(it)
            if it == MC_CHECK_IT:
                # the kernel against the plain loop on this step's batch; its
                # launches, and chunk_qp's hull query, are not the path's
                before = builds.add_path_launches()
                t_check, n0 = time.perf_counter(), [r.n for r in recorders]
                _, batch, B = prep
                cfg, tol = mc.planner.qp_cfg, mc.planner.feas_tol
                li = qp.prepare(cfg, mc.chunk_qp(batch, 0, min(B, 32)).qp_inp).loop
                res["kernel_check"] = loop_check(qp, cfg, li, tol,
                                                 f"phase12a kernel, A={len(li.xi)}")
                builds.note_check(cfg, res["kernel_check"])
                xi, z, y = qp.run_loop(cfg, li, cfg.max_iter, tol)[:3]
                sub = qp.rescue_batch(cfg, li, xi, z, y, tol)[2]
                res["rescue_check"] = loop_check(qp, cfg, sub, tol, "phase12a rescue",
                                                 max_iter=cfg.rescue_iter)
                builds.note_check(cfg, res["rescue_check"])
                res["loop_timing"] = admm_timing.timed_call(qp, cfg, li, cfg.max_iter, tol,
                                                            f"montecarlo{len(li.xi)}", 10)
                res["loop_timing"]["plain_ms"] = cuda_ms(
                    lambda: qp.admm_loop_plain(cfg, li, cfg.max_iter, tol), 2)
                print("phase12a timing", json.dumps(res["loop_timing"]), f"[{gpu}]")
                builds.reset_launches()
                check_calls = [r.n - n for r, n in zip(recorders, n0)]
                t0 += time.perf_counter() - t_check
            mc.plan_prepared(*prep)
            wall = time.perf_counter() - t0
            pt = {k: (round(v * 1e3, 3) if k != "n_active" else v)
                  for k, v in mc.phase_times.items()}
            rec = {"it": it, **pt, "wall_ms": round(wall * 1e3, 3),
                   "sa_steps_per_s": pt["n_active"] * A / wall,
                   "qp_convergence": mc.last_qp_convergence,
                   "peak_mib": [round(b / 2**20, 1) for b in mc.chunk_peak_bytes]}
            if mc.planner.timing and (it == 2 or it % 25 == 0):
                rec["stage_ms"] = mc.planner.stage_times_ms()
            print("phase12a step", json.dumps(rec))
            steps.append(rec)
    res["wall_s"] = time.perf_counter() - t_run
    after = builds.add_path_launches()
    res["kernel_launches"] = {k: before.get(k, 0) + after.get(k, 0)
                              for k in before.keys() | after.keys()}
    results = [sim.summary() for sim in mc.sims]
    world_min, world_max = mc.sims[0].mission.world_min, mc.sims[0].mission.world_max
    res["agents_home"] = [int((np.linalg.norm(sim.pos - sim.desired_goal, axis=-1)
                               <= param.goal_threshold).sum()) for sim in mc.sims]
    res["goals_outside_world"] = [
        int(((sim.desired_goal[:, :2] < world_min[:2]) | (sim.desired_goal[:, :2] > world_max[:2]))
            .any(axis=1).sum()) for sim in mc.sims]
    for s, r in enumerate(results):
        assert not r["is_collided"] and r["safety_ratio_agent"] >= 1.0, (s, r)
        assert r["vel_excess_ratio"] == 0.0 and r["acc_excess_ratio"] == 0.0, (s, r)
        assert r["mapf_backend"] == "native", (s, r)
    conv = [r["qp_convergence"] for r in steps]
    walls = np.asarray([r["wall_ms"] for r in steps])
    res.update(
        iterations=len(steps), arrived=sum(bool(np.isfinite(r["total_flight_time"]))
                                           for r in results),
        flight_time_s=[r["total_flight_time"] for r in results],
        safety_ratio_agent_min=min(r["safety_ratio_agent"] for r in results),
        qp_convergence_min=min(conv), qp_convergence_mean=float(np.mean(conv)),
        step_p50_ms=float(np.percentile(walls, 50)), step_p99_ms=float(np.percentile(walls, 99)),
        sa_steps_per_s=float(sum(r["n_active"] for r in steps) * A / (walls.sum() / 1e3)),
        phase_ms_mean={k: float(np.mean([r[k] for r in steps]))
                       for k in ("host", "stack", "device", "apply")},
        peak_mib_max=max((b for r in steps for b in r["peak_mib"]), default=None),
        steps=steps)
    print("phase12a", json.dumps({k: v for k, v in res.items()
                                  if k not in ("steps", "kernel_check", "rescue_check")}))
    builds.assert_launched(res["kernel_launches"], "phase 12a", clsc=True, sfc_hull=True)
    assert res["kernel_check"]["A"] == MC_S * A, res["kernel_check"]["A"]
    got = tuple(res["kernel_launches"][k] for k in ("sfc_update_hull", "sfc_expand",
                                                    "clsc_build", "hull_closest"))
    assert got == tuple(r.n - c for r, c in zip(recorders, check_calls)), (got, check_calls)
    res["sfc_hull_check"] = sfc_hull_check(sfc, builds, sfcs, "phase12a")
    assert res["sfc_hull_check"][0]["lanes"] == 3 * MC_S * A, res["sfc_hull_check"]
    res["clsc_check"] = clsc_check(lsc, builds, clscs, "phase12a")
    res["prepare_check"] = prepare_check(qp, builds.qp_prepare_cuda, builds, preps, "phase12a")
    return res


def montecarlo_chunks(workload, builds, dev, gpu, work):
    """(b) MC_BIG_S scenarios for MC_BIG_STEPS steps: two chunks (32, then
    8 padded to 32, as the JAX package pads), every output finite; the
    card's peak memory per chunk."""
    from lsc_dr_planner_tpu_torch.config import Param
    from lsc_dr_planner_tpu_torch.sim.montecarlo import MonteCarloSimulator

    param = Param(multisim_save_result=False)
    mc = MonteCarloSimulator(param, workload.forest_mission(64, 1), n_scenarios=MC_BIG_S,
                             max_noise=MC_NOISE, log_dir=str(work), device=dev)
    builds.reset_launches()
    steps = []
    for it in range(MC_BIG_STEPS):
        t0 = time.perf_counter()
        mc.step(it)
        steps.append({"it": it, "wall_ms": (time.perf_counter() - t0) * 1e3,
                      **{k: v for k, v in mc.phase_times.items()},
                      "qp_convergence": mc.last_qp_convergence,
                      "peak_mib": [b / 2**20 for b in mc.chunk_peak_bytes]})
        print("phase12b step", json.dumps(steps[-1]))
        assert mc.phase_times["n_active"] == MC_BIG_S, mc.phase_times
        # two chunks: 32 scenarios, then 8 padded to 32
        assert len(mc.chunk_peak_bytes) == (2 if mc.device.type == "cuda" else 0)
        for sim in mc.sims:
            for name in ("pos", "vel", "acc", "desired_ctrl", "current_goal", "qp_y"):
                assert np.isfinite(getattr(sim, name)).all(), (it, name)
    res = {"S": MC_BIG_S, "A": mc.sims[0].A, "steps": steps,
           "peak_mib_per_chunk": [max(s["peak_mib"][c] for s in steps)
                                  for c in range(len(mc.chunk_peak_bytes))],
           "kernel_launches": builds.add_path_launches(), "gpu": gpu}
    print("phase12b", json.dumps({k: v for k, v in res.items() if k != "steps"}))
    builds.assert_launched(res["kernel_launches"], "phase 12b", clsc=True, sfc_hull=True)
    return res


# ---- phase 13: multi-device runtime, debug step, replay ----------------------
P13_WARMUP, P13_REPS = 3, 3  # evolving steps before phase 13's state; timed calls


def max_diffs(ref, out):
    """Per field of two StepOutputs, the largest |difference|."""
    return {f.name: float((getattr(out, f.name).double() - getattr(ref, f.name).double())
                          .abs().max().item())
            for f in dataclasses.fields(ref) if getattr(ref, f.name) is not None}


def assert_step_close(ref, out, what):
    """tests/test_parallel.py's `_tree_allclose` (rtol 1e-4 / atol 2e-4;
    the loop's exit chunk, residual and duals skipped)."""
    for f in dataclasses.fields(ref):
        if f.name in ("qp_iterations", "qp_residual", "qp_y"):
            continue
        a, b = getattr(out, f.name), getattr(ref, f.name)
        if a.dtype in (torch.bool, torch.int32, torch.int64):
            assert torch.equal(a, b), (what, f.name)
        else:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-4, msg=f"{what}: {f.name}")


def stash_tensors(dbg):
    """Every tensor of the planner's debug stash, by key."""
    out = {}
    for k, v in dbg.items():
        if torch.is_tensor(v):
            out[k] = v
        else:
            out.update({f"{k}.{f.name}": getattr(v, f.name) for f in dataclasses.fields(v)})
    return out


def phase13(workload, builds, dev, gpu, work, sim6):
    """(a) A one-rank NCCL group runs the all-gather step and the halo
    step at A=1024: each equal to the unsharded step on the same inputs,
    each launching the ADMM kernel; the scaling harness's one-rank row.
    (b) The debug step: every stash tensor finite and on the card, the
    outputs those of the normal step. (c) `read_csv` on phase 6's CSV.
    (d) Rendering needs matplotlib, which this machine lacks: the debug
    frame raises the ImportError and draws nothing."""
    import importlib.util

    import torch.distributed as dist

    from lsc_dr_planner_tpu_torch.parallel import halo, mesh, scaling
    from lsc_dr_planner_tpu_torch.sim import replay

    res = {"A": A_MAIN, "gpu": gpu}
    init = work / "phase13_group"
    init.unlink(missing_ok=True)
    group = mesh.init_group(dev, 0, 1, f"file://{init}")
    try:
        # NCCL on the card (gloo only where the device is the CPU)
        assert dist.get_backend(group) == ("nccl" if dev.type == "cuda" else "gloo")
        p, planner, fleet, inp = workload.build_fleet(A_MAIN, device=dev)
        step = workload.make_evolve_step(p, planner, fleet)
        for _ in range(P13_WARMUP):  # a state with previous solutions
            inp, _ = step(inp)
        ref = planner._step_impl(fleet, inp)
        ms = {"unsharded": cuda_ms(lambda: planner._step_impl(fleet, inp), P13_REPS)}

        # (a) the all-gather step, then the halo step on the sorted fleet
        sharded = mesh.make_sharded_step(planner, group)
        perm = torch.as_tensor(halo.spatial_permutation(inp.pos.cpu().numpy()), device=dev)
        fleet_p, inp_p = halo.permute_agents(fleet, inp, perm)
        hops = halo.required_hops(inp_p.pos.cpu().numpy(), 1, p.communication_range)
        halo_step = halo.make_halo_step(planner, group, hops)
        ref_p = planner._step_impl(fleet_p, inp_p)
        res["hops"] = hops
        for name, fn, want, (f, i) in (("allgather", sharded, ref, (fleet, inp)),
                                        ("halo", halo_step, ref_p, (fleet_p, inp_p))):
            f_l, i_l = mesh.shard_step_inputs(f, i, 0, 1)
            builds.reset_launches()
            out = mesh.gather_outputs(fn(f_l, i_l), group)
            torch.cuda.synchronize()
            launches = builds.add_path_launches()
            diffs = max_diffs(want, out)
            print(f"phase13 {name}: kernel launches {launches}, largest difference from the "
                  f"unsharded step {json.dumps(diffs)}")
            builds.assert_launched(launches, f"phase 13 {name}", clsc=True, sfc_hull=True,
                                   neighbors=False)
            assert_step_close(want, out, f"phase13 {name}")
            ms[name] = cuda_ms(lambda: mesh.gather_outputs(fn(f_l, i_l), group), P13_REPS)
            res[name] = {"kernel_launches": launches, "max_diff": diffs}
        res["step_ms"] = ms
        print("phase13 step ms", json.dumps(ms), f"[{gpu}]")
        rows = scaling.measure_scaling(device_counts=(1,), A_per_device=A_MAIN,
                                       steps=P13_REPS, device=dev, group=group)
        assert [r["devices"] for r in rows] == [1], rows
        print("phase13 scaling", json.dumps(rows), f"[{gpu}]")
        res["scaling"] = rows
    finally:
        dist.destroy_process_group()

    # (b) the debug step on the card
    planner.debug = True
    out = planner._step_impl(fleet, inp)
    stash = stash_tensors(planner._dbg)
    for k, t in stash.items():
        assert t.device.type == dev.type, (k, t.device)
        assert t.dtype == torch.bool or torch.isfinite(t).all(), k
    ms_dbg = cuda_ms(lambda: planner._step_impl(fleet, inp), P13_REPS)
    planner.debug = False
    diffs = max_diffs(ref, out)
    assert_step_close(ref, out, "phase13 debug step")
    ms_plain = cuda_ms(lambda: planner._step_impl(fleet, inp), P13_REPS)
    res["debug"] = {"stash_tensors": len(stash), "max_diff": diffs, "ms": ms_dbg,
                    "ms_normal": ms_plain}
    print(f"phase13 debug step: {len(stash)} stash tensors on the card, finite; largest "
          f"difference from the normal step {max(diffs.values()):.3e}; "
          f"{ms_dbg:.2f} ms against {ms_plain:.2f} ms [{gpu}]")

    # (c) phase 6's simulation CSV read back
    path = Path(sim6.log_dir) / f"simulation_{sim6.mission_start_time}_{sim6.file_name_param}.csv"
    log = replay.read_csv(str(path))
    hist = np.stack(sim6.traj_history)
    assert log.agent_states.shape[:2] == hist.shape[:2], (log.agent_states.shape, hist.shape)
    np.testing.assert_allclose(log.agent_states[:, :, :3], hist, rtol=1e-5, atol=1e-6)
    last = int(np.nonzero(np.isclose(log.times, sim6.sim_time))[0][-1])
    np.testing.assert_allclose(log.agent_states[last, :, :3], sim6.pos, rtol=1e-5, atol=1e-6)
    res["csv"] = {"rows": len(log.times), "agents": log.qn, "t_end": float(log.times[-1])}
    print("phase13 csv", json.dumps(res["csv"]))

    # (d) no matplotlib on this machine: the frame raises and draws nothing
    assert importlib.util.find_spec("matplotlib") is None
    frame = work / "phase13_frame.png"
    seq = sim6.planner_seq
    try:
        replay.render_debug_frame(sim6, str(frame))
        raise AssertionError("render_debug_frame rendered without matplotlib")
    except ImportError as e:
        assert "matplotlib" in str(e), e
    assert not frame.exists() and sim6.planner_seq == seq
    return res


# ---- phase 14: the tools -----------------------------------------------------
P14_SFC_SIZES, P14_SFC_CLAMPS, P14_SFC_REPS = "128,1024", "30,70", 3
P14_QP_STEPS = 12  # DLSC sub-step steps of qp_forensics at A=1024
P14_MC_A, P14_MC_S, P14_MC_STEPS = 1024, 8, 2
P14_MC_CHECK_IT = P14_MC_STEPS + 1  # loop_check on the QP of the iteration after them
P14_SMOKE_A, P14_SMOKE_ITER = 256, 15
# fuzz cases of the JAX package's slow test (tests/test_sim.py), 8 agents;
# the second runs if phase 14 has used less than P14_SECOND_FUZZ_S by then
P14_FUZZ = ((2001, "hybrid"), (2002, "mcp"))
P14_SECOND_FUZZ_S = 110.0


def phase14(qp, builds, dev, gpu, work):
    """The port's tools on the card, each through its own entry point:
    (a) sfc_bench at A = 128 and 1024, clamps 30 and 70, the plain loop
    and the kernel: trips, syncs, launches per call and per trip, kernel
    ms and bound; (b) qp_forensics at A=1024 in DLSC sub-step; (c)
    mc_pod_bench at A=1024, S=8 (one chunk of 8,192 agents), and
    `loop_check` on the next iteration's batch; (d) scale_demo's 256-agent
    smoke run; (e) dlsc_openworld's circle8; (f) fuzz_missions's cases
    2001 (hybrid) and, time allowing, 2002 (mcp) at 8 agents. (a) must
    launch the SFC kernel; (b)-(f) the ADMM kernel, and the SFC kernel
    where their world has a map ((c) and (e) fly open worlds with
    world_use_octomap off: no SFC update); each passes its audit."""
    from lsc_dr_planner_tpu_torch.config import PlannerMode
    from lsc_dr_planner_tpu_torch.ops import lsc
    from lsc_dr_planner_tpu_torch.tools import (
        dlsc_openworld, fuzz_missions, mc_pod_bench, qp_forensics, scale_demo, sfc_bench,
    )

    t0 = time.perf_counter()
    res = {"gpu": gpu}

    def launched(what, sfc=True, **fused):
        launches = builds.add_path_launches()
        print(f"phase14 {what}: kernel launches {json.dumps(launches)}")
        builds.assert_launched(launches, f"phase 14 {what}", sfc, **fused)
        return launches

    # (a) the SFC update alone, plain loop and kernel
    builds.reset_launches()
    rows = sfc_bench.main(["--sizes", P14_SFC_SIZES, "--clamps", P14_SFC_CLAMPS,
                           "--reps", str(P14_SFC_REPS), "--device", dev.type])
    launches = builds.add_path_launches()
    print(f"phase14 sfc_bench: kernel launches {json.dumps(launches)}")
    assert launches["sfc_update_hull"] > 0, "phase 14 sfc_bench never launched the SFC kernel"
    for r in rows:
        assert 0 < r["longest_lane_trips"] <= 6 * r["clamp"] + 6, r
        assert r["longest_lane_trips_read"] == r["longest_lane_trips"], r
        assert np.isfinite(r["sfc_ms"]) and (r["launches_per_call"] or dev.type != "cuda"), r
        if r["path"] == "plain":
            assert 0 < r["trips"] <= 6 * r["clamp"] + 6, r
            assert r["syncs"] == -(-min(r["trips"] + 1, 6 * r["clamp"] + 6) // 8), r
        else:
            assert r["trips"] == r["syncs"] == 0 and r["kernel_launches_per_call"] == 1, r
    assert [r["path"] for r in rows] == ["plain", "kernel"] * (len(rows) // 2), rows
    res["sfc_bench"] = rows

    # (b) QP forensics in DLSC sub-step
    builds.reset_launches()
    rows = qp_forensics.run(A_MAIN, P14_QP_STEPS, dev, planner_mode=PlannerMode.DLSC,
                            multisim_time_step=0.1)
    steps = [r for r in rows if "step" in r]
    assert len(steps) == P14_QP_STEPS and all(r["conv_rate"] > 0.9 for r in steps), rows
    resolved = [r for r in rows if "note" in r]
    if steps[-1]["n_bad"]:
        (r,) = resolved
        assert r["still_bad"] <= steps[-1]["n_bad"], r
    else:
        print(f"phase14 qp_forensics: no agent failed at the last step ({P14_QP_STEPS}); "
              "nothing to re-solve")
    res["qp_forensics"] = {"rows": rows, "kernel_launches": launched("qp_forensics", clsc=True)}

    # (c) Monte-Carlo pod slice: S=8 scenarios of 1024 agents
    mc, built_s = mc_pod_bench.build(P14_MC_S, mc_pod_bench.pod_mission(P14_MC_A),
                                     mc_pod_bench.pod_param(), dev, str(work / "mc_pod"))
    builds.reset_launches()
    with Calls(lsc, "build_clsc", keep=1) as clscs, Calls(qp, "prepare", keep=1) as preps:
        row = mc_pod_bench.measure(mc, P14_MC_STEPS, built_s, gpu)
    print("phase14 mc_pod_bench", json.dumps(row))
    launches = launched("mc_pod_bench", sfc=False, clsc=True)  # an open world: no SFC
    clsc_pod = clsc_check(lsc, builds, clscs, "phase14 mc_pod_bench")
    assert clsc_pod[0]["agents"] == P14_MC_S * P14_MC_A, clsc_pod
    prep_pod = prepare_check(qp, builds.qp_prepare_cuda, builds, preps, "phase14 mc_pod_bench")
    assert prep_pod[0]["agents"] == P14_MC_S * P14_MC_A, prep_pod
    assert row["qp_convergence_min"] > 0.9, row
    assert len(row["chunk_peak_bytes"]) == (1 if dev.type == "cuda" else 0), row
    for s, sim in enumerate(mc.sims):
        r = sim.summary()
        assert not r["is_collided"] and r["safety_ratio_agent"] >= 1.0, (s, r)
        assert r["vel_excess_ratio"] == 0.0 and r["acc_excess_ratio"] == 0.0, (s, r)
        for name in ("pos", "vel", "acc", "desired_ctrl", "current_goal", "qp_y"):
            assert np.isfinite(getattr(sim, name)).all(), (s, name)
    # the kernel against the plain loop on the next iteration's flattened batch
    _, batch, B = mc.prepare_step(P14_MC_CHECK_IT)
    cfg, tol = mc.planner.qp_cfg, mc.planner.feas_tol
    li = qp.prepare(cfg, mc.chunk_qp(batch, 0, B).qp_inp).loop
    check = loop_check(qp, cfg, li, tol, f"phase14 mc_pod_bench kernel, A={len(li.xi)}")
    assert check["A"] == P14_MC_S * P14_MC_A, check["A"]
    builds.note_check(cfg, check)
    res["mc_pod_bench"] = {"row": row, "kernel_launches": launches, "kernel_check": check,
                           "clsc_check": clsc_pod, "prepare_check": prep_pod,
                           "peak_mib_per_chunk": [b / 2**20 for b in row["chunk_peak_bytes"]]}
    del mc, batch, li, preps, prep_pod

    # (d) the 256-agent scaled-forest smoke run
    builds.reset_launches()
    row = scale_demo.run_scale(P14_SMOKE_A, P14_SMOKE_ITER, False, str(work / "scale"), dev)
    print("phase14 scale_demo", json.dumps(row))
    assert row["steps"] == P14_SMOKE_ITER and not row["collided"] and not row["qp_failed"], row
    assert row["safety_ratio_agent"] >= 1.0, row
    res["scale_demo"] = {"row": row, "kernel_launches": launched("scale_demo", clsc=True,
                                                                 sfc_hull=True)}

    # (e) DLSC open world: the 8-agent circle swap
    builds.reset_launches()
    r = dlsc_openworld.run_one(dlsc_openworld.circle_mission(8, 0.22 * 8 + 1.8, seed=8),
                               "circle8", device=dev, log_dir=str(work / "dlsc_open"))
    keys = ("total_flight_time", "planner_seq", "safety_ratio_agent", "is_collided",
            "qp_failed", "vel_excess_ratio", "acc_excess_ratio", "wall_s", "success")
    print("phase14 dlsc_openworld circle8", json.dumps({k: r[k] for k in keys}))
    assert r["success"], r
    res["dlsc_openworld"] = {**{k: r[k] for k in keys},
                             "kernel_launches": launched("dlsc_openworld circle8", sfc=False)}

    # (f) fuzz cases the JAX package holds to be clean
    res["fuzz_missions"] = []
    for i, (seed, layer) in enumerate(P14_FUZZ):
        if i and time.perf_counter() - t0 > P14_SECOND_FUZZ_S:
            print(f"phase14 fuzz_missions: case {seed} {layer} left out (time)")
            break
        builds.reset_launches()
        r = fuzz_missions.run_case(seed, layer, A=8, device=dev,
                                   log_dir=str(work / "fuzz"))
        keys = ("seed", "layer", "A", "kind", "total_flight_time", "planner_seq",
                "safety_ratio_agent", "is_collided", "qp_failed", "wall_s", "clean")
        print("phase14 fuzz_missions", json.dumps({k: r.get(k) for k in keys}))
        assert "skip" not in r and r["clean"], r
        res["fuzz_missions"].append({**{k: r[k] for k in keys},
                                     "kernel_launches": launched(f"fuzz {seed} {layer}")})
    return res


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures the port on a GPU")
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.ops import (
        cuda_build, geometry, hull_cuda, lsc, qp, qp_cuda, qp_prepare_cuda, sfc, sfc_cuda,
        step_cuda,
    )
    from lsc_dr_planner_tpu_torch.planner import stages as stage_ops

    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    record = {"gpu": gpu}

    # ---- 1. environment ----------------------------------------------
    nvcc = sh([cuda_build.nvcc_path(), "--version"]).splitlines()[-1]
    env = {"torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": nvcc,
           "python": sys.version.split()[0], "gpu": gpu}
    print("env", json.dumps(env))
    record["env"] = env

    walls = record["phase_wall_s"] = {}
    t_phase = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        walls[name] = now - t_phase[0]
        t_phase[0] = now
        print(f"phase {name} wall {walls[name]:.1f} s", flush=True)

    # ---- 2. kernel builds: one nvcc per source, all at once ------------
    t0 = time.perf_counter()
    wrappers = (qp_cuda, sfc_cuda, hull_cuda, qp_prepare_cuda, step_cuda)
    with ThreadPoolExecutor(len(wrappers)) as pool:  # each build waits on its own nvcc process
        for done in [pool.submit(w.build, True) for w in wrappers]:
            done.result()
    build_s = time.perf_counter() - t0
    nvcc_s = {name: sec for name, (sec, _) in cuda_build.build_log.items()}
    print(f"build admm.cu, sfc_expand.cu, hull_closest.cu, qp_prepare.cu, step_stages.cu: "
          f"{build_s:.2f} s "
          f"(nvcc {json.dumps(nvcc_s)})")
    record["build_s"] = build_s
    record["nvcc_s"] = nvcc_s
    record["ptxas"] = {name: log for name, (_, log) in cuda_build.build_log.items()}
    kernels_ptxas = {k: v for _, log in record["ptxas"].items()
                     for k, v in ptxas_summary(log).items()}
    print("ptxas", json.dumps(kernels_ptxas))
    builds = Builds(qp, qp_cuda, sfc_cuda, hull_cuda, geometry, lsc, sfc, dev, qp_prepare_cuda,
                    stage_ops, step_cuda)
    print("builds", json.dumps(list(builds.rec)))
    l2_ns = sfc_cuda.l2_round_trip_ns(dev)
    print(f"one L2 round trip (sfc_cuda.l2_round_trip_ns): {l2_ns:.1f} ns [{gpu}]")
    record["l2_round_trip_ns"] = l2_ns
    phase_done("1-2")

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
    builds.build_rec(cfg, A_MAIN)["max_abs_err"] = max_abs_err

    # many chunks, global exit before max_iter (A=37: no block multiple)
    cfg37, qp_inp37, tol37 = admm_timing.bench_qp(workload, 37, dev)
    rec = loop_check(qp, cfg37, qp.prepare(cfg37, qp_inp37).loop, tol37, "phase3 A=37")
    assert rec["kernel_exit"] < cfg37.max_iter, f"A=37 should exit before {cfg37.max_iter}"
    assert rec["share_of_tolerance"] <= 1.0, rec  # the whole run, within one tolerance
    builds.note_check(cfg37, rec)
    record["phase3"]["A37"] = rec

    # loop-only times of this batch and of its rescue, occupancy,
    # per-launch cost
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
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
    builds.note_timing(cfg, bench, ms_plain)
    phase_done("3")

    # ---- 4. full solve, kernel vs plain --------------------------------
    # (a) the loops on the same preparation (the kernel's): the ADMM
    # kernel's contract; (b) the kernel path (the preparation kernel and the
    # loop kernel) against qp.solve(plain=True) (the plain body and the
    # plain loop)
    record["phase4"] = {}
    prepare_kernel = qp.prepare

    def plain_loop_on_kernel_preparation(cfg, qp_inp, feas_tol):
        qp.prepare = lambda c, i, plain=False: prepare_kernel(c, i)
        try:
            return qp.solve(cfg, qp_inp, feas_tol, plain=True)
        finally:
            qp.prepare = prepare_kernel

    for A in (A_MAIN, 1000):
        if A != A_MAIN:
            cfg, qp_inp, feas_tol = admm_timing.bench_qp(workload, A, dev)
        out = qp.solve(cfg, qp_inp, feas_tol)
        pr = qp.prepare(cfg, qp_inp)
        rec = {}
        for key, ref in (("same_preparation", plain_loop_on_kernel_preparation(cfg, qp_inp,
                                                                               feas_tol)),
                         ("plain_path", qp.solve(cfg, qp_inp, feas_tol, plain=True))):
            both = out.converged & ref.converged
            # objectives of both solutions evaluated in float64: the float32
            # objective of agents ~20 m from the origin carries ~1e-2 relative
            # cancellation noise even for identical control points
            obj_k = qp.objective(cfg, pr, out.x.double())
            obj_p = qp.objective(cfg, pr, ref.x.double())
            r = rec[key] = {
                "converged_kernel": out.converged.float().mean().item(),
                "converged_plain": ref.converged.float().mean().item(),
                "max_obj_err": (obj_k - obj_p).abs()[both].max().item(),
                "max_obj_err_f32": (out.objective - ref.objective).abs()[both].max().item(),
                "max_dx": (out.x - ref.x).abs()[both].max().item()}
            assert torch.isfinite(ref.x).all(), key
            assert r["converged_kernel"] >= r["converged_plain"] - 0.005, (key, r)
            torch.testing.assert_close(obj_k[both], obj_p[both], rtol=2e-2, atol=2e-2)
            assert r["max_dx"] < 0.1, (key, r)
        rec["solve_ms_kernel"] = cuda_ms(lambda: qp.solve(cfg, qp_inp, feas_tol), 3)
        rec["solve_ms_plain"] = cuda_ms(lambda: qp.solve(cfg, qp_inp, feas_tol, plain=True), 2)
        print(f"phase4 A={A}", json.dumps(rec), f"[{gpu}]")
        assert torch.isfinite(out.x).all()
        record["phase4"][A] = rec

    phase_done("4")

    # ---- 5. main path --------------------------------------------------
    p, planner, fleet, inp = workload.build_fleet(A_MAIN, device=dev, timing=True)
    step = workload.make_evolve_step(p, planner, fleet)
    for _ in range(WARMUP):
        inp, conv = step(inp)
    torch.cuda.synchronize()
    builds.reset_launches()
    sfc.reset_counts()
    dists = []
    # the step's stage entries, recorded from here to phase 14's end, each
    # phase's calls held to the plain bodies (`stage_checks`)
    stage_stack = contextlib.ExitStack()
    srec = stage_recorders(stage_ops)
    for r in srec:
        stage_stack.enter_context(r)
    restart(srec, TIMED // 2)

    states = [inp]  # each timed step's input state, for `unconverged_steps`

    def check(inp):
        assert inp.prev_ctrl.shape == (A_MAIN, p.M, p.n + 1, 3), inp.prev_ctrl.shape
        for name in ("pos", "vel", "acc", "prev_ctrl", "current_goal", "qp_y0"):
            assert torch.isfinite(getattr(inp, name)).all(), name
        dists.append(min_pair_distance_now(inp.pos, 2, 1.0))
        states.append(inp)

    recorders = path_calls(sfc, lsc, geometry, every=TIMED // 2)
    sfcs, expands, clscs, hulls = recorders
    with sfcs, expands, clscs, hulls, Calls(qp, "prepare", every=TIMED // 2) as preps:
        inp, lat, stages, convs = admm_timing.timed_steps(step, planner, inp, TIMED, check)
    min_dist = min(dists)
    launches = builds.add_path_launches()
    lane_trips = sfc.read_lane_trips()
    lat = np.asarray(lat)
    conv_mean = float(np.mean(convs))
    stage_ms = admm_timing.mean_stages(stages)
    main = {"A": A_MAIN, "steps": TIMED, "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "agent_steps_per_s": A_MAIN * TIMED / float(lat.sum()),
            "qp_convergence": conv_mean, "min_pair_distance": min_dist,
            "kernel_launches": launches, "stage_ms": stage_ms, "gpu": gpu,
            "qp_convergence_per_step": convs,
            "calls": {"update_sfc_hull": sfcs.n, "expand_box": expands.n,
                      "build_clsc": clscs.n, "hull_query": hulls.n},
            "sfc_trips_per_step": lane_trips / TIMED, "sfc_syncs_per_step": sfc.syncs / TIMED,
            "sfc_plain_trips": sfc.trips}
    print("main path", json.dumps(main))
    builds.assert_launched(launches, "the main path", clsc=True, sfc_hull=True)
    # one launch a CLSC construction, a 'hull' SFC update and a stage entry,
    # every step
    assert_one_launch_a_call(launches, recorders, "the main path", srec)
    assert sfcs.n == clscs.n == TIMED and expands.n == hulls.n == 0, main["calls"]
    # the neighbour selection inside the prediction's launch
    assert [r.n for r in srec] == [0, 0, TIMED, TIMED], [(r.name, r.n) for r in srec]
    main["stage_checks"] = stage_checks(builds, srec, "phase5")
    main["stage_timing"] = stage_timing(builds, srec, gpu, "phase5")
    # the same path with the selection and the prediction as two launches
    # (`separate_launches`), SEPARATE_STEPS steps on
    builds.reset_launches()
    restart(srec, 1)
    sep_inp = inp
    with separate_launches(stage_ops):
        for _ in range(SEPARATE_STEPS):
            sep_inp, _ = step(sep_inp)
    sep_launches = builds.add_path_launches()
    builds.assert_launched(sep_launches, "the main path, separate launches", clsc=True,
                           sfc_hull=True)
    assert [sep_launches[r.name] for r in srec] == [r.n for r in srec] == [
        SEPARATE_STEPS, SEPARATE_STEPS, 0, SEPARATE_STEPS], [(r.name, r.n) for r in srec]
    main["separate"] = {"steps": SEPARATE_STEPS,
                        "stage_checks": stage_checks(builds, srec, "phase5 separate"),
                        "stage_timing": stage_timing(builds, srec[:2], gpu, "phase5 separate")}
    # one launch of the QP preparation kernel a step
    assert preps.n == launches["qp_prepare"] == TIMED, (preps.n, launches["qp_prepare"])
    assert sfc.syncs == 0 and sfc.trips == 0, "the main path's SFC stage ran the plain loop"
    assert lane_trips > 0, "the fused SFC kernel added no trips to the device counter"
    assert conv_mean > 0.9, conv_mean
    assert min_dist >= 2 * 0.15 - planner.feas_tol, min_dist
    main["unconverged_steps"] = unconverged_steps(qp, planner, fleet, states[:-1], convs,
                                                 out_dir)
    print("phase5 unconverged steps", json.dumps(main["unconverged_steps"]))
    main["prepare_check"] = prepare_check(qp, qp_prepare_cuda, builds, preps, "phase5")
    main["prepare_timing"] = prepare_timing(qp, qp_prepare_cuda, preps, gpu, "phase5")
    main["qp_split"] = qp_split(workload, dev, gpu)
    assert main["qp_split"]["solve_under_sync_error_mode"] == "ok", main["qp_split"]
    assert main["qp_split"]["host_syncs_per_step"] == [0] * SYNC_COUNT_REPS, main["qp_split"]
    assert main["qp_split"]["prepare"]["wrapper_launches"]["qp_prepare"] == 1, main["qp_split"]
    main["clsc_check"] = clsc_check(lsc, builds, clscs, "phase5")
    main["clsc_timing"], x = clsc_timing(lsc, hull_cuda, geometry, clscs, gpu, "phase5")
    assert main["clsc_timing"]["hulls"] == A_MAIN * planner.O * p.M, main["clsc_timing"]
    main["hull_timing"] = hull_timing(geometry, hull_cuda, builds, x, gpu, "phase5")
    main["sfc_hull_check"] = sfc_hull_check(sfc, builds, sfcs, "phase5")
    main["sfc_hull_timing"] = sfc_hull_timing(sfc, sfcs, l2_ns, gpu, "phase5")
    # the expansion entry (the 'point' and 'substep' modes') on the main path's lanes
    main["sfc_timing"] = sfc_timing(sfc, fused_lanes(sfc, sfcs.calls[0]), l2_ns, gpu, "phase5")
    for rec, t in ((builds.clsc, main["clsc_timing"]), (builds.hull, main["hull_timing"]),
                   (builds.sfc_hull, main["sfc_hull_timing"]), (builds.sfc, main["sfc_timing"]),
                   (builds.prep, main["prepare_timing"])):
        rec.update({k: t[k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bound_share", "bytes_ms",
            "ops_ms", *(k for k in ("hulls", "ops_per_hull", "lanes", "library_ms",
                                    "lane_trips", "longest_lane_trips", "latency_floor_ms",
                                    "floor_share", "host_ms", "blocks_per_sm", "smem_bytes",
                                    "queued_ms", "hulls_a_block")
                                if k in t))})
    print(f"phase5 CLSC stage {stage_ms.get('lsc')} ms, SFC stage {stage_ms.get('sfc')} ms "
          f"a step [{gpu}]")
    main["clsc_split"] = clsc_split(workload, dev, gpu)
    main["sfc_split"] = sfc_split(workload, dev, gpu)
    for split, key in ((main["clsc_split"]["build_clsc"], "clsc_build"),
                       (main["sfc_split"]["update_sfc"], "sfc_update_hull")):
        # one launch of the stage's kernel, no other wrapper launch, no
        # memory copy (no host read); the profiler may miss a ctypes launch
        assert split["wrapper_launches"][key] == 1, (key, split)
        assert sum(split["wrapper_launches"].values()) == 1, (key, split)
        assert split["device_copies"] == 0 and split["device_kernels"] <= 1, (key, split)
    main["rounding_check"] = rounding_check(dev)
    main["sfc_probe"] = sfc_probe(workload, dev, gpu, l2_ns)
    record["main"] = main
    phase_done("5")

    # ---- 6, 7. the simulator flies forest missions ---------------------
    from lsc_dr_planner_tpu_torch.config import Param
    from lsc_dr_planner_tpu_torch.sim import run as sim_run
    from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

    work = out_dir / "chip_smoke_sim"
    work.mkdir(parents=True, exist_ok=True)
    for phase, A, seed, max_iter in FLIGHTS:
        mission = workload.forest_mission(A, seed)
        # phase 6 writes its simulation CSV, which phase 13 reads back
        param = Param(multisim_save_result=phase == 6, multisim_max_planner_iteration=max_iter)
        sim = MultiSyncSimulator(param, mission, log_dir=str(work), device=dev)
        if phase == 6:
            sim6 = sim
        ck_dir = work / f"phase{phase}"
        ck_dir.mkdir(exist_ok=True)
        builds.reset_launches()
        restart(srec, 25)
        t0 = time.perf_counter()
        recorders = path_calls(sfc, lsc, geometry, every=25)
        sfcs, expands, clscs, hulls = recorders
        with sfcs, expands, clscs, hulls:
            r, cks = run_checkpointed(sim, max_iter, ck_dir)
        wall = time.perf_counter() - t0
        launches = builds.add_path_launches()
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
            res["stage_ms_mean"] = stage_ms_mean(sim)
        print(f"phase{phase}", json.dumps(res))
        check_audit(r, f"phase {phase}")
        builds.assert_launched(launches, f"phase {phase}", clsc=True, sfc_hull=True)
        assert_one_launch_a_call(launches, recorders, f"phase {phase}")
        assert res["min_pair_distance"] >= 2 * 0.15 - sim.planner.feas_tol, res
        assert sim.step_time.N == sim.planner_seq, (sim.step_time.N, sim.planner_seq)
        record[f"phase{phase}"] = res
        res["sfc_hull_check"] = sfc_hull_check(sfc, builds, sfcs, f"phase{phase}")
        if phase == 6:  # the same updates with no radius clamp (r = 0)
            res["sfc_hull_check_r0"] = sfc_hull_check(sfc, builds, sfcs, "phase6 r=0", radius=0)
        res["clsc_check"] = clsc_check(lsc, builds, clscs, f"phase{phase}")
        res["stage_checks"] = stage_checks(builds, srec, f"phase{phase}")

        # the kernel against the plain loop on the QPs of the flight's steps
        res["kernel_checks"] = []
        for ck in cks:
            planner_k, qp_inp_k = step_qp(param, mission, sim, ck, str(work))
            cfg_k, tol_k = planner_k.qp_cfg, planner_k.feas_tol
            li_k = qp.prepare(cfg_k, qp_inp_k).loop
            rec = loop_check(qp, cfg_k, li_k, tol_k,
                             f"phase{phase} kernel, step after {Path(ck).stem}")
            builds.note_check(cfg_k, rec)
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
            builds.reset_launches()
            (cli,) = sim_run.main(["--mission", mpath, "--world", wpath, "--device", "cuda",
                                   "--max-iter", str(max_iter), "--log-dir", str(work)])
            launches = builds.add_path_launches()
            check_audit(cli, "phase 6 CLI")
            builds.assert_launched(launches, "the CLI run")
            record["phase6"]["cli"] = {"flight_time_s": cli["total_flight_time"],
                                       "planner_steps": cli["planner_seq"],
                                       "kernel_launches": launches}
        else:
            record["phase7"]["parity"] = step_parity(param, mission, sim, cks[:PARITY_STEPS],
                                                     str(work))

        phase_done(str(phase))

    # ---- 8. the fused step in the other planner modes --------------------
    record["phase8"] = {}
    for tag, what, overrides, f64 in phase8_modes():
        print(f"phase{tag}: {what}", flush=True)
        restart(srec, TIMED8 // 2)
        record["phase8"][tag] = fused_mode(workload, qp, builds, dev, gpu, tag,
                                           overrides, float64_clause=f64, l2_ns=l2_ns)
        record["phase8"][tag]["stage_checks"] = stage_checks(builds, srec, f"phase{tag}")
    from lsc_dr_planner_tpu_torch.config import PlannerMode

    restart(srec, 1)
    record["phase8"]["8e"] = fused_mode(workload, qp, builds, dev, gpu, "8e",
                                        dict(world_dimension=3,
                                             planner_mode=PlannerMode.DLSC), steps=False,
                                        float64_clause=True, moved_seeds=MOVED_SEEDS)
    record["phase8"]["8e"]["stage_checks"] = stage_checks(builds, srec, "phase8e")
    phase_done("8")

    # ---- 8f, 8g: the shapes past the narrow kernels' builds ---------------
    print("phase8f: LSC-DR 3-D, M=12, every agent within 5 m an obstacle (80 slots)", flush=True)
    r = record["phase8"]["8f"] = fused_mode(
        workload, qp, builds, dev, gpu, "8f", P8F, float64_clause=True, l2_ns=l2_ns,
        warmup=P8F_WARMUP, timed=P8F_TIMED, stage_recs=srec, separate=P8F_SEPARATE)
    assert r["build"] == qp_cuda.CLUSTER_BUILD and r["dk"] == 102, (r["build"], r["dk"])
    assert r["kernel_launches"][qp_cuda.CLUSTER_BUILD] > 0, r["kernel_launches"]
    assert r["kernel_launches"]["front_with_neighbors_wide"] == P8F_TIMED, r["kernel_launches"]
    assert r["separate"]["kernel_launches"]["neighbor_slots_wide"] == P8F_SEPARATE
    assert r["separate"]["kernel_launches"]["step_front_wide"] == P8F_SEPARATE
    phase_done("8f")
    record["phase8"]["8g"] = phase8g(workload, qp, builds, dev, gpu, srec)
    phase_done("8g")
    print("phase8h: LSC-DR 2-D, Bézier degree 8 (N = 9 control points a segment)", flush=True)
    r = record["phase8"]["8h"] = fused_mode(
        workload, qp, builds, dev, gpu, "8h", P8H, float64_clause=True, l2_ns=l2_ns,
        warmup=P8H_WARMUP, timed=P8H_TIMED, stage_recs=srec)
    # the main batch (A=1024, two agents an SM) on the memory build, the
    # 64-agent rescue on the cluster build
    assert r["build"] == qp_cuda.MEMORY_BUILD and r["dk"] == 116, (r["build"], r["dk"])
    assert r["kernel_launches"][qp_cuda.MEMORY_BUILD] > 0, r["kernel_launches"]
    assert r["kernel_launches"][qp_cuda.CLUSTER_BUILD] > 0, r["kernel_launches"]
    assert r["clsc_timing"]["N"] == 9 and r["hull_timing"]["K"] == 9, r["clsc_timing"]
    assert r["kernel_launches"]["clsc_build_rt"] == r["kernel_launches"]["clsc_build"] \
        == P8H_TIMED, r["kernel_launches"]
    assert all(c["rt"] for c in r["clsc_check"]), r["clsc_check"]
    for rec, t in ((builds.clsc_rt, r["clsc_timing"]), (builds.hull_rt, r["hull_timing"])):
        rec.update({k: t[k] for k in ("ms", "device_ms", "queued_ms", "plain_ms", "bound_ms",
                                      "bound_by", "bound_share", "bytes_ms", "ops_ms", "hulls",
                                      "ops_per_hull", "smem_bytes", "blocks_per_sm")})
        rec.update({k: t[k] for k in ("hulls_a_block",) if k in t})
    r["solve"] = solve_against_plain(workload, qp, dev, gpu, P8H, "phase8h")
    r["query"] = phase8h_query(workload, builds, dev, gpu)
    phase_done("8h")

    # ---- 9. forest flights in the new modes ------------------------------
    record["phase9"] = {}
    for tag, overrides, obstacles, max_iter in phase9_flights():
        restart(srec, 25)
        record["phase9"][tag] = fly(workload, qp, builds, dev, gpu, work, tag,
                                    overrides, obstacles, max_iter)
        record["phase9"][tag]["stage_checks"] = stage_checks(builds, srec, f"phase{tag}")
    phase_done("9")

    # ---- 10. the JAX package's small mode missions -----------------------
    record["phase10"] = {}
    from lsc_dr_planner_tpu_torch.sim import mode_missions

    missions = {**mode_missions.MISSIONS, "prior_based_forest": prior_based_forest}
    for name, fly_mission in missions.items():
        builds.reset_launches()
        restart(srec, 10)
        t0 = time.perf_counter()
        recorders = path_calls(sfc, lsc, geometry, keep=1)
        sfcs, expands, clscs, hulls = recorders
        with sfcs, expands, clscs, hulls:
            res = fly_mission(dev, work)
        res.update(wall_s=time.perf_counter() - t0, kernel_launches=builds.add_path_launches())
        print(f"phase10 {name}", json.dumps(res))
        # the small missions fly with world_use_octomap off (no SFC update);
        # every SFC update of the others launches a kernel; every mission
        # but BVC and RSFC builds LSC rows (plain LSC, build_lsc)
        builds.assert_launched(res["kernel_launches"], f"phase 10 {name}",
                               sfc=sfcs.n + expands.n > 0, hull=name not in NO_HULL_MISSIONS,
                               neighbors=False)
        assert_one_launch_a_call(res["kernel_launches"], recorders, f"phase 10 {name}")
        if expands.n:
            res["sfc_check"] = sfc_check(sfc, builds, expands, f"phase10 {name}")
        if sfcs.n:
            res["sfc_hull_check"] = sfc_hull_check(sfc, builds, sfcs, f"phase10 {name}")
        if hulls.n:
            res["hull_check"] = hull_check(geometry, hull_cuda, builds, hulls, f"phase10 {name}")
        if clscs.n:
            res["clsc_check"] = clsc_check(lsc, builds, clscs, f"phase10 {name}")
        res["stage_checks"] = stage_checks(builds, srec, f"phase10 {name}")
        record["phase10"][name] = res
    assert "sfc_check" in record["phase10"]["prior_based_forest"], "no 'point' SFC in phase 10"
    assert "build_lsc" in builds.hull["callers"], "no build_lsc hull query checked in phase 10"
    phase_done("10")

    # ---- 11. local sensing -----------------------------------------------
    record["phase11"] = {}
    for tag, A, seed, max_iter, cks in LOCAL_FLIGHTS:
        restart(srec, 25)
        sim, param, mission, ck_paths, res = local_flight(
            workload, qp, builds, dev, gpu, work, tag, A, seed, max_iter, cks)
        res["stage_checks"] = stage_checks(builds, srec, f"phase{tag}")
        if tag == "11a":
            # the same mission through the CLI, as a user runs it
            mpath, wpath = str(work / "forest10_local.json"), str(work / "forest10_local.csv")
            mission.save(mpath)
            np.savetxt(wpath, mission.world_boxes, delimiter=",")
            builds.reset_launches()
            (cli,) = sim_run.main(["--mission", mpath, "--world", wpath, "--device", "cuda",
                                   "--no-global-map", "--sensor-range", "3.0",
                                   "--max-iter", str(max_iter), "--log-dir", str(work)])
            launches = builds.add_path_launches()
            check_audit(cli, "phase 11a CLI")
            builds.assert_launched(launches, "the CLI local flight")
            res["cli"] = {"flight_time_s": cli["total_flight_time"],
                          "planner_steps": cli["planner_seq"], "kernel_launches": launches}
        else:
            res["parity"] = step_parity(param, mission, sim, ck_paths, str(work), tag="phase11b")
            g = record["phase7"]
            res["beside_phase7"] = {k: g.get(k) for k in (
                "planner_steps", "flight_time_s", "step_p50_ms", "step_p99_ms",
                "stage_ms_mean")}
            print("phase11b beside phase7 (global map)", json.dumps(res["beside_phase7"]))
        record["phase11"][tag] = res
    phase_done("11")

    # ---- 12. Monte-Carlo scenario batching -------------------------------
    restart(srec, 50)
    record["phase12"] = {"12a": montecarlo_run(workload, qp, builds, dev, gpu, work)}
    record["phase12"]["12a"]["stage_checks"] = stage_checks(builds, srec, "phase12a")
    restart(srec, 1)
    record["phase12"]["12b"] = montecarlo_chunks(workload, builds, dev, gpu, work)
    record["phase12"]["12b"]["stage_checks"] = stage_checks(builds, srec, "phase12b")
    phase_done("12")

    # ---- 13. one-rank NCCL group, debug step, replay ----------------------
    # the prediction kernel on the sharded steps' gathered neighbour slots
    restart(srec, 1)
    srec[1].accept = lambda a, k: a[5] is not None
    record["phase13"] = phase13(workload, builds, dev, gpu, work, sim6)
    record["phase13"]["stage_checks"] = stage_checks(builds, srec, "phase13")
    assert record["phase13"]["stage_checks"]["step_front"]["calls"] > 0
    phase_done("13")

    # ---- 14. the tools ----------------------------------------------------
    restart(srec, 25)
    record["phase14"] = phase14(qp, builds, dev, gpu, work)
    record["phase14"]["stage_checks"] = stage_checks(builds, srec, "phase14")
    stage_stack.close()
    phase_done("14")

    kernels = []
    for name, r in builds.rec.items():
        print(f"build {name}", json.dumps(r))
        assert r["launches"] > 0, f"build {name} was never launched on a main path"
        assert r["ms"] is not None, f"build {name} was never timed"
        kernels.append({
            "name": f"admm_loop{name}", "route": "cuda",
            "source": "lsc_dr_planner_tpu_torch/csrc/admm.cu",
            "replaces": "lsc_dr_planner_tpu/ops/qp_pallas.py:67",
            "dk": r["dk"], "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "iters": r["iters"], "A": r["A"],
            "R": r["R"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "bound_share": r["bound_share"], "calls_checked": r["calls_checked"],
            "ptxas": kernels_ptxas.get(admm_ptxas(qp_cuda, name)),
            # past the register builds: the cluster size (0: the global
            # build), shared bytes, blocks or CTAs an SM; the global build's
            # device ms a call (`global_loop_timing`: the profiler's mean ms
            # a launch times the call's launches), its queued ms, bytes a
            # call and the one-pass floor (`global_loop_bytes`)
            **{k: r[k] for k in ("C", "smem_bytes", "ctas_per_sm", "active_clusters",
                                 "device_ms") + GLOBAL_KEYS if r.get(k) is not None},
            "library_ms": None,  # no single PyTorch call computes the loop
        })
    geometry_kernels = (
        # (name, record, source, the TPU-side function it replaces, its kernel in
        # ptxas's summary, the items its check counts)
        ("sfc_expand", builds.sfc, "sfc_expand.cu",
         "lsc_dr_planner_tpu/ops/sfc.py:37",  # a lax.while_loop; no Pallas original
         "sfc_expand_kernel", ("calls_checked", "lanes_checked")),
        ("sfc_update_hull", builds.sfc_hull, "sfc_expand.cu",
         "lsc_dr_planner_tpu/ops/sfc.py:313",  # update_sfc_fused, jnp and a while_loop
         "sfc_update_hull_kernel", ("calls_checked", "agents_checked", "elements_checked")),
        ("hull_closest", builds.hull, "hull_closest.cu",
         "lsc_dr_planner_tpu/ops/geometry.py:192",  # a jnp enumeration; no Pallas original
         "hull_closest_kernel<6>", ("calls_checked", "hulls_checked")),
        ("clsc_build", builds.clsc, "hull_closest.cu",
         "lsc_dr_planner_tpu/ops/lsc.py:129",  # build_clsc, jnp; no Pallas original
         "clsc_build_kernel<6>", ("calls_checked", "pairs_checked", "elements_checked")),
        # the run-time builds (K > 8; timed at phase 8h's N = 9)
        ("hull_closest<rt>", builds.hull_rt, "hull_closest.cu",
         "lsc_dr_planner_tpu/ops/geometry.py:192", "hull_closest_rt_kernel",
         ("calls_checked", "hulls_checked", "smem_bytes")),
        ("clsc_build<rt>", builds.clsc_rt, "hull_closest.cu",
         "lsc_dr_planner_tpu/ops/lsc.py:129", "clsc_build_rt_kernel",
         ("calls_checked", "pairs_checked", "elements_checked", "smem_bytes")),
    )
    for name, r, source, replaces, kernel, checked in geometry_kernels:
        print(name, json.dumps(r))
        assert r["launches"] > 0, f"{name} was never launched on a main path"
        assert r["ms"] is not None and r["calls_checked"] > 0, (name, r)
        kernels.append({
            "name": name, "route": "cuda", "source": f"lsc_dr_planner_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "bound_share": r["bound_share"],
            **{k: r[k] for k in ("latency_floor_ms", "floor_share", "queued_ms", "smem_bytes",
                                 "blocks_per_sm", "hulls_a_block") if k in r},
            **{k: r[k] for k in checked}, "ptxas": kernels_ptxas.get(kernel),
            "library_ms": None,  # no PyTorch call computes it
        })
    r = builds.prep
    print("qp_prepare", json.dumps(r))
    assert r["launches"] > 0 and r["ms"] is not None and r["calls_checked"] > 0, r
    assert sorted(r["dims"]) == [2, 3] and r["max_agents"] == P14_MC_S * P14_MC_A, r
    kernels.append({
        "name": "qp_prepare", "route": "cuda",
        "source": "lsc_dr_planner_tpu_torch/csrc/qp_prepare.cu",
        # solve's pre-loop body (jnp, Cholesky at :540); no Pallas original
        "replaces": "lsc_dr_planner_tpu/ops/qp.py:474",
        "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "bound_share": r["bound_share"],
        **{k: r[k] for k in ("calls_checked", "agents_checked", "elements_checked",
                             "max_share_of_tolerance", "max_kinv_ratio")},
        # two builds: <8> blocks an SM up to 8 tile rows, <4> above
        "ptxas": {k: v for k, v in kernels_ptxas.items() if k.startswith("qp_prepare_kernel")},
        **{k: r[k] for k in ("host_ms", "blocks_per_sm", "smem_bytes")},
        # torch.cholesky_inverse(torch.linalg.cholesky_ex(Kmat).L): the inverse alone
        "library_ms": r["library_ms"],
    })
    r = builds.prep_global
    print(f"qp_prepare{qp_prepare_cuda.GLOBAL_BUILD}", json.dumps(r))
    assert r["launches"] > 0 and r["ms"] is not None and r["calls_checked"] > 0, r
    kernels.append({
        "name": f"qp_prepare{qp_prepare_cuda.GLOBAL_BUILD}", "route": "cuda",
        "source": "lsc_dr_planner_tpu_torch/csrc/qp_prepare.cu",
        "replaces": "lsc_dr_planner_tpu/ops/qp.py:474",
        **{k: r[k] for k in ("launches", "max_abs_err", "ms", "device_ms", "plain_ms",
                             "bound_ms", "bound_by", "bound_share", "calls_checked",
                             "agents_checked", "elements_checked", "max_share_of_tolerance",
                             "max_kinv_ratio", "smem_bytes", "blocks_per_sm", "A", "dk")},
        "ptxas": kernels_ptxas.get("qp_prepare_kernel<2,1>"),
        "library_ms": r["library_ms"],
    })
    for name, replaces in (
            # the JAX package's code each replaces, jnp and lax in its jitted step;
            # no Pallas original
            ("neighbor_slots", "lsc_dr_planner_tpu/planner/pipeline.py:226"),
            ("step_front", "lsc_dr_planner_tpu/planner/pipeline.py:292"),
            ("front_with_neighbors", "lsc_dr_planner_tpu/planner/pipeline.py:226-445"),
            ("goal_qp_inputs", "lsc_dr_planner_tpu/planner/goal.py:26"),
            ("neighbor_slots<wide>", "lsc_dr_planner_tpu/planner/pipeline.py:226"),
            ("step_front<wide>", "lsc_dr_planner_tpu/planner/pipeline.py:292"),
            ("front_with_neighbors<wide>", "lsc_dr_planner_tpu/planner/pipeline.py:226-445")):
        r = builds.wide[name[:-6]] if name.endswith("<wide>") else builds.stage[name]
        print(name, json.dumps(r))
        assert r["launches"] > 0 and r["ms"] is not None and r["calls_checked"] > 0, (name, r)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "lsc_dr_planner_tpu_torch/csrc/step_stages.cu", "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            **{k: r[k] for k in ("queued_ms", "device_ms", "call_device_ms", "host_ms",
                                 "host_ms_one_buffer", "plain_ms", "bound_ms", "bound_by",
                                 "bound_share", "bytes", "calls_checked", "elements_checked",
                                 "phases", "kernel", "dynamic_smem_bytes", "blocks_per_sm")},
            **{k: r[k] for k in ("blocks_an_agent",) if k in r},
            "ptxas": kernels_ptxas.get(r["kernel"]),
            "library_ms": None,  # no single PyTorch call computes it
        })
    assert sorted(builds.hull["callers"]) == ["build_clsc (plain body)", "build_lsc"], \
        builds.hull["callers"]
    assert sorted(builds.hull["dims"]) == [2, 3], builds.hull["dims"]
    assert sorted(builds.clsc["dims"]) == [2, 3], builds.clsc["dims"]
    assert sorted(builds.sfc_hull["per_agent_images"]) == [False, True], builds.sfc_hull
    record["kernels"] = kernels
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
