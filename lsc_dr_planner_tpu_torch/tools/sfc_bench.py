"""SFC stage microbenchmark (port of tools/sfc_bench.py): the main
path's SFC update alone, across fleet sizes and expansion clamps, and
what sets its time.

The JAX tool times its sequential builders `initialize_sfc` and
`construct_sfc_from_hull`; the port folds them into one call,
`ops/sfc.py::update_sfc` in 'hull' mode, which grows all lanes of
the fleet together (three per agent: the initialization box from the
position, and the two hull attempts from {position, goal}, the goal
also standing as the next waypoint); on the card the whole update is one
launch of the fused kernel (`sfc_cuda.update_sfc_hull_cuda`). Each row
times that call
on the JAX tool's world and inputs (rng 0: a forest of 0.3 m columns at
0.25 trees/m² in a square of half-width 0.6·32 + 2 m, resolution 0.1 m,
inflation 0.15 m; random positions and near-antipodal goals), its
previous boxes the initialization boxes, as `initialize_sfc` leaves
them. Per fleet size and clamp, a row with `path` "plain" (the masked
loop `expand_box_plain` inside the torch body; on the card forced with
plain=True) and, on the card, a row with `path` "kernel" (the fused
CUDA kernel, one launch). Beside
the JAX row (`A`, `clamp`, `sfc_ms`, `per_agent_us`; device time of the
whole update over `--reps` calls after a warm-up) it gives:

- `trips`, `syncs`: the plain loop's trips and its host reads of "is
  any lane live?" (every 8 trips); both 0 on the kernel path;
- `launches_per_call`, `launches_per_trip`: device kernels of one call
  of the whole update in `torch.profiler` (`launch_source` says which
  count: the kernels the profiler saw on the device, or, where it saw
  none, the `cudaLaunchKernel` calls on the host), `copies_per_call`,
  its memory copies, and `device_busy_ms`, the device time of its
  kernels and copies in that profiled call (the rest of `sfc_ms` the
  device waits on the host);
- on the kernel path, `kernel_launches_per_call` (the wrapper's count:
  1) and `kernel_ms`, the kernel's own device time in the profiled call;
- `ms_per_trip` (and `launches_per_trip`): per trip of the plain loop,
  or on the kernel path per trip of its longest lane;
- `lane_trips`, `longest_lane_trips`: the trips each lane was live
  (every live trip grows a lane by one cell or retires one of its six
  directions, so a lane whose seed box is free is live for its growth in
  cells plus 6 trips; a clamped lane always finishes inside the loop's
  6·clamp + 6 trips), and `longest_lane_trips_read`, the longest as
  `sfc.read_lane_trips()` counts it on the device;
- `bound_bytes`, `bound_ms`, `bound_share`: the least the expansion's
  memory traffic could take, at 3.35 TB/s (`bound_bytes()`): each lane's
  seed query (8 int32 corners of the integral image), then per live
  trip at most the 4 corners of the face it moves (the other 4 are the
  current box's, read by an earlier query), and each lane's seed,
  direction order and result once. Lanes that read the same corners
  (the three of one agent) are each counted, so the bytes are still an
  upper estimate. The loop does no arithmetic worth a bound of its own,
  so the bytes bound it (the share is of the whole update's time, and
  of the kernel's on the kernel path).

    python -m lsc_dr_planner_tpu_torch.tools.sfc_bench [--sizes 128,256,512,768,1024]
        [--clamps 30] [--reps 5] [--device cuda|cpu]

The main path clamps at `FleetPlanner.sfc_expand_cells`: 70 cells for
`workload.build_fleet`, at most 426 trips a call.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lsc_dr_planner_tpu_torch.device import DEFAULT as DEFAULT_DEVICE
from lsc_dr_planner_tpu_torch.device import describe
from lsc_dr_planner_tpu_torch.device import resolve as resolve_device
from lsc_dr_planner_tpu_torch.ops import sfc, sfc_cuda
from lsc_dr_planner_tpu_torch.world.grid import GridWorld, build_grid_world

RESOLUTION, INFLATION = 0.1, 0.15  # the world's lattice and its obstacle inflation [m]
M = 10  # corridor boxes per agent, as the JAX tool's initialize_sfc
MARGIN = 0.15  # the agents' radius (read by the 'substep' mode only)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
SEED_BYTES = 8 * 4  # a lane's seed query: the 8 int32 corners of the integral image
TRIP_BYTES = 4 * 4  # a trip's query: at most the 4 corners of the face it moves
LANE_BYTES = 2 * 3 * 4 + 6 * 8 + 2 * 3 * 4 + 1  # seed lo/hi, order (int64), lo/hi, ok


def bound_bytes(n_lanes: int, lane_total: int) -> int:
    """Bytes an expansion of `n_lanes` lanes, live for `lane_total`
    lane-trips in all, must move (see the module's docstring)."""
    return (SEED_BYTES + LANE_BYTES) * n_lanes + TRIP_BYTES * lane_total


def bench_trees(rng: np.random.Generator):
    """The JAX tool's world, drawn first from `rng`: (boxes [B, 6], wmin, wmax)."""
    half = 0.6 * 32 + 2.0
    n_trees = int(0.25 * (2 * half) ** 2)
    trees = np.stack([
        rng.uniform(-half + 0.5, half - 0.5, n_trees),
        rng.uniform(-half + 0.5, half - 0.5, n_trees),
        np.full(n_trees, 0.5), np.full(n_trees, 0.3),
        np.full(n_trees, 0.3), np.full(n_trees, 1.0),
    ], 1)
    return trees, np.array([-half, -half, 0.0]), np.array([half, half, 1.0])


def bench_agents(rng: np.random.Generator, A: int):
    """Positions and goals [A, 3] float32, the JAX tool's draws."""
    half = 0.6 * 32 + 2.0
    pos = np.stack([
        rng.uniform(-half + 1, half - 1, A),
        rng.uniform(-half + 1, half - 1, A),
        np.full(A, 0.6),
    ], 1).astype(np.float32)
    goal = -pos + rng.normal(0, 0.1, (A, 3)).astype(np.float32)
    goal[:, 2] = 0.6
    return pos, goal


def sfc_call(gw: GridWorld, pos, goal, clamp: int, plain: bool = False):
    """The timed call: `update_sfc` in 'hull' mode from boxes
    initialized at `pos` (set up here by one call with no box yet),
    hull {pos, goal}, goal as the next waypoint; `plain` takes the plain
    loop on any device. Returns fn() → (lo, hi), the lattice boxes."""
    A = len(pos)
    p = torch.as_tensor(pos, device=gw.device)
    g = torch.as_tensor(goal, device=gw.device)
    args = dict(last_pt=p, cgoal=g, wpt=g, pos=p, init_ctrl=None, margin=MARGIN,
                max_radius_cells=clamp, plain=plain)
    none = torch.zeros((A, M, 3), dtype=torch.int32, device=gw.device)
    init_lo, init_hi = sfc.update_sfc(
        gw, "hull", none, none, torch.zeros(A, dtype=torch.bool, device=gw.device), **args)[:2]
    done = torch.ones(A, dtype=torch.bool, device=gw.device)
    return lambda: sfc.update_sfc(gw, "hull", init_lo, init_hi, done, **args)[:2]


lane_trips = sfc.lane_trips  # trips each lane of the last call was live


def device_ms(fn, reps: int, dev: torch.device) -> float:
    """Mean ms of fn() over `reps` calls after one warm-up: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) / reps


def launch_counts(fn, dev: torch.device) -> dict:
    """One call of fn() under `torch.profiler`: the kernels and memory
    copies the device ran and their device time (ms), the device time of
    the SFC kernels among them, and the `cudaLaunchKernel` calls on the
    host (all 0 on the CPU)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    kernels = copies = host_launches = 0
    busy_us = sfc_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            busy_us += e.self_device_time_total
            if e.key.startswith(("Memcpy", "Memset")):
                copies += e.count
            else:
                kernels += e.count
            if "sfc_expand_kernel" in e.key or "sfc_update_hull_kernel" in e.key:
                sfc_us += e.self_device_time_total
        elif e.key.startswith("cudaLaunchKernel"):
            host_launches += e.count
    return {"device_kernels": kernels, "device_copies": copies,
            "device_busy_ms": busy_us / 1e3, "sfc_kernel_ms": sfc_us / 1e3,
            "host_launch_calls": host_launches}


def measure(gw: GridWorld, pos, goal, clamp: int, reps: int, label: str,
            plain: bool = True) -> dict:
    """One row of one path (the plain loop, or the kernel: `plain`
    False on the card): the JAX tool's fields, then the expansion's
    trips, syncs, launches and bound (see the module's docstring)."""
    dev = gw.device
    A = len(pos)
    fn = sfc_call(gw, pos, goal, clamp, plain)
    ms = device_ms(fn, reps, dev)
    sfc.reset_counts()
    kernel_before = sfc_cuda.launches + sfc_cuda.hull_launches
    fn()
    kernel_launches = sfc_cuda.launches + sfc_cuda.hull_launches - kernel_before
    longest_read = sfc.read_lane_trips()
    trips, syncs = sfc.trips, sfc.syncs
    per_trip = trips if plain else longest_read
    live = lane_trips(*sfc.last_lanes)
    n_lanes = len(live)
    lane_total, longest = int(live.sum()), int(live.max())
    counts = launch_counts(fn, dev)
    launches = counts["device_kernels"] or counts["host_launch_calls"] or None
    n_bytes = bound_bytes(n_lanes, lane_total)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    row = {
        "A": A, "clamp": clamp, "path": "plain" if plain else "kernel",
        "sfc_ms": ms, "per_agent_us": ms * 1e3 / A,
        "trips": trips, "syncs": syncs, "lanes": n_lanes,
        "launches_per_call": launches,
        "launches_per_trip": launches / per_trip if launches and per_trip else None,
        "launch_source": ("profiler device kernels" if counts["device_kernels"]
                          else "host cudaLaunchKernel calls" if launches
                          else "none (cpu)"),
        "copies_per_call": counts["device_copies"],
        "device_busy_ms": counts["device_busy_ms"] if launches else None,
        "ms_per_trip": ms / per_trip if per_trip else None,
        "lane_trips": lane_total, "longest_lane_trips": longest,
        "longest_lane_trips_read": longest_read,
        "bound_bytes": n_bytes, "bound_ms": bound_ms, "bound_by": "bytes",
        "bound_share": bound_ms / ms,
        "device": label,
    }
    if not plain:
        kernel_ms = counts["sfc_kernel_ms"] or None
        row.update(kernel_launches_per_call=kernel_launches, kernel_ms=kernel_ms,
                   kernel_bound_share=bound_ms / kernel_ms if kernel_ms else None)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="128,256,512,768,1024")
    ap.add_argument("--clamps", default="30")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    label = describe(dev)

    rng = np.random.default_rng(0)
    gw = build_grid_world(*bench_trees(rng), RESOLUTION, INFLATION, dev)
    rows = []
    for clamp in [int(c) for c in args.clamps.split(",")]:
        for A in [int(s) for s in args.sizes.split(",")]:
            pos, goal = bench_agents(rng, A)
            for plain in (True, False) if dev.type == "cuda" else (True,):
                rows.append(measure(gw, pos, goal, clamp, args.reps, label, plain))
                print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
