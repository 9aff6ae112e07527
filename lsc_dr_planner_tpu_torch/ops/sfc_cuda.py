"""Wrappers of the hand-written Hopper SFC kernels (`csrc/sfc_expand.cu`).

Two entries share one device function, a lane's expansion run by one
warp that speculates on a chain of growths (thread j queries the trip
after j more growths; one ballot resolves the growths up to the first
failing trip, up to 32 trips a round; see the note at the top of the
source for the layout and what bounds it):

- `expand_box_cuda`: the expansion of L lanes in one launch, replacing
  the JAX package's `lax.while_loop`
  lsc_dr_planner_tpu/ops/sfc.py::expand_box (no Pallas original); it
  equals `ops/sfc.py::expand_box_plain` bit for bit. The 'point' and
  'substep' SFC modes take it through `sfc.expand_box`.
- `update_sfc_hull_cuda`: the whole 'hull'-mode update
  (`sfc.update_sfc(mode='hull')`: the JAX package's update_sfc_fused,
  lsc_dr_planner_tpu/ops/sfc.py:313, and `sfc.sfc_to_world`) in one launch, a block
  of three warps per agent; it equals that torch body bit for bit and
  adds the call's longest lane's trips to the device counter itself.

Both take CUDA tensors only and raise on anything else; `ops/sfc.py`
gives them CUDA tensors and CPU tensors to the plain versions. The
source is compiled at first use by `cuda_build` into `build/` and loaded
with ctypes. `launches` and `hull_launches` count each entry's kernel
launches since `reset_launches()`. `l2_round_trip_ns` and
`query_round_trip_ns` time one L2 round trip and one dependent 8-corner
query of an integral image (measurement only, for the latency floor).
"""

from __future__ import annotations

import ctypes

import torch

from lsc_dr_planner_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "sfc_expand.cu"

launches = 0  # sfc_expand kernel launches since the last reset
hull_launches = 0  # sfc_update_hull kernel launches since the last reset
_lib = None


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(cuda_build.compile_source(SOURCE, verbose)))
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.sfc_expand_launch.argtypes = [P] * 5 + [LL] + [I] * 9 + [P] * 4
    lib.sfc_expand_launch.restype = I
    lib.sfc_update_hull_launch.argtypes = ([P, I, I, I, I] + [P] * 7 + [LL] * 4 + [I] * 8
                                           + [F] * 3 + [I] * 2 + [P] * 12)
    lib.sfc_update_hull_launch.restype = I
    lib.sfc_l2_chase_launch.argtypes = [P, I, P, P]
    lib.sfc_l2_chase_launch.restype = I
    lib.sfc_query_chase_launch.argtypes = [P, I, I, I, I, P, P]
    lib.sfc_query_chase_launch.restype = I
    lib.sfc_occupancy.argtypes = [I, P]
    lib.sfc_occupancy.restype = I
    _lib = lib
    return lib


def occupancy(kernel: int) -> int:
    """Blocks an SM of kernel 0, the expansion, or 1, the 'hull' update
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = ctypes.c_int(0)
    rc = build().sfc_occupancy(kernel, ctypes.byref(out))
    if rc:
        raise RuntimeError(f"sfc_occupancy failed: CUDA error {rc}")
    return out.value


def reset_launches():
    global launches, hull_launches
    launches = hull_launches = 0


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name}: need {dtype} on {dev}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_image(cumsum, dims, dev):
    """The integral image's shape (X+2, Y+2, Z+2) per image, its type and
    device; the kernels index one image with 32-bit offsets."""
    X, Y, Z = dims
    SX, SY, SZ = cumsum.shape[-3:]
    if (SX, SY, SZ) != (X + 2, Y + 2, Z + 2):
        raise ValueError(f"integral image {tuple(cumsum.shape)} does not fit dims {dims}")
    if SX * SY * SZ >= 2**31:
        raise ValueError(f"integral image {tuple(cumsum.shape)}: 2^31 entries or more")
    _check("cumsum", cumsum, torch.int32, cumsum.shape, dev)
    return SX, SY, SZ


def expand_box_cuda(cumsum, dims, lo, hi, axis_order, max_radius_cells: int, max_trips: int,
                    agent):
    """Queue the expansion of L lanes on the current stream (one launch,
    no synchronisation). cumsum: the integral image, int32 [X+2, Y+2,
    Z+2], or [A, X+2, Y+2, Z+2] with `agent` int64 [L] naming each lane's
    image (None with one image); dims: the lattice dims (X, Y, Z), host
    ints; lo, hi: int32 [L, 3] seeds; axis_order: int64 [L, 6].
    Returns (lo, hi, seed_free) as `sfc.expand_box_plain` does."""
    global launches
    dev = lo.device
    if dev.type != "cuda":
        raise ValueError(f"the SFC kernel needs CUDA tensors, got {dev}")
    L = lo.shape[0]
    if L < 1:
        raise ValueError("empty batch")
    if cumsum.dim() not in (3, 4) or (agent is None) != (cumsum.dim() == 3):
        raise ValueError(f"integral image {tuple(cumsum.shape)} with agent "
                         f"{'None' if agent is None else tuple(agent.shape)}: need a 3-D "
                         "image without, or a 4-D per-agent image with, an agent per lane")
    SX, SY, SZ = _check_image(cumsum, dims, dev)
    _check("lo", lo, torch.int32, (L, 3), dev)
    _check("hi", hi, torch.int32, (L, 3), dev)
    _check("axis_order", axis_order, torch.int64, (L, 6), dev)
    if agent is not None:
        _check("agent", agent, torch.int64, (L,), dev)

    lib = build()
    out_lo = torch.empty_like(lo)
    out_hi = torch.empty_like(hi)
    seed_free = torch.empty(L, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sfc_expand_launch(
            lo.data_ptr(), hi.data_ptr(), axis_order.data_ptr(),
            None if agent is None else agent.data_ptr(), cumsum.data_ptr(),
            1 if agent is None else cumsum.shape[0], L, *dims, SX, SY, SZ,
            max_radius_cells, max_trips, out_lo.data_ptr(), out_hi.data_ptr(),
            seed_free.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sfc_expand_launch failed: CUDA error {rc}")
    launches += 1
    return out_lo, out_hi, seed_free


def update_sfc_hull_cuda(cumsum, dims, origin, resolution: float, sfc_lo, sfc_hi, init_done,
                         last_pt, cgoal, wpt, pos, delta_sup: float, delta_world: float,
                         max_radius_cells: int, max_trips: int, trips_total, scratch):
    """Queue the 'hull'-mode SFC update of A agents on the current stream
    (one launch, no synchronisation). cumsum: int32 [X+2, Y+2, Z+2], or
    [A, X+2, Y+2, Z+2] (agent a reads image a); dims, origin: host ints
    (X, Y, Z) and the lattice origin; sfc_lo, sfc_hi: int32 [A, M, 3];
    init_done: bool [A]; last_pt, cgoal, wpt, pos: float32 [A, 3], each
    row contiguous (the rows may be strided, as a view of the trajectory
    end is); delta_sup, delta_world: sfc_to_world's face shifts for the
    world's radius and for the corridor margin (host floats); trips_total: int64
    [1], to which the call's longest lane's trips are added; scratch:
    int32 [2] of zeros, left zero. Returns (lo, hi, lo_w, hi_w) [A, M, 3]
    and the lanes (seed_lo, seed_hi, lo, hi, seed_free), agent-major [3A,
    3] and [3A], as `sfc.expand_box` takes and gives them."""
    global hull_launches
    dev = sfc_lo.device
    if dev.type != "cuda":
        raise ValueError(f"the SFC kernel needs CUDA tensors, got {dev}")
    A, M = sfc_lo.shape[:2]
    if cumsum.dim() not in (3, 4) or (cumsum.dim() == 4 and cumsum.shape[0] != A):
        raise ValueError(f"integral image {tuple(cumsum.shape)} for {A} agents: need one "
                         "image, or one per agent")
    SX, SY, SZ = _check_image(cumsum, dims, dev)
    _check("sfc_lo", sfc_lo, torch.int32, (A, M, 3), dev)
    _check("sfc_hi", sfc_hi, torch.int32, (A, M, 3), dev)
    _check("init_done", init_done, torch.bool, (A,), dev)
    points = (last_pt, cgoal, wpt, pos)
    for name, t in zip(("last_pt", "cgoal", "wpt", "pos"), points):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (A, 3):
            raise ValueError(f"{name}: need float32 [{A}, 3] on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.stride(1) != 1 and A > 0:
            raise ValueError(f"{name}: rows not contiguous")
    _check("trips_total", trips_total, torch.int64, (1,), dev)
    _check("scratch", scratch, torch.int32, (2,), dev)

    box = [torch.empty(A, M, 3, dtype=dt, device=dev)
           for dt in (torch.int32, torch.int32, torch.float32, torch.float32)]
    lanes = [torch.empty(3 * A, 3, dtype=torch.int32, device=dev) for _ in range(4)]
    lane_ok = torch.empty(3 * A, dtype=torch.bool, device=dev)
    if A == 0:
        return (*box, *lanes, lane_ok)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sfc_update_hull_launch(
            cumsum.data_ptr(), int(cumsum.dim() == 4), SX, SY, SZ, sfc_lo.data_ptr(),
            sfc_hi.data_ptr(), init_done.data_ptr(), *(t.data_ptr() for t in points),
            *(t.stride(0) for t in points), A, M, *dims, *origin, resolution, delta_sup,
            delta_world, max_radius_cells, max_trips, *(t.data_ptr() for t in box),
            *(t.data_ptr() for t in lanes), lane_ok.data_ptr(), trips_total.data_ptr(),
            scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sfc_update_hull_launch failed: CUDA error {rc}")
    hull_launches += 1
    return (*box, *lanes, lane_ok)


def _timed_chase(dev, launch, hops):
    """ms of launch() (one chase of `hops` links) by CUDA events, after
    one untimed run that brings the links into the cache."""
    with torch.cuda.device(dev):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for timed in (False, True):
            if timed:
                e0.record()
            rc = launch(torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"chase launch failed: CUDA error {rc}")
        e1.record()
        torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) * 1e6 / hops


def l2_round_trip_ns(dev, n: int = 1 << 22, hops: int = 20000, seed: int = 0) -> float:
    """ns of one dependent L2 read on `dev`: one thread follows `hops`
    links of a random cycle through n int32 (16 MiB by default, inside
    the H100's 50 MB L2 and far beyond its L1), once to bring the links
    into L2, then timed with CUDA events."""
    lib = build()
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(n, device=dev, generator=g)
    nxt = torch.empty(n, dtype=torch.int32, device=dev)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    return _timed_chase(dev, lambda s: lib.sfc_l2_chase_launch(nxt.data_ptr(), hops,
                                                                out.data_ptr(), s), hops)


def query_round_trip_ns(cumsum, hops: int = 20000) -> float:
    """ns of one dependent 8-corner query of the integral image `cumsum`
    (int32 [X+2, Y+2, Z+2] on a CUDA device; each box placed by the
    previous query's count), through the read-only path as the
    expansion reads it, timed as `l2_round_trip_ns`."""
    lib = build()
    if cumsum.dim() != 3 or cumsum.dtype != torch.int32 or not cumsum.is_contiguous():
        raise ValueError(f"need one contiguous int32 image, got {tuple(cumsum.shape)}")
    out = torch.empty(1, dtype=torch.int32, device=cumsum.device)
    SX, SY, SZ = cumsum.shape
    return _timed_chase(cumsum.device, lambda s: lib.sfc_query_chase_launch(
        cumsum.data_ptr(), SX, SY, SZ, hops, out.data_ptr(), s), hops)
