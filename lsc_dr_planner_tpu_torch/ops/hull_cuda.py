"""Wrappers of the hand-written Hopper hull kernels (`csrc/hull_closest.cu`).

Two entries share one enumeration of the hull (the K vertices, edges and
triangles with a running first minimum, then the tetrahedra, each
stopped at its first failing sign test), a block's points staged through
shared memory with coalesced loads. Each entry has two kinds of build: a
template build for each K from 1 to 8, one thread per hull, the points
in registers, and one run-time build for any K, one thread per hull too,
the points read from the shared stage (every K above 8; and CLSC shapes
whose template stage passes 48 KB); the run-time builds test no
tetrahedron of a flat hull (every one fails at its first volume there):
the query's per hull, CLSC's in 2-D. See the note
at the top of the source for the layout and what bounds it:

- `build_clsc_cuda`: the whole CLSC construction (`lsc.build_clsc`, the
  JAX package's lsc_dr_planner_tpu/ops/lsc.py:129; no Pallas original)
  in one launch: the downwash, the z-scaling, the hull query, the
  segment-to-segment construction of the last segment, the feasibility
  guard and the selects, writing normals, anchors and margins. It equals
  `lsc.build_clsc`'s torch body bit for bit.
- `closest_point_origin_to_hull_cuda`: the query alone (build_lsc's; the
  JAX package's lsc_dr_planner_tpu/ops/geometry.py::
  closest_point_origin_to_hull, which XLA fused on the TPU). It equals
  `geometry.closest_point_origin_to_hull_plain` bit for bit.

Both take CUDA tensors only and raise on anything else; `lsc.build_clsc`
and `geometry.closest_point_origin_to_hull` give them CUDA tensors and
CPU tensors to the plain versions. The source is compiled at first use
by `cuda_build` into `build/` and loaded with ctypes. `launches` and
`clsc_launches` count each entry's kernel launches since
`reset_launches()`; `rt_launches` counts the launches of each entry's
run-time build among them.
"""

from __future__ import annotations

import ctypes

import torch

from lsc_dr_planner_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "hull_closest.cu"

launches = 0  # hull_closest kernel launches since the last reset
clsc_launches = 0  # clsc_build kernel launches since the last reset
rt_launches = {"hull_closest": 0, "clsc_build": 0}  # of the run-time builds among them
_lib = None


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(cuda_build.compile_source(SOURCE, verbose)))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hull_closest_launch.argtypes = [P, LL, I, P, P, P, P]
    lib.hull_closest_launch.restype = I
    lib.clsc_build_launch.argtypes = [P] * 10 + [LL] + [I] * 4 + [P] * 5
    lib.clsc_build_launch.restype = I
    lib.hull_closest_smem.argtypes = [I, P]
    lib.hull_closest_occupancy.argtypes = [I, P, P]
    lib.hull_closest_occupancy.restype = I
    lib.clsc_build_occupancy.argtypes = [LL, I, I, I, P]
    lib.clsc_build_occupancy.restype = I
    lib.clsc_build_smem.argtypes = [LL, I, I, I, P]
    for f in (lib.hull_closest_smem, lib.clsc_build_smem, lib.hull_max_smem):
        f.restype = LL
    _lib = lib
    return lib


def reset_launches():
    global launches, clsc_launches
    launches = clsc_launches = 0
    for key in rt_launches:
        rt_launches[key] = 0


def hull_closest_plan(K: int):
    """(whether the query of K-point hulls takes the run-time build, the
    shared memory a block of it takes in bytes)."""
    rt = ctypes.c_int()
    smem = build().hull_closest_smem(K, ctypes.byref(rt))
    return bool(rt.value), smem


def hull_closest_occupancy(K: int):
    """(hulls a block, blocks an SM) of the query's build for K-point
    hulls (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    hulls, blocks = ctypes.c_int(), ctypes.c_int()
    rc = build().hull_closest_occupancy(K, ctypes.byref(hulls), ctypes.byref(blocks))
    if rc:
        raise RuntimeError(f"hull_closest_occupancy failed: CUDA error {rc}")
    return hulls.value, blocks.value


def clsc_build_occupancy(A: int, O: int, M: int, N: int) -> int:
    """Blocks an SM of build_clsc's build at (A, O, M, N)
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = ctypes.c_int()
    rc = build().clsc_build_occupancy(A, O, M, N, ctypes.byref(blocks))
    if rc:
        raise RuntimeError(f"clsc_build_occupancy failed: CUDA error {rc}")
    return blocks.value


def clsc_build_plan(A: int, O: int, M: int, N: int):
    """(whether build_clsc at this shape takes the run-time build, the
    shared memory a block of it takes in bytes)."""
    rt = ctypes.c_int()
    smem = build().clsc_build_smem(A, O, M, N, ctypes.byref(rt))
    return bool(rt.value), smem


def _launch_failed(rc, entry, smem):
    """Raise for a launch that returned `rc` (not 0): -1 where the run-time
    build's stage passes the card's shared memory (`smem`: the bytes it
    needs), else a CUDA error."""
    if rc == -1:
        raise ValueError(f"{entry}: the shape needs {smem} B of shared memory a block, past "
                         f"the {build().hull_max_smem()} B a block may take on the card")
    raise RuntimeError(f"{entry} failed: CUDA error {rc}")


def closest_point_origin_to_hull_cuda(points):
    """Queue the query of every hull of `points` ([..., K, 3] float32,
    contiguous, on a CUDA device, K ≥ 1) on the current stream: one
    launch, no synchronisation (none for an empty batch); the template
    build of K up to 8, the run-time build above. Returns (closest [...,
    3], dist [...]) as the plain enumeration does."""
    global launches
    dev = points.device
    if points.dtype != torch.float32:
        raise ValueError(f"points: need float32, got {points.dtype}")
    if points.dim() < 2 or points.shape[-1] != 3 or points.shape[-2] < 1:
        raise ValueError(f"points: need [..., K, 3] with K >= 1, got {tuple(points.shape)}")
    if not points.is_contiguous():
        raise ValueError("points: not contiguous")
    if dev.type != "cuda":
        raise ValueError(f"the hull kernel needs CUDA tensors, got {dev}")
    K = points.shape[-2]
    lead = points.shape[:-2]
    closest = torch.empty(*lead, 3, dtype=torch.float32, device=dev)
    dist = torch.empty(lead, dtype=torch.float32, device=dev)
    H = dist.numel()
    if H == 0:
        return closest, dist
    lib = build()
    rt = ctypes.c_int()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hull_closest_launch(points.data_ptr(), H, K, closest.data_ptr(),
                                     dist.data_ptr(), ctypes.byref(rt), stream)
    if rc:
        _launch_failed(rc, "hull_closest_launch", hull_closest_plan(K)[1])
    launches += 1
    rt_launches["hull_closest"] += rt.value
    return closest, dist


def build_clsc_cuda(initial_ctrl, obs_ctrl, obs_goal, agent_radius, agent_downwash, obs_radius,
                    obs_downwash, obs_is_agent, current_goal, obs_mask, world_dimension: int):
    """Queue build_clsc on the current stream: one launch, no
    synchronisation (none for an empty batch). The arguments are
    build_clsc's: initial_ctrl [A, M, N, 3], obs_ctrl [A, O, M, N, 3],
    obs_goal [A, O, 3], agent_radius, agent_downwash [A], obs_radius,
    obs_downwash [A, O], obs_is_agent, obs_mask bool [A, O], current_goal
    [A, 3]; float32, contiguous, on one CUDA device, N ≥ 1. The
    template build of N serves N ≤ 8 where its stage fits in 48 KB, the
    run-time build every other shape. Returns (normals [A, O, M, 3],
    anchors [A, O, M, N, 3], margins [A, O, M, N])."""
    global clsc_launches
    if obs_ctrl.dim() != 5 or obs_ctrl.shape[-1] != 3:
        raise ValueError(f"obs_ctrl: need [A, O, M, N, 3], got {tuple(obs_ctrl.shape)}")
    A, O, M, N, _ = obs_ctrl.shape
    dev = obs_ctrl.device
    if N < 1:
        raise ValueError(f"obs_ctrl: need N >= 1 control points, got {N}")
    f32, b = torch.float32, torch.bool
    for name, t, dtype, shape in (
            ("initial_ctrl", initial_ctrl, f32, (A, M, N, 3)), ("obs_ctrl", obs_ctrl, f32, None),
            ("obs_goal", obs_goal, f32, (A, O, 3)), ("agent_radius", agent_radius, f32, (A,)),
            ("agent_downwash", agent_downwash, f32, (A,)), ("obs_radius", obs_radius, f32, (A, O)),
            ("obs_downwash", obs_downwash, f32, (A, O)),
            ("obs_is_agent", obs_is_agent, b, (A, O)), ("current_goal", current_goal, f32, (A, 3)),
            ("obs_mask", obs_mask, b, (A, O))):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: need {dtype} on {dev}, got {t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if dev.type != "cuda":
        raise ValueError(f"the CLSC kernel needs CUDA tensors, got {dev}")
    normals = torch.empty(A, O, M, 3, dtype=f32, device=dev)
    anchors = torch.empty(A, O, M, N, 3, dtype=f32, device=dev)
    margins = torch.empty(A, O, M, N, dtype=f32, device=dev)
    if normals.numel() == 0:
        return normals, anchors, margins
    lib = build()
    rt = ctypes.c_int()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.clsc_build_launch(
            *(t.data_ptr() for t in (initial_ctrl, obs_ctrl, obs_goal, agent_radius,
                                     agent_downwash, obs_radius, obs_downwash, obs_is_agent,
                                     current_goal, obs_mask)),
            A, O, M, N, world_dimension, normals.data_ptr(),
            anchors.data_ptr(), margins.data_ptr(), ctypes.byref(rt), stream)
    if rc:
        _launch_failed(rc, "clsc_build_launch", clsc_build_plan(A, O, M, N)[1])
    clsc_launches += 1
    rt_launches["clsc_build"] += rt.value
    return normals, anchors, margins
