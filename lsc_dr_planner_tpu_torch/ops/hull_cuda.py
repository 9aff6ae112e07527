"""Wrappers of the hand-written Hopper hull kernels (`csrc/hull_closest.cu`).

Two entries share one device function for the hull enumeration (the K
vertices, edges and triangles with a running first minimum, then the
tetrahedra, each stopped at its first failing sign test, all in
registers), one thread per hull, a block's points staged through shared
memory with coalesced loads (see the note at the top of the source for
the layout and what bounds it):

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
`reset_launches()`.
"""

from __future__ import annotations

import ctypes

import torch

from lsc_dr_planner_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "hull_closest.cu"
MAX_K = 8  # points a hull at most (the kernel's template builds: K = 1..8)

launches = 0  # hull_closest kernel launches since the last reset
clsc_launches = 0  # clsc_build kernel launches since the last reset
_lib = None


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(cuda_build.compile_source(SOURCE, verbose)))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hull_closest_launch.argtypes = [P, LL, I, P, P, P]
    lib.hull_closest_launch.restype = I
    lib.clsc_build_launch.argtypes = [P] * 10 + [LL] + [I] * 4 + [P] * 4
    lib.clsc_build_launch.restype = I
    _lib = lib
    return lib


def reset_launches():
    global launches, clsc_launches
    launches = clsc_launches = 0


def closest_point_origin_to_hull_cuda(points):
    """Queue the query of every hull of `points` ([..., K, 3] float32,
    contiguous, on a CUDA device, 1 ≤ K ≤ MAX_K) on the current stream:
    one launch, no synchronisation (none for an empty batch). Returns
    (closest [..., 3], dist [...]) as the plain enumeration does."""
    global launches
    dev = points.device
    if points.dtype != torch.float32:
        raise ValueError(f"points: need float32, got {points.dtype}")
    if points.dim() < 2 or points.shape[-1] != 3 or not 1 <= points.shape[-2] <= MAX_K:
        raise ValueError(f"points: need [..., K, 3] with 1 <= K <= {MAX_K}, "
                         f"got {tuple(points.shape)}")
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hull_closest_launch(points.data_ptr(), H, K, closest.data_ptr(),
                                     dist.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hull_closest_launch failed: CUDA error {rc}")
    launches += 1
    return closest, dist


def build_clsc_cuda(initial_ctrl, obs_ctrl, obs_goal, agent_radius, agent_downwash, obs_radius,
                    obs_downwash, obs_is_agent, current_goal, obs_mask, world_dimension: int):
    """Queue build_clsc on the current stream: one launch, no
    synchronisation (none for an empty batch). The arguments are
    build_clsc's: initial_ctrl [A, M, N, 3], obs_ctrl [A, O, M, N, 3],
    obs_goal [A, O, 3], agent_radius, agent_downwash [A], obs_radius,
    obs_downwash [A, O], obs_is_agent, obs_mask bool [A, O], current_goal
    [A, 3]; float32, contiguous, on one CUDA device, 1 ≤ N ≤ MAX_K.
    Returns (normals [A, O, M, 3], anchors [A, O, M, N, 3], margins [A,
    O, M, N])."""
    global clsc_launches
    if obs_ctrl.dim() != 5 or obs_ctrl.shape[-1] != 3:
        raise ValueError(f"obs_ctrl: need [A, O, M, N, 3], got {tuple(obs_ctrl.shape)}")
    A, O, M, N, _ = obs_ctrl.shape
    dev = obs_ctrl.device
    if not 1 <= N <= MAX_K:
        raise ValueError(f"obs_ctrl: need 1 <= N <= {MAX_K} control points, got {N}")
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.clsc_build_launch(
            *(t.data_ptr() for t in (initial_ctrl, obs_ctrl, obs_goal, agent_radius,
                                     agent_downwash, obs_radius, obs_downwash, obs_is_agent,
                                     current_goal, obs_mask)),
            A, O, M, N, world_dimension, normals.data_ptr(),
            anchors.data_ptr(), margins.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"clsc_build_launch failed: CUDA error {rc}")
    clsc_launches += 1
    return normals, anchors, margins
