"""Wrapper of the hand-written Hopper hull enumeration kernel
(`csrc/hull_closest.cu`).

The kernel replaces the JAX package's jnp enumeration
lsc_dr_planner_tpu/ops/geometry.py::closest_point_origin_to_hull (no
Pallas original), which XLA fused on the TPU: one thread per hull walks
the hull's vertices, edges and triangles with a running first minimum,
then its tetrahedra, all in registers, in one launch (see the note at
the top of the source for what bounds it). It equals
`geometry.closest_point_origin_to_hull_plain` bit for bit. The source is
compiled at first use by `cuda_build` into `build/` and loaded with
ctypes.

`closest_point_origin_to_hull_cuda` takes CUDA tensors only and raises
on anything else; `geometry.closest_point_origin_to_hull` gives it CUDA
tensors and CPU tensors to the plain enumeration. `launches` counts
kernel launches since `reset_launches()`.
"""

from __future__ import annotations

import ctypes

import torch

from lsc_dr_planner_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "hull_closest.cu"
MAX_K = 8  # points a hull at most (the kernel's template builds: K = 1..8)

launches = 0  # kernel launches since the last reset
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
    _lib = lib
    return lib


def reset_launches():
    global launches
    launches = 0


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
