"""Wrapper of the hand-written Hopper SFC box expansion kernel
(`csrc/sfc_expand.cu`).

The kernel replaces the JAX package's `lax.while_loop`
lsc_dr_planner_tpu/ops/sfc.py::expand_box (no Pallas original): one
thread per lane runs the lane's whole greedy expansion on the card, all
lanes in one launch with no host read (see the note at the top of the
source for what bounds it). It equals `ops/sfc.py::expand_box_plain`
bit for bit. The source is compiled at first use by `cuda_build` into
`build/` and loaded with ctypes.

`expand_box_cuda` takes CUDA tensors only and raises on anything else;
`sfc.expand_box` gives it CUDA tensors and CPU tensors to the plain
loop. `launches` counts kernel launches since `reset_launches()`.
`l2_round_trip_ns` times one L2 round trip (measurement only, for the
kernel's latency floor).
"""

from __future__ import annotations

import ctypes

import torch

from lsc_dr_planner_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "sfc_expand.cu"

launches = 0  # kernel launches since the last reset
_lib = None


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(cuda_build.compile_source(SOURCE, verbose)))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sfc_expand_launch.argtypes = [P] * 5 + [LL] + [I] * 9 + [P] * 4
    lib.sfc_expand_launch.restype = I
    lib.sfc_l2_chase_launch.argtypes = [P, I, P, P]
    lib.sfc_l2_chase_launch.restype = I
    _lib = lib
    return lib


def reset_launches():
    global launches
    launches = 0


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name}: need {dtype} on {dev}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


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
    X, Y, Z = dims
    SX, SY, SZ = cumsum.shape[-3:]
    if (SX, SY, SZ) != (X + 2, Y + 2, Z + 2):
        raise ValueError(f"integral image {tuple(cumsum.shape)} does not fit dims {dims}")
    _check("cumsum", cumsum, torch.int32, cumsum.shape, dev)
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
            1 if agent is None else cumsum.shape[0], L, X, Y, Z, SX, SY, SZ,
            max_radius_cells, max_trips, out_lo.data_ptr(), out_hi.data_ptr(),
            seed_free.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sfc_expand_launch failed: CUDA error {rc}")
    launches += 1
    return out_lo, out_hi, seed_free


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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for timed in (False, True):
            if timed:
                e0.record()
            rc = lib.sfc_l2_chase_launch(nxt.data_ptr(), hops, out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"sfc_l2_chase_launch failed: CUDA error {rc}")
        e1.record()
        torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) * 1e6 / hops
