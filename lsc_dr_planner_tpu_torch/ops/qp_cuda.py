"""Wrapper of the hand-written Hopper ADMM kernel (`csrc/admm.cu`).

The kernel replaces the TPU kernel
lsc_dr_planner_tpu/ops/qp_pallas.py::admm_loop_pallas: one launch per
chunk of 8 ADMM iterations, one agent per block with the agent's rows in
shared memory and its Kinv in registers, the static rows as stencils over
the control points, and the plain loop's exit tests and global exit (see
the note at the top of the source for what bounds it). Three template
builds, chosen from the shape: 128 threads with Kinv in registers for
dim·K ≤ 60 (2-D: 56 for LSC, 60 for DLSC, BVC and RSFC), 256 threads
for dim·K ≤ 96 (3-D: 84 and 90), and the memory build `<256,0>` for
every other shape (3-D from M = 11 on, or rows past shared memory):
Kinv read from shared memory or through L2, the rows' state in shared
memory where it fits, else in global memory. Device memory is the
only limit.

The source is compiled at first use by `nvcc` for sm_90a into a shared
library with a plain C entry point under `build/` at the checkout root
(`cuda_build`; the library's name carries a hash of the source, so an
edited source is rebuilt), and loaded with ctypes. `admm_loop_cuda`
takes CUDA tensors only and raises on anything else; `qp.run_loop`
gives it CUDA tensors and CPU tensors to the plain loop. `launches` counts kernel launches,
`build_launches` the launches of each build, keyed by `build_name`
(`<threads,columns>`).
"""

from __future__ import annotations

import ctypes

import torch

from lsc_dr_planner_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "admm.cu"

STENCIL_WIDTH = 3  # nonzeros per static row at most (the acceleration stencil)

launches = 0  # kernel launches (one per chunk) since the last reset
build_launches = {}  # build_name(...) -> its launches since the last reset
_lib = None


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(cuda_build.compile_source(SOURCE, verbose)))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.admm_launch.argtypes = [P] * 26 + [I] * 9 + [F] * 6 + [P]
    lib.admm_launch.restype = I
    lib.admm_smem_bytes.argtypes = [I] * 6
    lib.admm_smem_bytes.restype = ctypes.c_longlong
    lib.admm_blocks_per_sm.argtypes = [I] * 6
    lib.admm_blocks_per_sm.restype = I
    for fn in (lib.admm_threads, lib.admm_columns, lib.admm_placement):
        fn.argtypes = [I] * 6
        fn.restype = I
    _lib = lib
    return lib


def reset_launches():
    global launches
    launches = 0
    build_launches.clear()


def build_name(lib, dim: int, O: int, M: int, N: int, K: int, R_stat: int) -> str:
    """The template build that takes the shape: '<threads,columns>'
    ('<256,0>': the memory build)."""
    shape = (dim, O, M, N, K, R_stat)
    return f"<{lib.admm_threads(*shape)},{lib.admm_columns(*shape)}>"


def placement(lib, dim: int, O: int, M: int, N: int, K: int, R_stat: int) -> dict:
    """Where the build keeps an agent's rows and its Kinv: {"rows":
    "shared" or "global", "kinv": "registers", "shared" or "global"}."""
    shape = (dim, O, M, N, K, R_stat)
    p = lib.admm_placement(*shape)
    kinv = ("registers" if lib.admm_columns(*shape) else "shared" if p & 2 else "global")
    return {"rows": "shared" if p & 1 else "global", "kinv": kinv}


def admm_loop_cuda(li, stencil, N3k, N3kT, rho_lsc: float, max_iter: int, chunk: int,
                   stop_tol: float, sigma: float, alpha: float, eps_abs: float):
    """Queue the kernel on the current stream, one launch per chunk of
    `chunk` iterations (no synchronisation). `li` is a qp.LoopInputs;
    `stencil` the static rows as `qp.stencil_table` tensors (idx, coef,
    rho, adj_ptr, adj_row, adj_coef), `N3k` [K, M*N] and `N3kT` its
    transpose, shared by the fleet.

    ρ is the solver's per-family ρ: `rho_lsc` for every LSC row and
    stencil["rho"] for the static rows (li.rho itself is not read). The
    LSC rows are one-sided: their u is taken as +inf (li.un is read for
    the static rows only). `qp.run_loop` checks that li holds just
    that (`qp.check_kernel_rows`) before it calls this function.

    Returns what the plain loop returns: (xi, z, y, itdone, iters), where
    itdone is the iteration count of each agent's first passed exit test
    (max_iter if none) and iters the iterations run before the global
    exit."""
    global launches
    dev = li.xi.device
    if dev.type != "cuda":
        raise ValueError(f"the ADMM kernel needs CUDA tensors, got {dev}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    A, O, M, dim = li.normals.shape
    K, MN = N3k.shape
    N = MN // M
    dk = dim * K
    R = li.ln.shape[-1]
    R_stat = R - O * MN
    nnz = stencil["adj_row"].shape[0]
    if MN != M * N:
        raise ValueError(f"N3k {tuple(N3k.shape)} does not fit normals {tuple(li.normals.shape)}")
    expect = {
        "normals": (A, O, M, dim), "Kinv": (A, dk, dk), "Pn": (A, K, K),
        "qn": (A, dim, K), "ln": (A, R), "un": (A, R), "scale": (A, R),
        "xi": (A, dim, K), "z": (A, R), "y": (A, R),
    }
    tensors = {name: (getattr(li, name), torch.float32) for name in expect}
    expect.update(N3k=(K, MN), N3kT=(MN, K), idx=(R_stat, STENCIL_WIDTH),
                  coef=(R_stat, STENCIL_WIDTH), rho=(R_stat,), adj_ptr=(dim * MN + 1,),
                  adj_row=(nnz,), adj_coef=(nnz,))
    tensors.update(N3k=(N3k, torch.float32), N3kT=(N3kT, torch.float32))
    tensors.update({k: (v, torch.int32 if k in ("idx", "adj_ptr", "adj_row") else torch.float32)
                    for k, v in stencil.items()})
    for name, (t, dtype) in tensors.items():
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: need {dtype} on {dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {expect[name]} "
                             f"(R_stat = {R_stat} static rows)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if A < 1:
        raise ValueError("empty batch")

    lib = build()
    n_chunks = max(1, -(-max_iter // chunk))
    xi = torch.empty_like(li.xi)
    z = torch.empty_like(li.z)
    y = torch.empty_like(li.y)
    ax = torch.empty_like(li.z)
    best = torch.empty(A, dtype=torch.float32, device=dev)
    noimp = torch.empty(A, dtype=torch.int32, device=dev)
    itdone = torch.empty(A, dtype=torch.int32, device=dev)
    done_count = torch.zeros(n_chunks, dtype=torch.int32, device=dev)
    st = stencil
    # the scratch tensors may be freed while the launches are in flight:
    # the caching allocator only reuses their memory for later work on
    # this stream, which runs after them
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.admm_launch(
            li.normals.data_ptr(), li.Kinv.data_ptr(), li.Pn.data_ptr(), li.qn.data_ptr(),
            li.ln.data_ptr(), li.un.data_ptr(), li.scale.data_ptr(), li.xi.data_ptr(),
            li.z.data_ptr(), li.y.data_ptr(), st["idx"].data_ptr(), st["coef"].data_ptr(),
            st["rho"].data_ptr(), st["adj_ptr"].data_ptr(), st["adj_row"].data_ptr(),
            st["adj_coef"].data_ptr(), N3k.data_ptr(), N3kT.data_ptr(),
            xi.data_ptr(), z.data_ptr(), y.data_ptr(), ax.data_ptr(),
            best.data_ptr(), noimp.data_ptr(), itdone.data_ptr(), done_count.data_ptr(),
            A, dim, O, M, N, K, R_stat, max_iter, chunk,
            rho_lsc, stop_tol, sigma, alpha, 1 - alpha, eps_abs, stream)
    if rc != 0:
        raise RuntimeError(f"admm_launch failed: CUDA error {rc}")
    launches += n_chunks
    name = build_name(lib, dim, O, M, N, K, R_stat)
    build_launches[name] = build_launches.get(name, 0) + n_chunks
    # chunks run: through the first test every agent passed (every later
    # launch returned at once), else all
    all_done = done_count == A
    ran = torch.where(all_done.any(), all_done.int().argmax() + 1, n_chunks)
    return xi, z, y, itdone, (ran * chunk).to(torch.int32)
