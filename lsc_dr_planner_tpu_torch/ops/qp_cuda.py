"""Wrapper of the hand-written Hopper ADMM kernel (`csrc/admm.cu`).

The kernel replaces the TPU kernel
lsc_dr_planner_tpu/ops/qp_pallas.py::admm_loop_pallas: one launch per
chunk of 8 ADMM iterations, one thread block per agent with the agent's
working set in shared memory, and the plain loop's exit tests and global
exit (see the note at the top of the source for what bounds it).

The source is compiled at first use by `nvcc` for sm_90a into a shared
library with a plain C entry point under `build/` at the checkout root,
and loaded with ctypes; the library's name carries a hash of the source,
so an edited source is rebuilt. `admm_loop_cuda` takes CUDA tensors
only and raises on anything else; `qp.run_loop` gives it CUDA tensors
and CPU tensors to the plain loop. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "admm.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches = 0  # kernel launches (one per chunk) since the last reset
build_seconds = None  # wall time of the last nvcc run in this process
_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return str(path)


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    lib_path = BUILD_DIR / f"libadmm_{hashlib.sha256(src).hexdigest()[:12]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr)
        tmp.replace(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.admm_launch.argtypes = [P] * 21 + [I] * 9 + [F] * 5 + [P]
    lib.admm_launch.restype = I
    lib.admm_smem_bytes.argtypes = [I] * 6
    lib.admm_smem_bytes.restype = ctypes.c_longlong
    _lib = lib
    return lib


def admm_loop_cuda(li, An_stat, N3k, max_iter: int, chunk: int, stop_tol: float,
                   sigma: float, alpha: float, eps_abs: float):
    """Queue the kernel on the current stream, one launch per chunk of
    `chunk` iterations (no synchronisation). `li` is a qp.LoopInputs,
    `An_stat` [R_stat, dim*K] and `N3k` [K, M*N] the shared operators.
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
    R_stat, dk = An_stat.shape
    N = MN // M
    if MN != M * N or dk != dim * K:
        raise ValueError(f"An_stat {tuple(An_stat.shape)} / N3k {tuple(N3k.shape)} "
                         f"do not fit normals {tuple(li.normals.shape)}")
    R = O * MN + R_stat
    expect = {
        "normals": (A, O, M, dim), "Kinv": (A, dk, dk), "Pn": (A, K, K),
        "qn": (A, dim, K), "ln": (A, R), "un": (A, R), "rho": (A, R),
        "scale": (A, R), "xi": (A, dim, K), "z": (A, R), "y": (A, R),
    }
    tensors = {name: getattr(li, name) for name in expect}
    tensors.update(An_stat=An_stat, N3k=N3k)
    expect.update(An_stat=(R_stat, dk), N3k=(K, MN))
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {expect[name]}")
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
    # the scratch tensors may be freed while the launches are in flight:
    # the caching allocator only reuses their memory for later work on
    # this stream, which runs after them
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.admm_launch(
            li.normals.data_ptr(), li.Kinv.data_ptr(), li.Pn.data_ptr(), li.qn.data_ptr(),
            li.ln.data_ptr(), li.un.data_ptr(), li.rho.data_ptr(), li.scale.data_ptr(),
            li.xi.data_ptr(), li.z.data_ptr(), li.y.data_ptr(), An_stat.data_ptr(),
            N3k.data_ptr(), xi.data_ptr(), z.data_ptr(), y.data_ptr(), ax.data_ptr(),
            best.data_ptr(), noimp.data_ptr(), itdone.data_ptr(), done_count.data_ptr(),
            A, dim, O, M, N, K, R_stat, max_iter, chunk,
            stop_tol, sigma, alpha, 1 - alpha, eps_abs, stream)
    if rc != 0:
        raise RuntimeError(f"admm_launch failed: CUDA error {rc}")
    launches += n_chunks
    # chunks run: through the first test every agent passed (every later
    # launch returned at once), else all
    all_done = done_count == A
    ran = torch.where(all_done.any(), all_done.int().argmax() + 1, n_chunks)
    return xi, z, y, itdone, (ran * chunk).to(torch.int32)
