"""Wrapper of the hand-written Hopper QP-preparation kernel (`csrc/qp_prepare.cu`).

The kernel computes in one launch everything `qp.prepare` computes
before the ADMM loop, one block per agent: the pins and their particular
solution, every row's bounds, ρ, scale and pin offset, the reduced cost,
the KKT matrix and its inverse (in double), and the warm start. It
replaces the pre-loop body of the JAX package's
lsc_dr_planner_tpu/ops/qp.py::solve (:498-571, `jnp` with a batched
Cholesky; no Pallas original); see the note at the top of the source
for the layout and what bounds it. The KKT matrix's tiles stay in
shared memory while they fit there (dim·K up to ~216 in 3-D); above
that the global build (`GLOBAL_BUILD`: blocks of 512 threads, two an
SM, every warp on every stage) keeps them in a per-agent float64
workspace the wrapper allocates. Device memory is the only limit on
dim·K.

`prepare_cuda` takes CUDA tensors only, of any strides, and raises
ValueError on anything else; `qp.prepare` gives it CUDA tensors and CPU
tensors to the plain body. The source is compiled at first use by
`cuda_build` into `build/` and loaded with ctypes. `launches` counts
kernel launches since `reset_launches()`, `build_launches` those of
each build, keyed by `build_name`.
"""

from __future__ import annotations

import ctypes

import torch

from lsc_dr_planner_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "qp_prepare.cu"

launches = 0  # qp_prepare kernel launches since the last reset
build_launches = {}  # build_name(...) -> its launches since the last reset
GLOBAL_BUILD = "<2,global>"  # the tiles in the workspace, two blocks an SM
SMEM_OPTIN = 232448  # bytes of shared memory a block may opt in to on the H100
_lib = None
_builds = {}  # (dim, O, M, N, K) -> (workspace doubles an agent, build name)


class _Tin(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("s", ctypes.c_longlong * 4)]


_INPUTS = ("p0", "v0", "a0", "goal", "terminal_mask", "lsc_normals", "lsc_rhs", "lsc_active",
           "vmax", "amax", "lb", "ub", "comm_halfrange", "x0", "y0")
_STATICS = ("X_pin", "P_blk", "N_null", "N3k", "Pn_base", "T_term", "G_stat", "T_lsc",
            "kernel_rho", "An_statT", "st_idx")
# the outputs in the kernel's order: qp.LoopInputs' and qp.Prepared's fields
OUTPUTS = ("normals", "Kinv", "Pn", "qn", "ln", "un", "rho", "scale", "xi", "z", "y",
           "xpart", "b_off", "l", "u", "tvec", "qflat", "info")
_SIZES = ("A", "dim", "O", "M", "N", "K", "phi", "R_stat", "use_comm")
_SCALARS = ("vel", "acc", "vcap", "acap", "tdiag", "q", "rho_lsc", "sigma")


class _Args(ctypes.Structure):
    """The source's PrepArgs, field for field."""
    _fields_ = ([(name, _Tin) for name in _INPUTS]
                + [(name, ctypes.c_void_p) for name in _STATICS]
                + [(name, ctypes.c_void_p) for name in OUTPUTS]
                + [("kmat", ctypes.c_void_p), ("work", ctypes.c_void_p)]
                + [(name, ctypes.c_int) for name in _SIZES]
                + [(name, ctypes.c_float) for name in _SCALARS])


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(cuda_build.compile_source(SOURCE, verbose)))
    I = ctypes.c_int
    lib.qp_prepare_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.qp_prepare_launch.restype = I
    lib.qp_prepare_args_size.restype = ctypes.c_longlong
    lib.qp_prepare_work_doubles.argtypes = [I] * 5
    lib.qp_prepare_work_doubles.restype = ctypes.c_longlong
    lib.qp_prepare_build.argtypes = [I] * 5
    lib.qp_prepare_build.restype = I
    lib.qp_prepare_smem_bytes.argtypes = [I] * 5
    lib.qp_prepare_smem_bytes.restype = ctypes.c_longlong
    lib.qp_prepare_blocks_per_sm.argtypes = [I] * 5
    lib.qp_prepare_blocks_per_sm.restype = I
    if lib.qp_prepare_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(f"qp_prepare.cu's PrepArgs is {lib.qp_prepare_args_size()} bytes, "
                           f"its mirror here {ctypes.sizeof(_Args)}")
    _lib = lib
    return lib


def reset_launches():
    global launches
    launches = 0
    build_launches.clear()


def _build_of(dim: int, O: int, M: int, N: int, K: int):
    key = (dim, O, M, N, K)
    if key not in _builds:
        lib = build()
        n_work = lib.qp_prepare_work_doubles(*key)
        blocks = lib.qp_prepare_build(*key)
        name = f"<{blocks},global>" if n_work else f"<{blocks}>"
        _builds[key] = (n_work, name)
    return _builds[key]


def tiles_in_workspace(dim: int, O: int, M: int, N: int, K: int,
                       smem_limit: int = SMEM_OPTIN) -> bool:
    """Whether the shape takes the global build: a `<8>` or `<4>` block
    (qp_prepare.cu's smem_bytes: the lower tiles and the staged column in
    double, the float32 vectors) passes `smem_limit` bytes of shared
    memory. Pure Python; the library's qp_prepare_work_doubles decides."""
    MN, dk = M * N, dim * K
    nT = -(-dk // 8)
    xb = max(64 * (nT - 1) + 8 * nT, (K * K + 1) // 2)
    floats = M * dim * dim + 2 * dim * MN + O * M * dim + dk + 3 * dim + M + 2
    return 8 * (64 * nT * (nT + 1) // 2 + xb) + 4 * floats > smem_limit


def build_name(dim: int, O: int, M: int, N: int, K: int) -> str:
    """The template build that takes the shape: '<8>' (up to 8 tile rows),
    '<4>' (above, the tiles in shared memory) or GLOBAL_BUILD (the tiles
    in the workspace)."""
    return _build_of(dim, O, M, N, K)[1]


def _input(name, t, dtype, shape, dev):
    """A _Tin of tensor t after checking its device, type and shape."""
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name}: need {dtype} on {dev}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    return _Tin(t.data_ptr(), (ctypes.c_longlong * 4)(*t.stride(), *[0] * (4 - t.dim())))


def prepare_cuda(cfg, ts, inp, scalars, kmat=None):
    """Queue the preparation of A agents' QPs on the current stream (one
    launch, no synchronisation). cfg: the qp.QPConfig; ts:
    qp.torch_statics(cfg, device); inp: qp.QPInputs of float32 tensors
    (lsc_active bool) on that device, of any strides; scalars:
    `qp.prepare_scalars(cfg)`; kmat: None, or a contiguous float64 [A, dk,
    dk] tensor that receives each agent's KKT matrix as the kernel
    assembled it (for checks). Returns {name: tensor} for `OUTPUTS`:
    qp.LoopInputs' and qp.Prepared's fields (`info` int32 [A], 0 where
    the KKT matrix factored, else the order of its first non-positive
    pivot, with a NaN Kinv)."""
    global launches
    dev = inp.p0.device
    if dev.type != "cuda":
        raise ValueError(f"the QP preparation kernel needs CUDA tensors, got {dev}")
    A, dim, O, M, N, K = inp.p0.shape[0], cfg.dim, cfg.n_obs, cfg.M, cfg.N, ts["K"]
    MN, dk = M * N, cfg.dim * K
    R_stat = ts["stencil"]["idx"].shape[0]
    R = O * MN + R_stat
    if A < 1:
        raise ValueError("empty batch")
    if cfg.phi != 3:
        raise ValueError(f"the kernel pins 3 control points, got phi = {cfg.phi}")
    f32 = torch.float32
    shapes = {"p0": (A, dim), "v0": (A, dim), "a0": (A, dim), "goal": (A, dim),
              "terminal_mask": (A, M), "lsc_normals": (A, O, M, dim), "lsc_rhs": (A, O, M, N),
              "lsc_active": (A, O, M, N), "vmax": (A, dim), "amax": (A, dim),
              "lb": (A, dim, M, N), "ub": (A, dim, M, N), "comm_halfrange": (A,),
              "x0": (A, dim, M, N), "y0": (A, R)}
    args = {}
    for name, shape in shapes.items():
        t = getattr(inp, name)
        if t is None and name == "y0":
            args[name] = _Tin(None, (ctypes.c_longlong * 4)())
            continue
        args[name] = _input(name, t, torch.bool if name == "lsc_active" else f32, shape, dev)
    lib = build()
    if dim not in (2, 3) or O < 1 or cfg.n < 2:
        raise ValueError(f"the kernel takes dim 2 or 3, O >= 1 and n >= 2, got dim = {dim}, "
                         f"O = {O}, n = {cfg.n}")
    statics = {**ts["prep"], "st_idx": ts["stencil"]["idx"]}
    for name, t in statics.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"static {name}: need a contiguous tensor on {dev}")
    out = {name: torch.empty(shape, dtype=f32, device=dev) for name, shape in (
        ("normals", (A, O, M, dim)), ("Kinv", (A, dk, dk)), ("Pn", (A, K, K)),
        ("qn", (A, dim, K)), *((n, (A, R)) for n in ("ln", "un", "rho", "scale")),
        ("xi", (A, dim, K)), ("z", (A, R)), ("y", (A, R)), ("xpart", (A, dim, MN)),
        *((n, (A, R)) for n in ("b_off", "l", "u")), ("tvec", (A, 1, MN)),
        ("qflat", (A, dim, MN)))}
    out["info"] = torch.empty(A, dtype=torch.int32, device=dev)
    if kmat is not None:
        _input("kmat", kmat, torch.float64, (A, dk, dk), dev)
        if not kmat.is_contiguous():
            raise ValueError("kmat: not contiguous")
    # the global build's tiles (freed while the launch is in flight: the
    # caching allocator reuses its memory only for later work on this stream)
    n_work, name = _build_of(dim, O, M, N, K)
    work = torch.empty((A, n_work), dtype=torch.float64, device=dev) if n_work else None
    a = _Args(**args, **{k: t.data_ptr() for k, t in statics.items()},
              **{k: t.data_ptr() for k, t in out.items()},
              kmat=None if kmat is None else kmat.data_ptr(),
              work=None if work is None else work.data_ptr(),
              A=A, dim=dim, O=O, M=M, N=N, K=K, phi=cfg.phi, R_stat=R_stat,
              use_comm=int(cfg.use_comm), **{k: scalars[k] for k in _SCALARS})
    with torch.cuda.device(dev):
        rc = lib.qp_prepare_launch(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qp_prepare_launch failed: CUDA error {rc}")
    launches += 1
    build_launches[name] = build_launches.get(name, 0) + 1
    return out
