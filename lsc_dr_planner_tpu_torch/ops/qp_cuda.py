"""Wrapper of the hand-written Hopper ADMM kernel (`csrc/admm.cu`).

The kernel replaces the TPU kernel
lsc_dr_planner_tpu/ops/qp_pallas.py::admm_loop_pallas: one launch per
chunk of 8 ADMM iterations, the static rows as stencils over the control
points, and the plain loop's exit tests and global exit (see the note at
the top of the source for what bounds it). Six builds: one agent a
block with its rows in shared memory and its Kinv in registers, 128
threads for dim·K ≤ 60 (2-D: 56 for LSC, 60 for DLSC, BVC and RSFC) and
the triple build for dim·K 61–96 (3-D: 84 and 90), each Kinv row and
each N3k product's output on three threads, 288 threads up to dim·K 90
(four blocks an SM) and 320 above (`triple_plan`), chosen from the
shape; past them (3-D from M = 11 on, Bézier degree 8, or rows past one
block's shared memory) `loop_plan` chooses from the shape and the batch: the
memory build `<256,0>` (one agent a block, its rows and Kinv in shared
memory) where two such blocks fit an SM and the batch fills every SM
twice, else the cluster build `<256,cluster>`: one agent on a
thread-block cluster of C = 2, 4 or 8 CTAs of 256 threads, its LSC slots
and static rows cut into GROUPS fixed groups, each CTA holding 8/C of
them and 1/C of Kinv's rows in its own shared memory, the partial sums
exchanged over distributed shared memory; its result does not depend on
C. `cluster_plan` chooses C from the shape, the batch and the device's
shared memory and resident clusters. A shape the cluster build cannot
take (its rows and Kinv past 8 CTAs, or a CTA's stencil tables past
16-bit indices) goes to the global build `<256,0,global>`: one agent a
block, two blocks an SM, its rows and Kinv streamed from global memory
through a ring of tiles in shared memory (`global_tile_plan`), one pass
over the rows an iteration, in the cluster build's order of operations:
its result is the cluster build's bits at every shape both take.

The source is compiled at first use by `nvcc` for sm_90a into a shared
library with a plain C entry point under `build/` at the checkout root
(`cuda_build`; the library's name carries a hash of the source, so an
edited source is rebuilt), and loaded with ctypes. `admm_loop_cuda`
takes CUDA tensors only and raises on anything else, a refused launch
among it (nothing falls back); `qp.run_loop` gives it CUDA tensors and
CPU tensors to the plain loop. `launches` counts kernel launches,
`build_launches` the launches of each build, keyed by `build_name`
(`<threads,columns>`: `<128,30>`, the triple build's `<288,30>` and
`<320,32>`; `<256,0>`, `<256,cluster>`, `<256,0,global>`), and
`last_launch` records the last call's build, C, shared bytes a block or
CTA, blocks an SM and resident clusters (cudaOccupancyMaxActiveClusters).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lsc_dr_planner_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "admm.cu"

STENCIL_WIDTH = 3  # nonzeros per static row at most (the acceleration stencil)
TRIPLE_DK = 90  # the largest dim·K of the triple build's nine-warp width (admm.cu kTripleDk)
TRIPLE_SHARED_COLUMNS = 8  # Kinv columns a thread of the triple build reads from shared memory
GROUPS = 8  # the cluster build's fixed groups of LSC slots and static rows (admm.cu kGroups)
CLUSTER_SIZES = (2, 4, 8)  # the portable cluster sizes
CLUSTER_THREADS = 256  # threads of a CTA of the cluster build
SMS = 132  # streaming multiprocessors of the H100
H100_BLOCK_OPTIN = 232448  # shared bytes a block may opt in to on the H100 (227 KB)
# a block's shared bytes when two share an SM: the SM's 228 KB less 1 KB reserved a block
TWO_BLOCK_BYTES = (H100_BLOCK_OPTIN + 1024) // 2 - 1024
GLOBAL_STAGES = 3  # the global build's ring of tiles (admm.cu kGlobalStages)
GLOBAL_STAGE_CAP = 8192  # floats a stage at most (admm.cu kGlobalStageCap)
CLUSTER_BUILD = "<256,cluster>"
MEMORY_BUILD = "<256,0>"  # one agent a block, its rows and Kinv in shared memory
GLOBAL_BUILD = "<256,0,global>"  # one agent a block, its rows and Kinv in global memory
# admm_launch's refusals of a cluster launch
REFUSALS = {-2: "a cluster size other than 0 (the global build), 1 (the memory build), 2, 4 "
                "or 8",
            -3: "a block or CTA past the device's shared memory",
            -4: "clusters that cannot be resident (cudaOccupancyMaxActiveClusters 0)"}

launches = 0  # kernel launches (one per chunk) since the last reset
build_launches = {}  # build_name(...) -> its launches since the last reset
last_launch = {}  # the last call's build, C, n3k, smem_bytes, ctas_per_sm, active_clusters
_lib = None


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(cuda_build.compile_source(SOURCE, verbose)))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.admm_launch.argtypes = [P] * 27 + [I] * 11 + [F] * 6 + [P, ctypes.POINTER(I)]
    lib.admm_launch.restype = I
    lib.admm_smem_bytes.argtypes = [I] * 8
    lib.admm_smem_bytes.restype = ctypes.c_longlong
    lib.admm_blocks_per_sm.argtypes = [I] * 8
    lib.admm_blocks_per_sm.restype = I
    lib.admm_active_clusters.argtypes = [I] * 9
    lib.admm_active_clusters.restype = I
    lib.admm_smem_limit.argtypes = []
    lib.admm_smem_limit.restype = ctypes.c_longlong
    for fn in (lib.admm_threads, lib.admm_columns):
        fn.argtypes = [I] * 6
        fn.restype = I
    _lib = lib
    return lib


def reset_launches():
    global launches
    launches = 0
    build_launches.clear()


def build_name(lib, dim: int, O: int, M: int, N: int, K: int, R_stat: int, A: int) -> str:
    """The build that takes a batch of A agents of the shape:
    '<threads,columns>' (the register builds), MEMORY_BUILD,
    CLUSTER_BUILD or GLOBAL_BUILD (`loop_plan`)."""
    shape = (dim, O, M, N, K, R_stat)
    columns = lib.admm_columns(*shape)
    if columns:
        return f"<{lib.admm_threads(*shape)},{columns}>"
    return loop_plan(shape, A, lib.admm_smem_limit())[0]


def triple_block_bytes(dim: int, O: int, M: int, N: int, K: int, R_stat: int) -> int:
    """Dynamic shared memory of one block of the triple build: admm.cu's
    triple_smem_floats, in bytes (doubles: the control points and rhs, ξ̃
    and the adjoint points, the ten-warp width's rhs and ξ̃ padded by 2 +
    3·dim; the normals; the rows' z, y, A·xi, l and the static rows' u;
    the dk-vectors; the segment of each control point; the Kinv columns
    past the threads' registers, TRIPLE_SHARED_COLUMNS a thread of each
    triple)."""
    MN, dk = M * N, dim * K
    R = O * MN + R_stat
    W = 9 if dk <= TRIPLE_DK else 10
    pad = 2 + 3 * dim if W == 10 else 0
    return 4 * (2 * (2 * dim * MN + dk + pad) + O * M * dim + 4 * R + R_stat + 3 * dk + MN
                + TRIPLE_SHARED_COLUMNS * 30 * W)


def triple_plan(dim: int, O: int, M: int, N: int, K: int, R_stat: int) -> dict:
    """The triple build's block for a shape of dim·K 61–96 (admm.cu's
    build_for and admm_triple_kernel): its threads (nine warps up to
    dim·K 90, ten above), the threads of each Kinv row (three: lanes 0..29
    of each warp, ten triples a warp), the Kinv columns of each thread
    (⌈dk/3⌉), the build's columns a thread (30, 32: its name's), of which
    TRIPLE_SHARED_COLUMNS in shared memory and the rest in registers,
    and its shared bytes (`triple_block_bytes`). Raises ValueError
    outside dim·K 61–96."""
    dk = dim * K
    if not 60 < dk <= 96:
        raise ValueError(f"dim·K {dk}: the triple build takes 61–96")
    W = 9 if dk <= TRIPLE_DK else 10
    return {"threads": 32 * W, "threads_a_row": 3, "rows_in_registers": 10 * W,
            "columns": -(-dk // 3), "build_columns": 30 if W == 9 else 32,
            "shared_columns": TRIPLE_SHARED_COLUMNS,
            "smem_bytes": triple_block_bytes(dim, O, M, N, K, R_stat)}


def placement(lib, dim: int, O: int, M: int, N: int, K: int, R_stat: int) -> dict:
    """Where the shape's builds keep an agent's rows and its Kinv, whatever
    the batch: {"rows": "shared", "kinv": "registers"} (the register
    builds), {"rows": "shared", "kinv": "shared"} (the memory build: one
    block's; the cluster build: split over its CTAs' shared memory) or
    {"rows": "global", "kinv": "global"} (the global build: the shapes the
    cluster build cannot take, `cluster_reach`; streamed through shared
    memory a tile at a time)."""
    shape = (dim, O, M, N, K, R_stat)
    if lib.admm_columns(*shape):
        return {"rows": "shared", "kinv": "registers"}
    where = "shared" if cluster_reach(shape, lib.admm_smem_limit()) else "global"
    return {"rows": where, "kinv": where}


# ---- the cluster build's plan (pure Python: the CPU tests check it) ----------


def cluster_cta_bytes(dim: int, O: int, M: int, N: int, K: int, R_stat: int, C: int,
                      n3k: bool) -> int:
    """Dynamic shared memory of one CTA of the cluster build at cluster
    size C, N3k staged or not: admm.cu's cluster_smem_floats, in bytes
    (doubles VD, rhs, ξ̃, the group partials and the accumulator; the
    dk-vectors; the rows of 8/C groups; their slots' normals; ⌈dk/C⌉ rows
    of Kinv; N3k at an odd row stride; the static rows' stencils and ρ and
    the groups' transposed stencils, their indices in 16 bits; the segment
    of each control point)."""
    MN, dk = M * N, dim * K
    nv = dim * MN
    gpc = GROUPS // C
    slots = gpc * -(-O // GROUPS)
    stat = gpc * -(-R_stat // GROUPS)
    kr = -(-dk // C)
    rows = slots * MN + stat
    halves = 6 * stat + (gpc + 1) * nv
    floats = (2 * (nv * (2 + gpc) + 2 * dk) + 3 * dk + 8 * (CLUSTER_THREADS // 32) + 8
              + 4 * rows + stat + slots * M * dim + kr * dk + (K * (MN | 1) if n3k else 0)
              + 7 * stat + MN + (halves + 1) // 2)
    return 4 * floats


def memory_block_bytes(dim: int, O: int, M: int, N: int, K: int, R_stat: int) -> int:
    """Dynamic shared memory of one block of the memory build: admm.cu's
    smem_floats with Kinv, in bytes (the rows' z, y, A·xi, l and the
    static rows' u; the normals; the dk- and dim·MN-vectors; Kinv)."""
    MN, dk = M * N, dim * K
    R = O * MN + R_stat
    return 4 * (4 * R + R_stat + O * M * dim + 5 * dk + 3 * dim * MN
                + 8 * (CLUSTER_THREADS // 32) + MN + dk * dk)


def ctas_per_sm(cta_bytes: int, smem_limit: int) -> int:
    """CTAs of `cta_bytes` that an SM's shared memory holds: the opt-in
    limit a block may take and 1 KB more make the SM's (227 + 1 KB on the
    H100), and each CTA reserves 1 KB."""
    return (smem_limit + 1024) // (cta_bytes + 1024)


def stage_n3k(shape, C: int, smem_limit: int) -> bool:
    """Whether the cluster build stages N3k at cluster size C: where two
    CTAs still fit an SM with it (one, where two never fit), the most its
    registers allow (__launch_bounds__(256, 2))."""
    two = ctas_per_sm(cluster_cta_bytes(*shape, C, False), smem_limit) >= 2
    return ctas_per_sm(cluster_cta_bytes(*shape, C, True), smem_limit) >= (2 if two else 1)


def cluster_plan(shape, A: int, smem_limit: int, sms: int = SMS, resident=None):
    """(C, n3k, bytes a CTA) of the cluster build for a batch of A agents
    of `shape` (dim, O, M, N, K, R_stat) on a device whose block may opt in
    to `smem_limit` bytes of shared memory: the smallest C of 2, 4, 8 at
    which two CTAs fit an SM (8 where none does); then, for a batch of
    fewer than `sms` CTAs, C doubled up to 8 while the batch keeps at most
    2·sms CTAs and, where `resident(C)` gives the clusters of C CTAs the
    device holds at once (cudaOccupancyMaxActiveClusters), while they all
    stay resident (the H100 holds 62 clusters of 4, not 64: the 64-agent
    rescue would run in two waves); N3k staged where two CTAs still fit an
    SM (`stage_n3k`). Raises ValueError for a shape whose CTA passes
    `smem_limit` even at C = 8, or whose CTA's stencil tables pass 16-bit
    indices."""
    fits = [C for C in CLUSTER_SIZES
            if ctas_per_sm(cluster_cta_bytes(*shape, C, False), smem_limit) >= 2]
    C = fits[0] if fits else CLUSTER_SIZES[-1]
    while (A * C < sms and C < CLUSTER_SIZES[-1] and A * 2 * C <= 2 * sms
           and (resident is None or A <= resident(2 * C))):
        C *= 2
    dim, O, M, N, K, R_stat = shape
    if 3 * R_stat >= 1 << 16 or dim * M * N >= 1 << 16:
        raise ValueError(f"ADMM shape {tuple(shape)}: a CTA's stencil tables pass 16-bit "
                         "indices (the cluster build's reach)")
    n3k = stage_n3k(shape, C, smem_limit)
    nbytes = cluster_cta_bytes(*shape, C, n3k)
    if nbytes > smem_limit:
        raise ValueError(
            f"ADMM shape {tuple(shape)}: one agent's rows and Kinv need {nbytes} B a CTA "
            f"at C = {C}, past the {smem_limit} B a block may take (the cluster build's reach)")
    return C, n3k, nbytes


def slot_parts_log2(G: int) -> int:
    """Threads (2^lps) that share one (group, control point) item of the
    LSC rows when a group holds G slots (admm.cu's slot_parts_log2)."""
    return 2 if G >= 12 else 1 if G >= 6 else 0


def _r4(n: int) -> int:
    return (n + 3) & ~3


def _lsc_tile_floats(dim, M, MN, slots):
    """A ring stage's floats for an LSC tile of `slots` slots: z, y, A·xi,
    l and scale of its rows and its slots' normals, each region 16-B
    aligned with room for a head of up to 3 floats."""
    return 5 * _r4(slots * MN + 3) + _r4(slots * M * dim + 3)


def global_tile_plan(dim: int, O: int, M: int, N: int, K: int, R_stat: int) -> dict:
    """The global build's tiles (admm.cu's global_plan). A block streams
    one agent's rows and Kinv from global memory through a ring of
    GLOBAL_STAGES stages in shared memory, in the cluster build's GROUPS
    fixed groups (G = ⌈O/8⌉ slots and GS = ⌈R_stat/8⌉ static rows a
    group): each group's LSC rows in tiles of T whole slots, then its
    static rows in tiles of ST; Kinv in tiles of KT rows. What stays in
    shared memory (`resident` floats): the control points, the running sum
    of the group partials, the group's partial and the accumulator (dim·MN
    doubles each), rhs and ξ̃ (dk doubles), the LSC items' partials across
    tiles (3 doubles a thread-item, `ntrips` a thread), the stages'
    mbarriers, the dk-vectors, the group's static-row cotangents, the
    reductions, the segment of each control point and the groups' tile
    table. A stage takes what leaves two blocks an SM in the
    H100's shared memory (one, where two never fit), at most
    GLOBAL_STAGE_CAP floats. Raises ValueError for a shape whose block
    cannot hold one slot's tile."""
    MN, dk, nv = M * N, dim * K, dim * M * N
    G, GS = -(-O // GROUPS), -(-R_stat // GROUPS)
    lps = slot_parts_log2(G)
    n2 = ((MN << lps) + 31) & ~31
    ntrips = -(-n2 // CLUSTER_THREADS)
    resident = _r4(2 * (4 * nv + 2 * dk + 3 * CLUSTER_THREADS * ntrips + GLOBAL_STAGES) + 3 * dk
                   + GS + 8 * (CLUSTER_THREADS // 32) + MN + 2 * GROUPS + 1)
    need = max(_lsc_tile_floats(dim, M, MN, 1), 6 * _r4(1 + 3), _r4(dk + 3))
    for blocks, budget in ((2, TWO_BLOCK_BYTES), (1, H100_BLOCK_OPTIN)):
        stage = min(GLOBAL_STAGE_CAP, (budget // 4 - resident) // GLOBAL_STAGES) & ~3
        if stage >= need:
            break
    else:
        raise ValueError(f"ADMM shape {(dim, O, M, N, K, R_stat)}: one slot's tile does not fit "
                         "a block beside what the global build keeps in shared memory")
    T = max(t for t in range(1, G + 1) if _lsc_tile_floats(dim, M, MN, t) <= stage)
    ST = max(s for s in range(1, GS + 1) if 6 * _r4(s + 3) <= stage)
    KT = max(k for k in range(1, dk + 1) if _r4(k * dk + 3) <= stage)
    jobs, per_group = [], []
    for j in range(GROUPS):
        oa = min(O, j * G)
        ob = min(O, oa + G)
        sa = min(R_stat, j * GS)
        sb = min(R_stat, sa + GS)
        tiles = ([(j, "lsc", u, min(ob, u + T)) for u in range(oa, ob, T)]
                 + [(j, "static", q, min(sb, q + ST)) for q in range(sa, sb, ST)])
        jobs += tiles
        per_group.append(len(tiles))
    n_kinv = -(-dk // KT)
    # a row is read again only after its group's tiles are done (and their
    # stores fenced): GLOBAL_STAGES − 1 tiles a pass outside any one group
    if n_kinv + len(jobs) - max(per_group) < GLOBAL_STAGES - 1:
        raise ValueError(f"ADMM shape {(dim, O, M, N, K, R_stat)}: too few tiles a pass "
                         "outside one group for the ring's stages")
    return {"G": G, "GS": GS, "lps": lps, "n2": n2, "ntrips": ntrips, "T": T, "ST": ST,
            "KT": KT, "stage": stage, "stages": GLOBAL_STAGES, "resident": resident,
            "n_kinv": n_kinv, "row_jobs": jobs, "blocks_per_sm": blocks,
            "smem_bytes": 4 * (resident + GLOBAL_STAGES * stage)}


def copy_split(offset: int, n: int):
    """How the global build copies n floats that start `offset` floats
    past a 16-B boundary into a 16-B aligned region of a stage (admm.cu's
    issue_copy): the data at `head` = offset mod 4 floats into the region
    (so that source and destination agree mod 16 B), `pre` floats copied
    4 B at a time up to the source's next 16-B boundary, `body` 16-B units
    in one bulk copy (aligned at both ends), `tail` floats of 4 B. Returns
    (head, pre, body, tail)."""
    head = offset & 3
    pre = min(n, (4 - head) & 3)
    return head, pre, (n - pre) >> 2, (n - pre) & 3


def global_block_bytes(dim: int, O: int, M: int, N: int, K: int, R_stat: int) -> int:
    """Dynamic shared memory of one block of the global build: what it
    keeps and its ring's stages (`global_tile_plan`), in bytes."""
    return global_tile_plan(dim, O, M, N, K, R_stat)["smem_bytes"]


def cluster_reach(shape, smem_limit: int) -> bool:
    """Whether the cluster build takes `shape` at all, which no batch
    changes: `cluster_plan` refuses a shape whose CTA passes `smem_limit`
    even at C = 8 or whose stencil tables pass 16-bit indices, for every
    batch alike."""
    try:
        cluster_plan(shape, 1, smem_limit)
    except ValueError:
        return False
    return True


def loop_plan(shape, A: int, smem_limit: int, sms: int = SMS, resident=None):
    """(build, C, n3k, bytes a block) of a batch of A agents of `shape`
    past the register builds: the memory build (C = 1) where one agent's
    block holds two an SM and the batch fills every SM twice (A ≥ 2·sms:
    there, splitting an agent over a cluster halves the agents an SM holds,
    and Bézier degree 8's 1,024 agents ran 12.1 ms on the memory build
    against 21.8 ms on the cluster build on the H100; PERF.md §6); else the
    cluster build at `cluster_plan`'s C; and where `cluster_plan` refuses
    the shape, the global build (C = 0), which takes any shape whose block
    holds one slot's tile (`global_tile_plan` raises ValueError past
    that)."""
    nbytes = memory_block_bytes(*shape)
    if A >= 2 * sms and ctas_per_sm(nbytes, smem_limit) >= 2:
        return MEMORY_BUILD, 1, False, nbytes
    if not cluster_reach(shape, smem_limit):
        return GLOBAL_BUILD, 0, False, global_block_bytes(*shape)
    return (CLUSTER_BUILD, *cluster_plan(shape, A, smem_limit, sms, resident))


def group_rows(O: int, R_stat: int, C: int):
    """For each CTA of a cluster of C: (its groups, its LSC slots [o0, o1),
    its static rows [s0, s1)), as admm.cu's own_rows cuts them: GROUPS
    groups of ⌈O/8⌉ slots and ⌈R_stat/8⌉ static rows whatever C, CTA c
    holding groups c·8/C .. (c+1)·8/C − 1."""
    gpc, G, GS = GROUPS // C, -(-O // GROUPS), -(-R_stat // GROUPS)
    out = []
    for c in range(C):
        g0 = c * gpc
        o0, s0 = min(O, g0 * G), min(R_stat, g0 * GS)
        out.append((tuple(range(g0, g0 + gpc)), (o0, min(O, o0 + gpc * G)),
                    (s0, min(R_stat, s0 + gpc * GS))))
    return out


def group_ptr(adj_ptr: np.ndarray, adj_row: np.ndarray, R_stat: int) -> np.ndarray:
    """The transposed stencils restricted to each group, for the cluster
    build: int32 [(GROUPS + 1)·n_points], entry j·n_points + i the first
    entry of control point i's column (adj_ptr, adj_row: rows ascending)
    whose static row is in group j or later (row ≥ j·⌈R_stat/8⌉); group j's
    entries of column i are [ptr[j·n + i], ptr[(j+1)·n + i])."""
    GS = -(-R_stat // GROUPS)
    n = len(adj_ptr) - 1
    out = np.empty((GROUPS + 1, n), np.int32)
    for i in range(n):
        rows = adj_row[adj_ptr[i]:adj_ptr[i + 1]]
        out[:, i] = adj_ptr[i] + np.searchsorted(rows, np.arange(GROUPS + 1) * GS)
    return out.reshape(-1)


@functools.lru_cache(maxsize=None)
def _plan_record(shape, A: int, device_index: int):
    lib = build()
    with torch.cuda.device(device_index):
        limit = lib.admm_smem_limit()

        def resident(C):
            return lib.admm_active_clusters(*shape, A, C, int(stage_n3k(shape, C, limit)))

        if lib.admm_columns(*shape):
            name, C, n3k = f"<{lib.admm_threads(*shape)},{lib.admm_columns(*shape)}>", 1, False
        else:
            name, C, n3k, _ = loop_plan(shape, A, limit, resident=resident)
        if name != CLUSTER_BUILD:
            return {"build": name, "C": C, "n3k": False,
                    "smem_bytes": lib.admm_smem_bytes(*shape, C, 0),
                    "ctas_per_sm": lib.admm_blocks_per_sm(*shape, C, 0), "active_clusters": None}
        nbytes = cluster_cta_bytes(*shape, C, n3k)
        return {"build": name, "C": C, "n3k": n3k, "smem_bytes": nbytes,
                "ctas_per_sm": lib.admm_blocks_per_sm(*shape, C, int(n3k)),
                "active_clusters": lib.admm_active_clusters(*shape, A, C, int(n3k))}


def launch_plan(shape, A: int, device=None) -> dict:
    """The build that takes a batch of A agents of `shape` (dim, O, M, N,
    K, R_stat) on the current (or the given) CUDA device: {"build", "C"
    (1: one agent a block; 0: the global build's block), "n3k",
    "smem_bytes" a block or CTA (the
    kernel library's own count), "ctas_per_sm" (blocks an SM: agents of
    one-block builds, CTAs of the cluster build), "active_clusters"
    (cudaOccupancyMaxActiveClusters; None for one-block builds)}."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    return dict(_plan_record(tuple(int(v) for v in shape), int(A), dev.index or 0))


def admm_loop_cuda(li, stencil, N3k, N3kT, rho_lsc: float, max_iter: int, chunk: int,
                   stop_tol: float, sigma: float, alpha: float, eps_abs: float, C=None):
    """Queue the kernel on the current stream, one launch per chunk of
    `chunk` iterations (no synchronisation). `li` is a qp.LoopInputs;
    `stencil` the static rows as `qp.stencil_table` tensors (idx, coef,
    rho, adj_ptr, adj_row, adj_coef, grp_ptr), `N3k` [K, M*N] and `N3kT`
    its transpose, shared by the fleet. `C` sets the build past the
    register builds in place of `loop_plan`'s (for comparisons: 0 the
    global build, 1 the memory build, 2, 4, 8 the cluster build's cluster
    size, N3k then staged as `stage_n3k` says for that C).

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
                  adj_row=(nnz,), adj_coef=(nnz,), grp_ptr=((GROUPS + 1) * dim * MN,))
    tensors.update(N3k=(N3k, torch.float32), N3kT=(N3kT, torch.float32))
    tensors.update({k: (v, torch.int32 if k in ("idx", "adj_ptr", "adj_row", "grp_ptr")
                        else torch.float32) for k, v in stencil.items()})
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
    shape = (dim, O, M, N, K, R_stat)
    plan = launch_plan(shape, A, dev)
    if C is not None and not lib.admm_columns(*shape):
        n3k = C > 1 and stage_n3k(shape, C, lib.admm_smem_limit())
        name = {0: GLOBAL_BUILD, 1: MEMORY_BUILD}.get(C, CLUSTER_BUILD)
        plan.update(build=name, C=C, n3k=n3k,
                    smem_bytes=lib.admm_smem_bytes(*shape, C, int(n3k)),
                    ctas_per_sm=lib.admm_blocks_per_sm(*shape, C, int(n3k)),
                    active_clusters=None)
    n_chunks = max(1, -(-max_iter // chunk))
    xi = torch.empty_like(li.xi)
    z = torch.empty_like(li.z)
    y = torch.empty_like(li.y)
    ax = torch.empty_like(li.z)
    best = torch.empty(A, dtype=torch.float32, device=dev)
    noimp = torch.empty(A, dtype=torch.int32, device=dev)
    itdone = torch.empty(A, dtype=torch.int32, device=dev)
    done_count = torch.zeros(n_chunks, dtype=torch.int32, device=dev)
    clusters = ctypes.c_int(0)
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
            st["adj_coef"].data_ptr(), st["grp_ptr"].data_ptr(), N3k.data_ptr(),
            N3kT.data_ptr(), xi.data_ptr(), z.data_ptr(), y.data_ptr(), ax.data_ptr(),
            best.data_ptr(), noimp.data_ptr(), itdone.data_ptr(), done_count.data_ptr(),
            A, dim, O, M, N, K, R_stat, max_iter, chunk, plan["C"], int(plan["n3k"]),
            rho_lsc, stop_tol, sigma, alpha, 1 - alpha, eps_abs, stream,
            ctypes.byref(clusters))
    if rc != 0:
        why = REFUSALS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"admm_launch failed ({plan['build']}, C = {plan['C']}): {why}")
    launches += n_chunks
    build_launches[plan["build"]] = build_launches.get(plan["build"], 0) + n_chunks
    if plan["build"] == CLUSTER_BUILD:
        plan["active_clusters"] = clusters.value
    last_launch.clear()
    last_launch.update(plan)
    # chunks run: through the first test every agent passed (every later
    # launch returned at once), else all
    all_done = done_count == A
    ran = torch.where(all_done.any(), all_done.int().argmax() + 1, n_chunks)
    return xi, z, y, itdone, (ran * chunk).to(torch.int32)
