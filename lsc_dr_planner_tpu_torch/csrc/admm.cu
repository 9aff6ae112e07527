// ADMM iteration loop of the batched trajectory QP, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel lsc_dr_planner_tpu/ops/qp_pallas.py::admm_loop_pallas
// (pl.pallas_call at :151, body _admm_block_kernel at :218-363). It computes
// what the plain loop lsc_dr_planner_tpu_torch/ops/qp.py::admm_loop_plain (the
// port of the XLA loop ops/qp.py::admm_loop) computes, with the same exit gates
// every `chunk` iterations: row-scaled feasibility, the relative dual residual
// (which the Pallas kernel dropped), iterate stall and objective patience, and
// the same global exit: the loop stops after the first test at which every
// agent is done. (A per-agent exit was measured on the H100 at A=1024: 0.7% of
// the agents then stopped up to 3% above the plain loop's objective and 0.18 m
// away in control points, outside the solver's comparison contract.)
//
// Launches: one per chunk, queued back to back with no host synchronisation.
// Each agent counts itself into done_count[ck] when it passes the test; when
// that count is the whole fleet, every later launch returns at once and
// carries the count on, so the stop holds to the end of the queue and xi, z and
// y stay the iterate of the exit test. Between chunks xi, z, y, A·xi and the
// gate state go to global memory.
//
// The operator. The static rows (velocity, acceleration, comm pairs, bounds)
// are difference stencils over the control points VD_d = N_null·ξ_d, at most 3
// nonzeros a row (ops/qp.py::stencil_table, built from _solver_statics's A_dim
// in its flat row order). The kernel forms VD once per iteration (needed for
// the LSC rows anyway) and reads each static row off it, and the adjoint adds
// the transposed stencils (compressed columns) into the same control-point
// accumulator as the LSC adjoint, so one N3k product brings both back to
// ξ-space. The dense An_stat [R_stat, dk] (92 KB in the bench shape, read twice
// per iteration from L2 by every block in the first version) is gone: an
// iteration of one agent is about 15 k FMAs instead of 60 k, plus ~15 flops
// per row of elementwise update. A static row is a difference of nearby
// points, so the float32 rounding of the points would cost it what the dense
// product does not lose: the points are summed and kept in double, and each
// static row is taken in double from them. Measured
// on the H100 on one A=37 batch, this halved the kernel's per-chunk distance
// to the float64 plain loop, to the float32 plain loop's own, for 4.5% of time.
//
// The layout. Six builds, chosen from the shape (admm_threads,
// admm_columns) and, past the register builds, from the batch too
// (qp_cuda.loop_plan, admm_launch's C), never from a failure:
//   <128, 30>  dim·K ≤ 60: 2-D, 56 for LSC (K = 28, the terminal derivatives
//              pinned) and 60 for DLSC, BVC and RSFC (K = 30); one agent a
//              block, Kinv in registers, thread 2i+h holding half h of row i;
//              the Kinv loop stops at the row's own columns, so dim·K 56 runs
//              the additions of a 28-column build in the same order;
//   <288, 30>, <320, 32>  the triple build, dim·K 61–96: 3-D (84 for LSC,
//              90 for the other modes) and 2-D from M = 11; one agent a
//              block of nine warps up to dim·K 90 (four blocks an SM: 56
//              registers a thread) and ten above (three blocks), each Kinv
//              row, adjoint row and control point on three threads
//              (admm_triple_kernel);
//   <256, 0>   the memory build (C = 1): any other shape whose agent, rows
//              and Kinv in shared memory, fits two blocks an SM, for a batch
//              that fills every SM twice over (A ≥ 264: Bézier degree 8's
//              main batch, 95 KB a block); a thread pair takes rows i, i +
//              128, ... of the Kinv and N3k products;
//   <256, cluster>  every other shape past the register builds, and those
//              shapes in smaller batches (3-D from M = 11 on: dim·K 102 at M
//              = 12, 246 at M = 28; degree 8's 64-agent rescue; rows past one
//              block's shared memory): one agent on a thread-block cluster
//              of C = 2, 4 or 8 CTAs of 256 threads (admm_cluster_kernel);
//   <256, 0, global>  the shapes the cluster build cannot take (C = 0 in
//              admm_launch; 3-D at M = 28 from 432 slots, where an agent's
//              rows and Kinv pass 8 CTAs; a CTA's stencil tables past 16-bit
//              indices): one agent a block of 256 threads, two blocks an SM,
//              its rows and Kinv streamed from global memory through shared
//              memory once an iteration, in the cluster build's order of
//              operations (admm_global_kernel; see "The global build").
// The one-block builds keep an agent's rows in the block's shared memory: z,
// y, A·xi and l over all R rows, u over the static rows only (the LSC rows are
// one-sided: prepare() makes their u +1e20 less an offset, which no iterate
// reaches, so the kernel takes it as +inf), the normals and a few dk- and
// dim·MN-vectors: 27.8 KB in the 2-D bench shape (dim=2, K=28, dk=56, O=16,
// M=10, N=6, R=960+410), 34.0 KB in 3-D (dk=90, R=960+615). ρ is one
// constant for the LSC rows and a shared row vector for the static rows (the
// per-family ρ of _solver_statics, as the Pallas kernel takes it); `scale` is
// read at the exit tests only. They read the shared operators (N3k and its
// transpose, the stencil tables: 18 KB in 2-D) through L1 from every block.
// The 3-D z stencils are rows of the same tables.
//
// The cluster build. What held back the memory build (PERF.md §6, the
// cluster build's step 0): an agent at dim·K 102 with 80 slots (6,534 rows,
// Kinv 41.6 KB) took 166 KB, one block an SM: one agent on 8 warps, each
// phase a dependent chain of 36–80 terms a thread; and the 64-agent rescue
// filled half the SMs.
// Twice the threads with chains halved took 34% off 8f; the operators in
// shared memory 6.5%. Here agent a is the cluster of CTAs a·C .. a·C + C − 1:
//   - the agent's LSC slots and static rows are cut into kGroups = 8 fixed
//     groups (G = ⌈O/8⌉ slots, ⌈R_stat/8⌉ static rows a group, whatever C);
//     CTA c holds the 8/C groups c·8/C .. (c+1)·8/C − 1: their rows' z, y,
//     A·xi, l (and u), their slots' normals, their static rows' stencils and
//     the groups' transposed stencils (qp_cuda.group_ptr, indices in 16 bits)
//     in its own shared memory, and rows [c·⌈dk/C⌉, (c+1)·⌈dk/C⌉) of Kinv;
//     N3k is staged once a CTA (rows padded to an odd stride, read by rows
//     and by columns) where two CTAs still fit an SM with it, else read
//     through L1; the state comes in by cp.async;
//   - an iteration: (1) cluster barrier; every CTA adds the groups' partial
//     Aᵀ(ρz − y), in double, over distributed shared memory in group order,
//     holds the whole accumulator and forms the whole rhs in double; (2)
//     each CTA forms its rows of ξ̃ = Kinv·rhs in double; (3) cluster
//     barrier; all-gather of ξ̃; (4) each CTA forms the control points VD of
//     ξ̃ in double and updates its own rows, a thread an item (group, control
//     point, slot part), forming the next iteration's partials of its groups
//     on the way (of y in the chunk's last iteration: the exit test's Aᵀy).
//     Every dot product is split over threads (a pair for the adjoint and
//     the control points; 2–8 for a Kinv row by dim·K) and four
//     accumulators, combined in a fixed order;
//   - the exit tests: each CTA reduces its rows' violation; CTA 0 reads the
//     partials and the violations over the cluster, tests the agent (Pn
//     staged in its free Kinv rows) and counts it once into done_count; a
//     last cluster barrier keeps every CTA resident until CTA 0 has read its
//     shared memory;
//   - every sum runs over the fixed groups in the same order whichever CTA
//     holds a group, so xi, z, y and itdone are the same bits at every C;
//   - C (qp_cuda.cluster_plan, from the shape and the batch): the smallest of
//     2, 4, 8 at which two CTAs fit an SM (8 where none does), then doubled
//     while the batch has fewer than 132 CTAs, keeps at most 264, and its
//     clusters all stay resident (cudaOccupancyMaxActiveClusters: 62 of 4
//     on the H100, so the 64-agent rescue keeps C = 2 and one wave).
//     admm_launch refuses a C whose CTA passes the device's shared memory or
//     whose clusters cannot be resident; nothing falls back.
// What bounds it: the latency of each CTA's chains at 16 warps an SM (two
// CTAs of 115–123 registers) and the per-launch load and exit test (at 8f,
// C = 2, an iteration ~33 k cycles: row updates with the partials 15.7 k,
// rhs 5.9 k, control points 4.4 k, Kinv 2.6 k, two cluster barriers 3.1 k;
// a launch's load 33 k and exit 36 k; `clock64` marks, PERF.md §6). Splitting
// an agent halves the agents an SM holds where the memory build held two
// (degree 8: 21.8 ms on the cluster build against 12.3 on the memory build
// at A=1024), hence the memory build for full batches of such shapes.
// Rows and Kinv of one agent must fit 8 CTAs' shared memory (~1.8 MB; 8g's
// widest cluster shape, dim·K 246 with 160 slots, takes 187 KB a CTA at C =
// 8), and a CTA's stencil tables 16-bit indices: qp_cuda.loop_plan sends a
// shape past either to <256, 0, global>.
//
// The global build. What held back its first version (one agent a block,
// the rows' state updated in place in global memory, l, u, the normals and
// Kinv read where they lie; 442.5 ms for 8g's 480 slots at A = 481 on the
// H100, PERF.md §6): two passes over an agent's 83,118 rows an iteration
// (the adjoint's, then the row updates'), ~36 B a row, as dependent load
// chains of 16 warps an SM: 0.77 TB/s. An agent's state at that shape (1.76
// MB) cannot stay on chip, so every iteration streams it; the least any
// design moves is one pass: 28 B a row (z, y, A·xi and l in; z, y and A·xi
// out), Kinv and the normals once (2.73 MB an agent-iteration).
// Here: the cluster build's order of operations in one block, as a cluster
// of C = 1 would run it (its 8 fixed groups in turn, the same bits at every
// shape both builds take), one pass over the rows an iteration:
//   - each group's LSC rows in tiles of whole slots, then its static rows,
//     and Kinv in tiles of rows (qp_cuda.global_tile_plan), streamed through
//     a ring of kGlobalStages stages in shared memory by the tensor memory
//     accelerator: bulk copies counted on an mbarrier a stage, issued two
//     tiles ahead by the warps in turn; a source's floats before its first
//     16-B boundary and past its last (an odd agent's rows start 8 B past
//     one at 8g) by 4-B cp.async;
//   - a tile's rows updated in the cluster build's item order (a thread a
//     control point and slot part), z, y and A·xi stored to global memory
//     and the next iteration's group partials formed on the way, an item's
//     partial carried across its group's tiles in shared memory; the static
//     rows updated in their stage, as the cluster build updates them in
//     shared memory (updated in registers, they came out an ulp apart);
//   - the group partials summed in group order as each group completes: the
//     running sum is the cluster build's reduce_partials' additions, so
//     shared memory keeps dim·MN doubles of partials, not 8·dim·MN;
//   - each launch's first pass forms the partials of the state loaded (z, y
//     and the normals in) and, at ck 0, copies the warm start's z, y and
//     A·xi into the loop's buffers; the chunk's last pass reads scale for
//     the exit test's violations; the exit test is the cluster build's;
//   - the rows' stores are fenced from the bulk copies that read them again
//     (another proxy) at the end of each group.
// What bounds it on the H100 (`clock64` marks, PERF.md §6): not the bytes in
// flight (a tile waits ~0.1 k cycles for its copies) but each tile's work:
// an LSC tile of 6 slots takes ~4.2 k cycles (its rows' conversions to and
// from double, loads and stores), the static tiles and the group sums wait
// on L2 for the stencil tables; the block barrier a tile costs ~2% (full
// and empty mbarriers in its place: 139.7 against 143.0 ms at 8g).
//
// The triple build. What held back <256,48>, the build it replaced (PERF.md
// §6, the triple build's step 0: `clock64` marks at 8b, dim·K 84, A =
// 1,024, on an NVIDIA H100 80GB HBM3 at 700 W): three blocks an SM (80
// registers a thread), so 1,024 agents ran in three rounds; an iteration
// ~24.0 k cycles, the Kinv product its shortest phase (2.1 k), the adjoint
// points (5.7 k), the adjoint rows (4.5 k), the control points (3.5 k) and
// the rows (6.8 k) longer, each waiting on L1 and L2: with the carveout at
// all shared memory the SM kept 28 KB of L1 for the tables all its blocks
// read.
// Here: nine warps a block and four blocks an SM (56 registers: 528
// agents resident, 1,024 in two rounds); each Kinv row, adjoint row and
// control point on a triple of lanes (chains of ⌈dk/3⌉, ⌈MN/3⌉, ⌈K/3⌉
// terms), the adjoint points a thread a point (split over a triple they
// took two rounds and ran slower); 8 of a thread's 30 Kinv columns in
// shared memory, and each phase's pointers and indices derived afresh
// (TripleView), for 0 B spilled (a Kinv column spilled to local memory is
// re-read from L2 every iteration); the division y / ρ through a double
// reciprocal, the same bits as the float division without its slow-path
// call; the state loaded by cp.async; and a carveout of the blocks' shared
// memory alone, which leaves 60 KB of L1. 8b's main loop 8.45–8.64 →
// 6.82–6.87 ms; an iteration takes ~25.0 k cycles at four blocks an SM
// and 15.0 k alone on its SM: what the blocks contend for (L1, the FP64
// pipe, the shared-memory ports) is untraced (PERF.md §6, §7). The
// ten-warp width (dim·K 91–96, three blocks an SM) pads rhs and ξ̃ in
// shared memory by part, where the three parts' doubles would share a bank
// (see TripleView::xpad).
//
// Every phase spreads over the block: in the register builds the Kinv matvec
// and the N3k adjoint product run two threads per output, combined with one
// warp shuffle; the control points and the adjoint accumulator one thread per
// (d, mn); rows one thread each; the exit test's eight reductions are one
// warp-shuffle pass and one shared step. No float atomics: an agent's result
// does not depend on which agents share the launch (the rescue compacts
// different agents each step).
//
// Precision. The loop's state (ξ, z, y) is float32, and so are the row
// updates; what sets a dual's fixed point is in double. Per iteration, rhs =
// (σξ − q) + Aᵀ(ρz − y) is formed in double (q and Aᵀ(ρz − y) cancel), the
// adjoint adds its exact products in double, ξ̃ = Kinv·rhs is a double FMA
// chain (each float Kinv entry converted where it is used: hoisted out of the
// iteration loop, the conversions spilled 312 B in 2-D and 520 B in 3-D), and
// the control points of ξ̃ and every row taken from them stay in double until
// the row is rounded once. admm_rounding.py ranks the float32 roundings these
// replace on the CPU (3-D DLSC, A=1024, the worst dual against the float64
// plain loop: rhs alone 2.33 tolerances, ξ̃ 2.41, the LSC rows 1.03, all of the
// kernel's float32 steps 4.30, those it keeps 0.041, the float32 plain loop
// 150). On the H100 (chip_smoke.py::admm_sums_main, phase 8e's DLSC 3-D state
// and twelve copies moved by 1e-6 m, KKT condition ~1.6e5): the whole run's
// float64 ratio went from 1.44–5.23 (one state over F64_FACTOR 5) with double
// sums of the matvec and adjoint alone to 0.37–2.22, the chunk ratio from
// 0.58–3.74 to 0.34–0.98;
// 200 iterations at A=1024 take 5.08 → 4.81 ms in 2-D and 8.92 → 9.49 ms in
// 3-D (0 and 16 B spilled). Float32 sums one product at a time strayed 5–17
// times the float32 plain loop's own spread on the same states.
//
// What bounds it on the H100: the latency of each iteration's dependent
// chains and barriers (five block barriers an iteration; the cluster build
// two cluster barriers more), not the work: nearly all of an iteration's
// FMAs are in double since the fixed points moved there, and at the FP64 rate
// outside the tensor cores (34 TFLOP/s; the row updates at float32's 67) the
// work of 200 iterations at A=1024 is some 0.3 ms in 2-D
// (admm_timing.loop_bound). No tensor cores: the loop must stay float32 (TF32 breaks the
// ADMM algebra as bf16 did on the TPU, and the exit gates are already noisier
// than their thresholds in float32), its products are per-agent matvecs. A
// persistent kernel that keeps the state in shared memory across chunks is
// later work (ROADMAP Queue 2).
//
// Built by ops/qp_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point admm_launch (ctypes).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWidth = 3;  // stencil nonzeros per static row (qp.STENCIL_WIDTH)
constexpr int kMaxRegDk = 96;  // the largest dim·K of the register builds
constexpr int kTripleDk = 90;  // the largest dim·K of the triple build's 9-warp width
constexpr int kTripleShared = 8;  // a triple thread's Kinv columns in shared memory
constexpr int kGroups = 8;  // the cluster build's fixed row groups (qp_cuda.GROUPS)
constexpr int kClusterThreads = 256;  // threads of a CTA of the cluster build
constexpr unsigned kFull = 0xffffffffu;
// admm_launch's refusals of a cluster launch (CUDA's own errors are positive)
constexpr int kBadClusterSize = -2;  // C is not 0 (the global build), 1 (the memory build), 2, 4 or 8
constexpr int kPastSharedMemory = -3;  // a CTA needs more than the device's opt-in limit
constexpr int kNotResident = -4;  // cudaOccupancyMaxActiveClusters gives 0

struct Args {
  const float* normals;   // [A, O, M, dim]
  const float* Kinv;      // [A, dk, dk]
  const float* Pn;        // [A, K, K]
  const float* qn;        // [A, dk]
  const float* ln;        // [A, R]
  const float* un;        // [A, R] (read for the static rows only)
  const float* scale;     // [A, R] (read at the exit tests only)
  const float* xi0;       // [A, dk]
  const float* z0;        // [A, R]
  const float* y0;        // [A, R]
  const int* st_idx;      // [R_stat, kWidth] flat control point d*MN + mn
  const float* st_coef;   // [R_stat, kWidth]
  const float* rho_stat;  // [R_stat]
  const int* adj_ptr;     // [dim*MN + 1] compressed columns of the stencils
  const int* adj_row;     // [nnz] static row
  const float* adj_coef;  // [nnz]
  const int* grp_ptr;     // [(kGroups + 1) * dim*MN] group j's first entry of each column
  const float* N3k;       // [K, MN] shared nullspace basis
  const float* N3kT;      // [MN, K] its transpose
  float* xi;              // [A, dk] state between launches, then the result
  float* z;               // [A, R]
  float* y;               // [A, R]
  float* ax;              // [A, R] A·xi of the iterate (scratch)
  float* best;            // [A] best feasible objective (scratch)
  int* noimp;             // [A] chunks without improvement (scratch)
  int* itdone;            // [A] iteration count at the first exit test passed
  int* done_count;        // [n_chunks] agents done at each test, zeroed
  int A, dim, O, M, N, K, R_stat, max_iter, chunk;  // chunk: iterations between tests
  float rho_lsc, stop_tol, sigma, alpha, one_minus_alpha, eps_abs;
};

struct Dims {
  int dim, O, M, N, K, MN, dk, R_lsc, R_stat, R, half, mhalf;
};

__host__ __device__ inline Dims make_dims(int dim, int O, int M, int N, int K,
                                          int R_stat) {
  Dims D;
  D.dim = dim;
  D.O = O;
  D.M = M;
  D.N = N;
  D.K = K;
  D.MN = M * N;
  D.dk = dim * K;
  D.R_lsc = O * M * N;
  D.R_stat = R_stat;
  D.R = D.R_lsc + R_stat;
  D.half = (D.dk + 1) / 2;   // Kinv columns per thread
  D.mhalf = (D.MN + 1) / 2;  // control points per thread in the adjoint product
  return D;
}

// One agent a block (the register builds and the memory build): VD [dim*MN
// doubles]; XTD [dk doubles]; Z, Y, AX, LN [R], UN [R_stat], NRM [O*M*dim];
// XI, XIP, QN [dk]; VA [dim*MN]; RED [8 per warp]; MOF [MN] (int); KI [dk*dk]
// (the memory build's Kinv). Mirrored by qp_cuda.memory_block_bytes.
__host__ __device__ inline size_t smem_floats(const Dims& D, int threads, bool kinv) {
  return 4 * (size_t)D.R + D.R_stat + (size_t)D.O * D.M * D.dim + 5 * (size_t)D.dk +
         3 * (size_t)D.dim * D.MN + 8 * (threads / 32) + D.MN + (kinv ? (size_t)D.dk * D.dk : 0);
}

__host__ __device__ inline int admm_n_chunks(int max_iter, int chunk) {
  const int n = (max_iter + chunk - 1) / chunk;
  return n > 1 ? n : 1;
}

// x in double, converted where it is used: a conversion the compiler may
// hoist out of the iteration loop would hold each Kinv register twice, in
// double too, and spill them.
__device__ __forceinline__ double to_double_here(float x) {
  double d;
  asm volatile("cvt.f64.f32 %0, %1;" : "=d"(d) : "f"(x));
  return d;
}

// A 4-byte copy from global to shared memory in flight (cp.async), and the
// wait for all of a thread's copies.
__device__ __forceinline__ void copy_async(void* smem_dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One row's relaxation, projection onto [lo, hi] and dual update, in the
// plain loop's order of operations.
__device__ __forceinline__ void update_row(float zt, float& z, float& y, float& ax,
                                           float lo, float hi, float rho, float alpha,
                                           float beta) {
  const float zmix = alpha * zt + beta * z;
  const float zn = fminf(fmaxf(zmix + y / rho, lo), hi);
  y = y + rho * (zmix - zn);
  z = zn;
  ax = alpha * zt + beta * ax;
}

// f(r, o, mn) for this thread's LSC rows r = o*MN + mn < n (no division per
// row).
template <int NT, class F>
__device__ __forceinline__ void for_lsc_rows(const Dims& D, int n, F f) {
  int o = threadIdx.x / D.MN, mn = threadIdx.x % D.MN;
  const int step_o = NT / D.MN, step_mn = NT % D.MN;
  for (int r = threadIdx.x; r < n; r += NT) {
    f(r, o, mn);
    o += step_o;
    mn += step_mn;
    if (mn >= D.MN) {
      mn -= D.MN;
      ++o;
    }
  }
}

// Row value of LSC row (o, mn) (o: the slot in NRM) and of static row s from
// the control points VD, each taken in double and rounded once.
__device__ __forceinline__ float lsc_row(const Dims& D, const float* NRM, const int* MOF,
                                         const double* VD, int o, int mn) {
  const float* nr = NRM + (o * D.M + MOF[mn]) * D.dim;
  double acc = 0.;
  for (int d = 0; d < D.dim; ++d) acc += (double)nr[d] * VD[d * D.MN + mn];
  return (float)acc;
}

// A static row is a difference of nearby points: rounded to float32 first,
// the points would cost it twice the float32 plain loop's error.
__device__ __forceinline__ float stat_row(const Args& a, const double* VD, int s) {
  double acc = 0.;
#pragma unroll
  for (int e = 0; e < kWidth; ++e)
    acc += (double)__ldg(a.st_coef + s * kWidth + e) * VD[__ldg(a.st_idx + s * kWidth + e)];
  return (float)acc;
}

// VD[d*MN + mn] = Σ_k x[d*K + k]·N3k[k, mn], the control points of x (float:
// the warm start; double: ξ̃) per dim, in double.
template <int NT, class T>
__device__ void control_points(const Dims& D, const T* x, const float* __restrict__ N3k,
                               double* VD) {
  for (int i = threadIdx.x; i < D.dim * D.MN; i += NT) {
    const int d = i / D.MN, mn = i - d * D.MN;
    const T* xd = x + d * D.K;
    double acc = 0.;
    for (int k = 0; k < D.K; ++k) acc += (double)xd[k] * (double)__ldg(N3k + k * D.MN + mn);
    VD[i] = acc;
  }
}

// Aᵀw for the row cotangent w = ρz − y (DUAL: w = y). The LSC rows through
// the normals and the static rows through the transposed stencils go into one
// control-point accumulator VA [dim*MN], each point rounded to float32 once
// (a double VA keeps the rounded value: the triple build's); one N3k product
// then gives ξ-space (adjoint_row, adjoint_row3). Ends with a barrier.
template <int NT, bool DUAL, class TV>
__device__ __forceinline__ void adjoint_points(const Dims& D, const Args& a, const float* Z,
                                               const float* Y, const float* NRM, const int* MOF,
                                               TV* VA) {
  const float* Zs = Z + D.R_lsc;
  const float* Ys = Y + D.R_lsc;
  for (int i = threadIdx.x; i < D.dim * D.MN; i += NT) {
    const int d = i / D.MN, mn = i - d * D.MN, m = MOF[mn];
    double acc = 0.;
    for (int o = 0; o < D.O; ++o) {
      const int r = o * D.MN + mn;
      const float w = DUAL ? Y[r] : a.rho_lsc * Z[r] - Y[r];
      acc += (double)NRM[(o * D.M + m) * D.dim + d] * (double)w;
    }
    const int e1 = __ldg(a.adj_ptr + i + 1);
    for (int e = __ldg(a.adj_ptr + i); e < e1; ++e) {
      const int s = __ldg(a.adj_row + e);
      const float w = DUAL ? Ys[s] : __ldg(a.rho_stat + s) * Zs[s] - Ys[s];
      acc += (double)__ldg(a.adj_coef + e) * (double)w;
    }
    VA[i] = (TV)(float)acc;
  }
  __syncthreads();
}

// Output ki of Aᵀw from VA, in double, on both threads of the pair (kh: the
// thread's half of the control points), 0 beyond dk. Every lane of the warp
// calls it (one shuffle).
__device__ __forceinline__ double adjoint_row(const Dims& D, const Args& a, const float* VA,
                                              int ki, int kh) {
  double acc = 0.;
  if (ki < D.dk) {
    const int d = ki / D.K, k = ki - d * D.K;
    const int lo = kh * D.mhalf, hi = min(D.MN, lo + D.mhalf);
    const float* va = VA + d * D.MN;
    for (int mn = lo; mn < hi; ++mn) acc += (double)__ldg(a.N3kT + mn * D.K + k) * (double)va[mn];
  }
  return acc + __shfl_xor_sync(kFull, acc, 1);
}

// Output ki (= threadIdx.x / 2) of Aᵀw, in double (the register builds).
template <int NT, bool DUAL>
__device__ double adjoint(const Dims& D, const Args& a, const float* Z, const float* Y,
                         const float* NRM, const int* MOF, float* VA, int ki, int kh) {
  adjoint_points<NT, DUAL>(D, a, Z, Y, NRM, MOF, VA);
  return adjoint_row(D, a, VA, ki, kh);
}

// v[0..6] maxima, v[7] a sum, over the block; every thread gets the result,
// combined in a fixed order (deterministic). Uses RED[0 .. 8·NT/32).
template <int NT>
__device__ void block_reduce8(float (&v)[8], float* RED) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 7; ++i) v[i] = fmaxf(v[i], __shfl_xor_sync(kFull, v[i], off));
    v[7] += __shfl_xor_sync(kFull, v[7], off);
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int i = 0; i < 8; ++i) RED[w * 8 + i] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float r = RED[i];
    for (int u = 1; u < NT / 32; ++u) r = i < 7 ? fmaxf(r, RED[u * 8 + i]) : r + RED[u * 8 + i];
    v[i] = r;
  }
}

// The exit gates of one agent from its reductions v (block_reduce8's), in
// the plain loop's order; thread 0 of the agent's (first) block only.
__device__ void exit_gates(const Args& a, const float (&v)[8], size_t agent, int ck) {
  const bool feas = v[0] < a.stop_tol;
  const float rd = v[1], dmag = fmaxf(v[2], fmaxf(v[3], v[4]));
  const float dxi = v[5], xim = v[6], obj = v[7];
  float best = ck == 0 ? INFINITY : a.best[agent];
  int noimp = ck == 0 ? 0 : a.noimp[agent];
  int itdone = ck == 0 ? a.max_iter : a.itdone[agent];
  const bool opt = rd < a.eps_abs + 1e-3f * dmag;
  const bool stalled = dxi < 1e-4f * fmaxf(1.f, xim);
  const bool improved = obj < best - 2e-4f * fmaxf(1.f, fabsf(obj));
  if (feas && improved) best = obj;
  noimp = (feas && !improved) ? noimp + 1 : 0;
  const bool done = feas && (opt || stalled || noimp >= 2);
  if (done && itdone == a.max_iter) itdone = (ck + 1) * a.chunk;
  a.best[agent] = best;
  a.noimp[agent] = noimp;
  a.itdone[agent] = itdone;
  if (done) atomicAdd(a.done_count + ck, 1);
}

// The exit test's dk-vectors into v[1..7] (this thread's share): P·ξ in PX,
// Aᵀy in ATY.
template <int NT>
__device__ void dual_terms(const Dims& D, const float* PX, const float* ATY, const float* QN,
                           const float* XI, const float* XIP, float (&v)[8]) {
  for (int j = threadIdx.x; j < D.dk; j += NT) {
    const float px = PX[j], aty = ATY[j], q = QN[j], x = XI[j];
    v[1] = fmaxf(v[1], fabsf(px + q + aty));  // dual residual
    v[2] = fmaxf(v[2], fabsf(px));
    v[3] = fmaxf(v[3], fabsf(aty));
    v[4] = fmaxf(v[4], fabsf(q));
    v[5] = fmaxf(v[5], fabsf(x - XIP[j]));  // iterate change over the chunk
    v[6] = fmaxf(v[6], fabsf(x));
    v[7] += (0.5f * px + q) * x;  // objective
  }
}

// P·ξ per dimension into PX (float, the plain loop's order of terms).
template <int NT>
__device__ void cost_product(const Dims& D, const float* pn_g, const float* XI, float* PX) {
  for (int j = threadIdx.x; j < D.dk; j += NT) {
    const int d = j / D.K, k = j - d * D.K;
    float acc = 0.f;
    for (int l = 0; l < D.K; ++l) acc += pn_g[k * D.K + l] * XI[d * D.K + l];
    PX[j] = acc;
  }
}

// One chunk (a.chunk iterations and the exit tests) of every agent's loop,
// one agent per block of NT threads, the rows in shared memory. KC > 0: KC >=
// ceil(dk / 2) Kinv columns per thread in registers (dk <= NT/2); KC = 0: the
// memory build, Kinv in shared memory too, a thread pair taking rows i, i +
// NT/2, ... of the Kinv and N3k products. Launch ck starts from the inputs (ck = 0) or
// from the state the previous launch stored. When every agent was done at the
// previous test (the plain loop's global exit) it returns at once and marks
// its own test done for the whole fleet too, so that no later launch resumes
// the loop.
template <int NT, int KC>
__global__ void __launch_bounds__(NT, NT == 128 ? 8 : 2)
admm_chunk_kernel(Args a, int ck) {
  if (ck > 0 && a.done_count[ck - 1] == a.A) {
    if (threadIdx.x == 0 && blockIdx.x == 0) a.done_count[ck] = a.A;
    return;
  }
  extern __shared__ __align__(16) float smem[];
  const Dims D = make_dims(a.dim, a.O, a.M, a.N, a.K, a.R_stat);
  const int t = threadIdx.x;
  const size_t agent = blockIdx.x;

  // The doubles first. From the adjoint to the Kinv product VD is free and
  // holds rhs (dk ≤ dim·MN: K ≤ MN, N3k being a basis of a subspace of the MN
  // control points); after the loop XTD holds the exit tests' Aᵀy and P·ξ.
  double* VD = reinterpret_cast<double*>(smem);
  double* RHSD = VD;
  double* XTD = VD + D.dim * D.MN;
  float* RHS = reinterpret_cast<float*>(XTD);
  float* XT = RHS + D.dk;
  float* Z = XT + D.dk;
  float* Y = Z + D.R;
  float* AX = Y + D.R;
  float* LN = AX + D.R;
  float* UN = LN + D.R;  // the static rows only
  float* NRM = UN + D.R_stat;
  float* XI = NRM + D.O * D.M * D.dim;
  float* XIP = XI + D.dk;
  float* QN = XIP + D.dk;
  float* VA = QN + D.dk;
  float* RED = VA + D.dim * D.MN;
  int* MOF = reinterpret_cast<int*>(RED + 8 * (NT / 32));
  float* KI = reinterpret_cast<float*>(MOF + D.MN);  // the memory build's Kinv

  const float* xi_in = ck == 0 ? a.xi0 : a.xi;
  const float* z_in = ck == 0 ? a.z0 : a.z;
  const float* y_in = ck == 0 ? a.y0 : a.y;
  const float* nrm_g = a.normals + agent * D.O * D.M * D.dim;
  for (int i = t; i < D.O * D.M * D.dim; i += NT) NRM[i] = nrm_g[i];
  for (int r = t; r < D.R; r += NT) {
    const size_t g = agent * D.R + r;
    Z[r] = z_in[g];
    Y[r] = y_in[g];
    LN[r] = a.ln[g];
    if (ck > 0) AX[r] = a.ax[g];
    if (r >= D.R_lsc) UN[r - D.R_lsc] = a.un[g];
  }
  for (int j = t; j < D.dk; j += NT) {
    XI[j] = xi_in[agent * D.dk + j];
    XIP[j] = XI[j];
    QN[j] = a.qn[agent * D.dk + j];
  }
  for (int mn = t; mn < D.MN; mn += NT) MOF[mn] = mn / D.N;
  // Kinv row ki, columns [c0, c0 + ncols): in registers (the register
  // builds), or read from KI, rows ki, ki + NT/2, ... (the memory build)
  const int ki = t >> 1, kh = t & 1, c0 = kh * D.half;
  const float* kinv_g = a.Kinv + agent * D.dk * D.dk;
  float kin[KC > 0 ? KC : 1];
  int ncols;
  if constexpr (KC > 0) {
    ncols = ki < D.dk ? min(D.half, D.dk - c0) : 0;
#pragma unroll
    for (int c = 0; c < KC; ++c) kin[c] = c < ncols ? kinv_g[(size_t)ki * D.dk + c0 + c] : 0.f;
  } else {
    ncols = min(D.half, D.dk - c0);
    for (int i = t; i < D.dk * D.dk; i += NT) KI[i] = kinv_g[i];
  }
  const int row_sets = KC > 0 ? 1 : (D.dk + NT / 2 - 1) / (NT / 2);  // rows a thread pair takes
  __syncthreads();
  if (ck == 0) {  // A·xi of the warm start
    control_points<NT>(D, XI, a.N3k, VD);
    __syncthreads();
    for_lsc_rows<NT>(D, D.R_lsc, [&](int r, int o, int mn) {
      AX[r] = lsc_row(D, NRM, MOF, VD, o, mn);
    });
    for (int s = t; s < D.R_stat; s += NT) AX[D.R_lsc + s] = stat_row(a, VD, s);
    __syncthreads();
  }

  const float alpha = a.alpha, beta = a.one_minus_alpha;
  for (int it = 0; it < a.chunk; ++it) {
    // rhs = σξ − q + Aᵀ(ρz − y), in double: q and Aᵀ(ρz − y) cancel
    if constexpr (KC > 0) {
      const double g = adjoint<NT, false>(D, a, Z, Y, NRM, MOF, VA, ki, kh);
      if (kh == 0 && ki < D.dk) RHSD[ki] = ((double)a.sigma * XI[ki] - (double)QN[ki]) + g;
    } else {
      adjoint_points<NT, false>(D, a, Z, Y, NRM, MOF, VA);
      for (int u = 0; u < row_sets; ++u) {
        const int k = ki + u * (NT / 2);
        const double g = adjoint_row(D, a, VA, k, kh);
        if (kh == 0 && k < D.dk) RHSD[k] = ((double)a.sigma * XI[k] - (double)QN[k]) + g;
      }
    }
    __syncthreads();
    // ξ̃ = Kinv·rhs, in double
    if constexpr (KC > 0) {
      double acc = 0.;
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c < ncols) acc = fma(to_double_here(kin[c]), RHSD[c0 + c], acc);
      acc += __shfl_xor_sync(kFull, acc, 1);
      if (kh == 0 && ki < D.dk) XTD[ki] = acc;
    } else {
      for (int u = 0; u < row_sets; ++u) {
        const int k = ki + u * (NT / 2);
        double acc = 0.;
        if (k < D.dk) {
          const float* kr = KI + (size_t)k * D.dk + c0;
          for (int c = 0; c < ncols; ++c) acc = fma((double)kr[c], RHSD[c0 + c], acc);
        }
        acc += __shfl_xor_sync(kFull, acc, 1);
        if (kh == 0 && k < D.dk) XTD[k] = acc;
      }
    }
    __syncthreads();
    // control points of ξ̃; ξ ← αξ̃ + (1 − α)ξ
    control_points<NT>(D, XTD, a.N3k, VD);
    for (int j = t; j < D.dk; j += NT) XI[j] = alpha * (float)XTD[j] + beta * XI[j];
    __syncthreads();
    // z̃ = A·ξ̃, over-relaxation, projection onto [l, u], dual update
    for_lsc_rows<NT>(D, D.R_lsc, [&](int r, int o, int mn) {
      update_row(lsc_row(D, NRM, MOF, VD, o, mn), Z[r], Y[r], AX[r], LN[r], INFINITY,
                 a.rho_lsc, alpha, beta);
    });
    for (int s = t; s < D.R_stat; s += NT) {
      const int r = D.R_lsc + s;
      update_row(stat_row(a, VD, s), Z[r], Y[r], AX[r], LN[r], UN[s], __ldg(a.rho_stat + s),
                 alpha, beta);
    }
    __syncthreads();
  }

  // ---- exit tests on the actual iterate ----
  const float* scale_g = a.scale + agent * D.R;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int r = t; r < D.R; r += NT) {
    const float axr = AX[r];
    const float hi = r < D.R_lsc ? INFINITY : UN[r - D.R_lsc];
    const float vr = fmaxf(fmaxf(LN[r] - axr, axr - hi), 0.f);
    v[0] = fmaxf(v[0], vr / scale_g[r]);
  }
  if constexpr (KC > 0) {
    const float aty_k = (float)adjoint<NT, true>(D, a, Z, Y, NRM, MOF, VA, ki, kh);  // Aᵀy
    if (kh == 0 && ki < D.dk) RHS[ki] = aty_k;
  } else {
    adjoint_points<NT, true>(D, a, Z, Y, NRM, MOF, VA);
    for (int u = 0; u < row_sets; ++u) {
      const int k = ki + u * (NT / 2);
      const float aty_k = (float)adjoint_row(D, a, VA, k, kh);
      if (kh == 0 && k < D.dk) RHS[k] = aty_k;
    }
  }
  cost_product<NT>(D, a.Pn + agent * D.K * D.K, XI, XT);
  __syncthreads();
  dual_terms<NT>(D, XT, RHS, QN, XI, XIP, v);
  block_reduce8<NT>(v, RED);

  for (int j = t; j < D.dk; j += NT) a.xi[agent * D.dk + j] = XI[j];
  for (int r = t; r < D.R; r += NT) {
    const size_t g = agent * D.R + r;
    a.z[g] = Z[r];
    a.y[g] = Y[r];
    a.ax[g] = AX[r];
  }
  if (t == 0) exit_gates(a, v, agent, ck);
}

// ---- the triple build (dim·K 61–96) ------------------------------------

// Lanes 0..29 of each warp of the triple build are ten triples: triple g =
// 10·warp + lane / 3 takes one output at a time (a Kinv row, an adjoint row,
// a control point), part p = lane % 3 a third of its terms; lanes 30 and 31
// take none (g = kIdle). combine3 adds the triple's three partials in one
// fixed order, (p0 + p1) + p2, on all three lanes; every lane of the warp
// calls it.
constexpr int kIdle = 1 << 20;

__device__ __forceinline__ double combine3(double v, int base) {
  const double v0 = __shfl_sync(kFull, v, base);
  const double v1 = __shfl_sync(kFull, v, base + 1);
  const double v2 = __shfl_sync(kFull, v, base + 2);
  return (v0 + v1) + v2;
}

// A double within an ulp of 1/b (b > 0, normal): the hardware's
// approximation and two Newton steps.
__device__ __forceinline__ double recip(float b) {
  const double bd = b;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(bd));
  r = fma(r, fma(-bd, r, 1.), r);
  return fma(r, fma(-bd, r, 1.), r);
}

// update_row with y / rho as (float)(y · rinv), rinv = recip(rho): the same
// bits as the float division, without its slow-path call (the call's saved
// registers cost the triple build its registers). A float quotient that is
// not the midpoint of two floats lies at least 2^-49 (relative) from one,
// and y · rinv is within 1.5·2^-52 of y / rho, so both round to the same
// float; a midpoint quotient needs rho a power of two, whose rinv is exact.
__device__ __forceinline__ void update_row_rcp(float zt, float& z, float& y, float& ax,
                                               float lo, float hi, float rho, double rinv,
                                               float alpha, float beta) {
  const float zmix = alpha * zt + beta * z;
  const float zn = fminf(fmaxf(zmix + (float)((double)y * rinv), lo), hi);
  y = y + rho * (zmix - zn);
  z = zn;
  ax = alpha * zt + beta * ax;
}

// The shared memory of a block of the triple build of W warps, in floats:
// doubles VD [dim*MN] (rhs in its first dk; the exit tests' reductions
// RED), XTD [dk] (ξ̃; the exit tests' Aᵀy and P·ξ as floats), VAD
// [dim*MN], the ten-warp width padded (TripleView::xpad): VD [dim*MN + 2],
// XTD [dim*(K + 3)]; floats NRM [O*M*dim], Z, Y, AX, LN [R], UN [R_stat],
// XI, XIP, QN [dk]; MOF [MN] (int); KIS [kTripleShared * 30W] (the Kinv
// columns past a thread's registers). Mirrored by qp_cuda.triple_block_bytes.
__host__ __device__ inline size_t triple_smem_floats(const Dims& D, int W) {
  const size_t pad = W == 10 ? 2 + 3 * (size_t)D.dim : 0;
  return 2 * (2 * (size_t)D.dim * D.MN + D.dk + pad) + (size_t)D.O * D.M * D.dim +
         4 * (size_t)D.R + D.R_stat + 3 * (size_t)D.dk + D.MN +
         (size_t)kTripleShared * 30 * W;
}

// Output ki of Aᵀw from VAD in double, on all three lanes of triple ki (part
// p over its third of the control points); 0 beyond dk.
__device__ __forceinline__ double adjoint_row3(const Dims& D, const Args& a, const double* VAD,
                                               int ki, int p, int base) {
  double acc = 0.;
  if (ki < D.dk) {
    const int d = ki / D.K, k = ki - d * D.K;
    const int M3 = (D.MN + 2) / 3, lo = p * M3, hi = min(D.MN, lo + M3);
    const double* va = VAD + d * D.MN;
    for (int mn = lo; mn < hi; ++mn) acc += (double)__ldg(a.N3kT + mn * D.K + k) * va[mn];
  }
  return combine3(acc, base);
}

// VD[d*MN + mn] = Σ_k x[d*K + k]·N3k[k, mn] in double (x float: the warm
// start; double: ξ̃): a triple a point, part p over its third of k, in
// rounds of G points. PAD: x laid out as TripleView::xpad says.
template <int G, bool PAD, class T>
__device__ __forceinline__ void points3(const Dims& D, const T* x, const float* N3k,
                                        double* VD, int g, int p, int base) {
  const int n = D.dim * D.MN, K3 = (D.K + 2) / 3, k0 = p * K3, k1 = min(D.K, k0 + K3);
  for (int i0 = 0; i0 < n; i0 += G) {
    const int i = i0 + g;
    double acc = 0.;
    if (i < n) {
      const int d = i / D.MN, mn = i - d * D.MN;
      const T* xd = PAD ? x + d * (D.K + 3) + p : x + d * D.K;
      for (int k = k0; k < k1; ++k) acc += (double)xd[k] * (double)__ldg(N3k + k * D.MN + mn);
    }
    acc = combine3(acc, base);
    if (p == 0 && i < n) VD[i] = acc;
  }
}

// A value the compiler must take as new here: what is derived from it is
// computed again, not held in a register from one phase to the next.
__device__ __forceinline__ int fresh(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// The triple build's view of its block, derived afresh in each phase (its
// registers are the Kinv columns' and a phase's own): the shape, the shared
// arrays, and the thread's triple g, part p, the triple's first lane base.
template <int W>
struct TripleView {
  Dims D;
  double *VD, *XTD, *VAD;
  float *NRM, *Z, *Y, *AX, *LN, *UN, *XI, *XIP, *QN, *KIS;
  int* MOF;
  int t, g, p, base;

  __device__ __forceinline__ TripleView(const Args& a, float* smem) {
    D = make_dims(fresh(a.dim), fresh(a.O), fresh(a.M), fresh(a.N), fresh(a.K),
                  fresh(a.R_stat));
    t = fresh(threadIdx.x);
    const int lane = t & 31;
    p = lane < 30 ? lane % 3 : 0;
    g = lane < 30 ? (t >> 5) * 10 + lane / 3 : kIdle;
    base = lane < 30 ? lane - p : 30;
    VD = reinterpret_cast<double*>(smem);
    XTD = VD + D.dim * D.MN + (W == 10 ? 2 : 0);
    VAD = XTD + (W == 10 ? D.dim * (D.K + 3) : D.dk);
    NRM = reinterpret_cast<float*>(VAD + D.dim * D.MN);
    Z = NRM + D.O * D.M * D.dim;
    Y = Z + D.R;
    AX = Y + D.R;
    LN = AX + D.R;
    UN = LN + D.R;
    XI = UN + D.R_stat;
    XIP = XI + D.dk;
    QN = XIP + D.dk;
    MOF = reinterpret_cast<int*>(QN + D.dk);
    KIS = reinterpret_cast<float*>(MOF + D.MN) + (t >> 5) * 30 + lane;
  }
  // Kinv row g's columns [c0, c0 + ncols) of this thread, and the first of
  // them in the agent's Kinv
  __device__ __forceinline__ int c0() const { return p * ((D.dk + 2) / 3); }
  __device__ __forceinline__ int ncols() const {
    return g < D.dk ? max(0, min((D.dk + 2) / 3, D.dk - c0())) : 0;
  }
  __device__ __forceinline__ const float* kinv(const Args& a) const {
    return a.Kinv + ((size_t)blockIdx.x * D.dk + (g < D.dk ? g : 0)) * D.dk + c0();
  }
  // The ten-warp width's padding (PAD in admm_triple_kernel): where a
  // triple's three parts read doubles 16·8·q bytes apart, its lanes wait
  // on one bank three times over (2-D at M = 16: ⌈dk/3⌉ = 32, ⌈K/3⌉ = 16).
  // rhs's thirds lie one double apart where ⌈dk/3⌉ is a multiple of 8
  // (rhs entry j at j + shift()·(its third)), ξ̃'s at xpad: each dim's K
  // entries, then 3 of padding, each third shifted by one double more.
  __device__ __forceinline__ int shift() const { return (((D.dk + 2) / 3) & 7) == 0; }
  __device__ __forceinline__ int rhs_at(int j) const {
    const int third = (D.dk + 2) / 3;
    return j + shift() * ((j >= third) + (j >= 2 * third));
  }
  __device__ __forceinline__ int xpad(int j) const {
    const int d = (j >= D.K) + (j >= 2 * D.K), k = j - d * D.K, k3 = (D.K + 2) / 3;
    return d * (D.K + 3) + k + (k >= k3) + (k >= 2 * k3);
  }
};

// One chunk of every agent's loop at dim·K 61–96, one agent a block of W
// warps (W = 9 up to dim·K 90, four blocks an SM; 10 above, three), the rows
// in shared memory as in admm_chunk_kernel. Triple g holds its third of
// Kinv row g (⌈dk/3⌉ ≤ KC + KS columns: KC in registers, KS in KIS); the
// Kinv product, the adjoint rows and the control points run a triple an
// output (see combine3), the adjoint points a thread a point
// (adjoint_points). Each phase takes its view of the block afresh
// (TripleView), so that the registers the Kinv columns leave suffice
// without spilling. The ten-warp width pads rhs and ξ̃ by part (PAD: 2-D at
// M = 16, A = 1,024, ran 13.0 ms unpadded against <256,48>'s 11.9 on an
// NVIDIA H100 80GB HBM3 at 700 W; the padding's index arithmetic cost the
// nine-warp width 1–5% there: PERF.md §6). Launch ck as in
// admm_chunk_kernel.
template <int W, int KC>
__global__ void __launch_bounds__(32 * W, W <= 9 ? 4 : 3)
admm_triple_kernel(Args a, int ck) {
  constexpr int NT = 32 * W, G = 10 * W, KS = kTripleShared;
  constexpr bool PAD = W == 10;
  if (ck > 0 && a.done_count[ck - 1] == a.A) {
    if (threadIdx.x == 0 && blockIdx.x == 0) a.done_count[ck] = a.A;
    return;
  }
  extern __shared__ __align__(16) float smem[];
  {
    const TripleView<W> s(a, smem);
    const Dims& D = s.D;
    const size_t agent = blockIdx.x;
    const int t = s.t;
    const float* xi_in = ck == 0 ? a.xi0 : a.xi;
    const float* z_in = ck == 0 ? a.z0 : a.z;
    const float* y_in = ck == 0 ? a.y0 : a.y;
    // the agent's state and rows, every copy in flight at once (cp.async)
    const float* nrm_g = a.normals + agent * D.O * D.M * D.dim;
    for (int i = t; i < D.O * D.M * D.dim; i += NT) copy_async(s.NRM + i, nrm_g + i);
    const size_t g0 = agent * D.R;
    for (int r = t; r < D.R; r += NT) {
      copy_async(s.Z + r, z_in + g0 + r);
      copy_async(s.Y + r, y_in + g0 + r);
      copy_async(s.LN + r, a.ln + g0 + r);
      if (ck > 0) copy_async(s.AX + r, a.ax + g0 + r);
    }
    for (int i = t; i < D.R_stat; i += NT) copy_async(s.UN + i, a.un + g0 + D.R_lsc + i);
    for (int j = t; j < D.dk; j += NT) {
      copy_async(s.XI + j, xi_in + agent * D.dk + j);
      copy_async(s.XIP + j, xi_in + agent * D.dk + j);
      copy_async(s.QN + j, a.qn + agent * D.dk + j);
    }
    if ((t & 31) < 30) {
      const int ncols = s.ncols();
      const float* kr = s.kinv(a);
      for (int j = 0; j < KS; ++j) {
        if (KC + j < ncols)
          copy_async(s.KIS + j * 30 * W, kr + KC + j);
        else
          s.KIS[j * 30 * W] = 0.f;
      }
    }
    for (int mn = t; mn < D.MN; mn += NT) s.MOF[mn] = mn / D.N;
    copy_async_wait();
  }
  __syncthreads();
  if (ck == 0) {  // A·xi of the warm start
    {
      const TripleView<W> s(a, smem);
      points3<G, false>(s.D, s.XI, a.N3k, s.VD, s.g, s.p, s.base);
    }
    __syncthreads();
    const TripleView<W> s(a, smem);
    for_lsc_rows<NT>(s.D, s.D.R_lsc, [&](int r, int o, int mn) {
      s.AX[r] = lsc_row(s.D, s.NRM, s.MOF, s.VD, o, mn);
    });
    for (int i = s.t; i < s.D.R_stat; i += NT) s.AX[s.D.R_lsc + i] = stat_row(a, s.VD, i);
    __syncthreads();
  }
  // Kinv row g, the first KC of its columns (the next KS are in KIS)
  float kin[KC];
  {
    const TripleView<W> s(a, smem);
    const int ncols = s.ncols();
    const float* kr = s.kinv(a);
#pragma unroll
    for (int c = 0; c < KC; ++c) kin[c] = c < ncols ? kr[c] : 0.f;
  }

  for (int it = 0; it < a.chunk; ++it) {
    {  // rhs = σξ − q + Aᵀ(ρz − y), in double: q and Aᵀ(ρz − y) cancel
      const TripleView<W> s(a, smem);
      adjoint_points<NT, false>(s.D, a, s.Z, s.Y, s.NRM, s.MOF, s.VAD);
    }
    {
      const TripleView<W> s(a, smem);
      const double gr = adjoint_row3(s.D, a, s.VAD, s.g, s.p, s.base);
      if (s.p == 0 && s.g < s.D.dk)
        s.VD[PAD ? s.rhs_at(s.g) : s.g] =
            ((double)a.sigma * s.XI[s.g] - (double)s.QN[s.g]) + gr;
    }
    __syncthreads();
    {  // ξ̃ = Kinv·rhs, in double (rhs in VD)
      const TripleView<W> s(a, smem);
      const int c0 = s.c0() + (PAD ? s.p * s.shift() : 0), ncols = s.ncols();
      double acc = 0.;
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c < ncols) acc = fma(to_double_here(kin[c]), s.VD[c0 + c], acc);
      for (int j = 0; j < KS; ++j)
        if (KC + j < ncols) acc = fma((double)s.KIS[j * 30 * W], s.VD[c0 + KC + j], acc);
      acc = combine3(acc, s.base);
      if (s.p == 0 && s.g < s.D.dk) s.XTD[PAD ? s.xpad(s.g) : s.g] = acc;
    }
    __syncthreads();
    {  // control points of ξ̃; ξ ← αξ̃ + (1 − α)ξ
      const TripleView<W> s(a, smem);
      points3<G, PAD>(s.D, s.XTD, a.N3k, s.VD, s.g, s.p, s.base);
      for (int j = s.t; j < s.D.dk; j += NT)
        s.XI[j] = a.alpha * (float)s.XTD[PAD ? s.xpad(j) : j] + a.one_minus_alpha * s.XI[j];
    }
    __syncthreads();
    {  // z̃ = A·ξ̃, over-relaxation, projection onto [l, u], dual update
      const TripleView<W> s(a, smem);
      const float alpha = a.alpha, beta = a.one_minus_alpha;
      const double rinv_lsc = recip(a.rho_lsc);
      for_lsc_rows<NT>(s.D, s.D.R_lsc, [&](int r, int o, int mn) {
        update_row_rcp(lsc_row(s.D, s.NRM, s.MOF, s.VD, o, mn), s.Z[r], s.Y[r], s.AX[r],
                       s.LN[r], INFINITY, a.rho_lsc, rinv_lsc, alpha, beta);
      });
      for (int i = s.t; i < s.D.R_stat; i += NT) {
        const int r = s.D.R_lsc + i;
        const float rho = __ldg(a.rho_stat + i);
        update_row_rcp(stat_row(a, s.VD, i), s.Z[r], s.Y[r], s.AX[r], s.LN[r], s.UN[i], rho,
                       recip(rho), alpha, beta);
      }
    }
    __syncthreads();
  }

  // ---- exit tests on the actual iterate ----
  const TripleView<W> s(a, smem);
  const Dims& D = s.D;
  const int t = s.t;
  const size_t agent = blockIdx.x;
  float* RED = reinterpret_cast<float*>(s.VD);  // the reductions
  float* RHS = reinterpret_cast<float*>(s.XTD);  // Aᵀy and P·ξ
  float* XT = RHS + D.dk;
  const float* scale_g = a.scale + agent * D.R;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int r = t; r < D.R; r += NT) {
    const float axr = s.AX[r];
    const float hi = r < D.R_lsc ? INFINITY : s.UN[r - D.R_lsc];
    const float vr = fmaxf(fmaxf(s.LN[r] - axr, axr - hi), 0.f);
    v[0] = fmaxf(v[0], vr / scale_g[r]);
  }
  adjoint_points<NT, true>(D, a, s.Z, s.Y, s.NRM, s.MOF, s.VAD);
  const float aty = (float)adjoint_row3(D, a, s.VAD, s.g, s.p, s.base);  // Aᵀy
  if (s.p == 0 && s.g < D.dk) RHS[s.g] = aty;
  cost_product<NT>(D, a.Pn + agent * D.K * D.K, s.XI, XT);
  __syncthreads();
  dual_terms<NT>(D, XT, RHS, s.QN, s.XI, s.XIP, v);
  block_reduce8<NT>(v, RED);

  for (int j = t; j < D.dk; j += NT) a.xi[agent * D.dk + j] = s.XI[j];
  for (int r = t; r < D.R; r += NT) {
    const size_t gi = agent * D.R + r;
    a.z[gi] = s.Z[r];
    a.y[gi] = s.Y[r];
    a.ax[gi] = s.AX[r];
  }
  if (t == 0) exit_gates(a, v, agent, ck);
}

// ---- the cluster build ------------------------------------------------

// One CTA's share of an agent at cluster size C: gpc = 8/C groups of G slots
// and GS static rows (G, GS fixed by the shape), kr rows of Kinv; n3k: N3k
// staged in shared memory.
struct Split {
  int gpc, G, GS, slots, stat, kr, n3k;
};

__host__ __device__ inline Split make_split(const Dims& D, int C, int n3k) {
  Split S;
  S.gpc = kGroups / C;
  S.G = (D.O + kGroups - 1) / kGroups;
  S.GS = (D.R_stat + kGroups - 1) / kGroups;
  S.slots = S.gpc * S.G;
  S.stat = S.gpc * S.GS;
  S.kr = (D.dk + C - 1) / C;
  S.n3k = n3k;
  return S;
}

// The odd row stride of the staged N3k: a warp reading a column (32 rows)
// hits 32 banks.
__host__ __device__ inline int n3k_stride(int MN) { return MN | 1; }

// A CTA's shared memory, in floats (the doubles first): VD [dim*MN], RHSD
// [dk], XTD [dk], PART [gpc][dim*MN], VA [dim*MN] (doubles); XI, XIP, QN [dk];
// RED [8 per warp + 8]; Z, Y, AX, LN [slots*MN + stat]; UN [stat]; NRM
// [slots*M*dim]; KI [kr*dk]; N3S [K*stride] where staged; the CTA's static
// rows' stencils SCOEF [3*stat] and ρ SRHO [stat], its groups' transposed
// stencils ECOEF [3*stat]; MOF [MN] (int); SIDX [3*stat], LGP
// [(gpc+1)*dim*MN], EROW [3*stat] (16 bits). Mirrored by
// qp_cuda.cluster_cta_bytes.
__host__ __device__ inline size_t cluster_smem_floats(const Dims& D, const Split& S) {
  const size_t nv = (size_t)D.dim * D.MN, rows = (size_t)S.slots * D.MN + S.stat;
  const size_t halves = 6 * (size_t)S.stat + (S.gpc + 1) * nv;
  return 2 * (nv * (2 + S.gpc) + 2 * (size_t)D.dk) + 3 * (size_t)D.dk +
         8 * (kClusterThreads / 32) + 8 + 4 * rows + S.stat + (size_t)S.slots * D.M * D.dim +
         (size_t)S.kr * D.dk + (S.n3k ? (size_t)D.K * n3k_stride(D.MN) : 0) + 7 * (size_t)S.stat +
         D.MN + (halves + 1) / 2;
}

struct CSmem {
  double *VD, *RHSD, *XTD, *PART, *VA;
  float *XI, *XIP, *QN, *RED, *Z, *Y, *AX, *LN, *UN, *NRM, *KI, *N3S, *SCOEF, *SRHO, *ECOEF;
  int* MOF;
  unsigned short *SIDX, *LGP, *EROW;
};

__device__ inline CSmem cluster_layout(float* smem, const Dims& D, const Split& S) {
  const int nv = D.dim * D.MN, rows = S.slots * D.MN + S.stat;
  CSmem s;
  s.VD = reinterpret_cast<double*>(smem);
  s.RHSD = s.VD + nv;
  s.XTD = s.RHSD + D.dk;
  s.PART = s.XTD + D.dk;
  s.VA = s.PART + S.gpc * nv;
  s.XI = reinterpret_cast<float*>(s.VA + nv);
  s.XIP = s.XI + D.dk;
  s.QN = s.XIP + D.dk;
  s.RED = s.QN + D.dk;
  s.Z = s.RED + 8 * (kClusterThreads / 32) + 8;
  s.Y = s.Z + rows;
  s.AX = s.Y + rows;
  s.LN = s.AX + rows;
  s.UN = s.LN + rows;
  s.NRM = s.UN + S.stat;
  s.KI = s.NRM + S.slots * D.M * D.dim;
  s.N3S = s.KI + S.kr * D.dk;
  s.SCOEF = s.N3S + (S.n3k ? D.K * n3k_stride(D.MN) : 0);
  s.SRHO = s.SCOEF + 3 * S.stat;
  s.ECOEF = s.SRHO + S.stat;
  s.MOF = reinterpret_cast<int*>(s.ECOEF + 3 * S.stat);
  s.SIDX = reinterpret_cast<unsigned short*>(s.MOF + D.MN);
  s.LGP = s.SIDX + 3 * S.stat;
  s.EROW = s.LGP + (S.gpc + 1) * nv;
  return s;
}

// The rows CTA `rank` holds: groups g0 .. g0 + gpc − 1, their slots [o0, o1)
// (local LSC rows (o − o0)·MN + mn < nl) and static rows [s0, s1) (local rows
// nl .. nl + ns − 1), and the Kinv rows [k0, k1).
struct Own {
  int g0, o0, o1, s0, s1, k0, k1, nl, ns;
};

__device__ inline Own own_rows(const Dims& D, const Split& S, int rank) {
  Own w;
  w.g0 = rank * S.gpc;
  w.o0 = min(D.O, w.g0 * S.G);
  w.o1 = min(D.O, w.o0 + S.slots);
  w.s0 = min(D.R_stat, w.g0 * S.GS);
  w.s1 = min(D.R_stat, w.s0 + S.stat);
  w.k0 = min(D.dk, rank * S.kr);
  w.k1 = min(D.dk, w.k0 + S.kr);
  w.nl = (w.o1 - w.o0) * D.MN;
  w.ns = w.s1 - w.s0;
  return w;
}

// The agent's row of local row lr (the LSC rows first, then the static).
__device__ __forceinline__ int agent_row(const Dims& D, const Own& w, int lr) {
  return lr < w.nl ? w.o0 * D.MN + lr : D.R_lsc + w.s0 + lr - w.nl;
}

// f(i, h) for every i < n on groups of 2^lp consecutive threads (h: the
// thread's part); every lane of a warp runs the same trips, so that the parts
// combine by shuffles (i ≥ n: a lane that only takes part).
template <int NT, class F>
__device__ __forceinline__ void for_parts(int n, int lp, F f) {
  const int n2 = ((n << lp) + 31) & ~31;
  for (int i2 = threadIdx.x; i2 < n2; i2 += NT) f(i2 >> lp, i2 & ((1 << lp) - 1));
}

// p summed over the 2^lp threads of a part group, the same bits on each
// (a butterfly: each addition's operands commute).
__device__ __forceinline__ double sum_parts(double p, int lp) {
  for (int off = 1; off < (1 << lp); off <<= 1) p += __shfl_xor_sync(kFull, p, off);
  return p;
}

// Σ_{j0 ≤ j < j1} a(j)·b(j) in double over four accumulators (j − j0 mod 4),
// added as (s0 + s1) + (s2 + s3): a fixed order for given (j0, j1), and four
// independent chains.
template <class F>
__device__ __forceinline__ double dot4(int j0, int j1, F term) {
  double s0 = 0., s1 = 0., s2 = 0., s3 = 0.;
  int j = j0;
  for (; j + 3 < j1; j += 4) {
    const double2 t0 = term(j), t1 = term(j + 1), t2 = term(j + 2), t3 = term(j + 3);
    s0 = fma(t0.x, t0.y, s0);
    s1 = fma(t1.x, t1.y, s1);
    s2 = fma(t2.x, t2.y, s2);
    s3 = fma(t3.x, t3.y, s3);
  }
  if (j < j1) {
    const double2 t0 = term(j);
    s0 = fma(t0.x, t0.y, s0);
  }
  if (j + 1 < j1) {
    const double2 t1 = term(j + 1);
    s1 = fma(t1.x, t1.y, s1);
  }
  if (j + 2 < j1) {
    const double2 t2 = term(j + 2);
    s2 = fma(t2.x, t2.y, s2);
  }
  return (s0 + s1) + (s2 + s3);
}

// Σ_{k0 ≤ k < k1} x[k]·n3[k·ld + mn] in double (N3k by columns: control
// points).
template <class T>
__device__ __forceinline__ double n3_col_dot(const T* x, const float* n3, int ld, int mn,
                                             int k0, int k1) {
  return dot4(k0, k1, [&](int k) { return make_double2((double)x[k], (double)n3[k * ld + mn]); });
}

// Σ_{m0 ≤ mn < m1} n3[k·ld + mn]·v[mn] in double (N3k by rows: the adjoint).
__device__ __forceinline__ double n3_row_dot(const float* n3, int ld, int k, const double* v,
                                             int m0, int m1) {
  const float* row = n3 + k * ld;
  return dot4(m0, m1, [&](int mn) { return make_double2((double)row[mn], v[mn]); });
}

// VD = the control points of x (every dimension), in double, on thread pairs.
template <int NT, class T>
__device__ void cluster_points(const Dims& D, const T* x, const float* n3, int ld, double* VD) {
  const int nv = D.dim * D.MN, kh = (D.K + 1) / 2;
  for_parts<NT>(nv, 1, [&](int i, int h) {
    double p = 0.;
    if (i < nv) {
      const int d = i / D.MN, mn = i - d * D.MN;
      p = n3_col_dot(x + d * D.K, n3, ld, mn, h ? kh : 0, h ? D.K : kh);
    }
    p = sum_parts(p, 1);
    if (h == 0 && i < nv) VD[i] = p;
  });
}

// out(k, Σ_mn N3k[k, mn]·VA[d·MN + mn]) for every k = d·K + k' < dk, in double,
// on thread pairs.
template <int NT, class F>
__device__ void cluster_adjoint(const Dims& D, const float* n3, int ld, const double* VA, F out) {
  const int mh = (D.MN + 1) / 2;
  for_parts<NT>(D.dk, 1, [&](int k, int h) {
    double p = 0.;
    if (k < D.dk) {
      const int d = k / D.K;
      p = n3_row_dot(n3, ld, k - d * D.K, VA + d * D.MN, h ? mh : 0, h ? D.MN : mh);
    }
    p = sum_parts(p, 1);
    if (h == 0 && k < D.dk) out(k, p);
  });
}

// Static row q of the CTA (local) from the control points VD: stat_row's
// arithmetic on the CTA's copy of its stencil.
__device__ __forceinline__ float local_stat_row(const CSmem& s, int q) {
  double acc = 0.;
#pragma unroll
  for (int e = 0; e < kWidth; ++e)
    acc += (double)s.SCOEF[q * kWidth + e] * s.VD[s.SIDX[q * kWidth + e]];
  return (float)acc;
}

// PART[jl·nv + i] += the static rows of group g0 + jl at control point i,
// through the CTA's transposed stencils, in entry order.
template <int NT, bool DUAL>
__device__ void static_partials(const Dims& D, const Split& S, const Args& a, const Own& w,
                                const CSmem& s) {
  const int nv = D.dim * D.MN;
  for (int it = threadIdx.x; it < S.gpc * nv; it += NT) {
    const int jl = it / nv, i = it - jl * nv;
    const int e1 = s.LGP[(jl + 1) * nv + i];
    double acc = 0.;
    for (int e = s.LGP[jl * nv + i]; e < e1; ++e) {
      const int q = s.EROW[e], lr = w.nl + q;
      const float ww = DUAL ? s.Y[lr] : s.SRHO[q] * s.Z[lr] - s.Y[lr];
      acc = fma((double)s.ECOEF[e], (double)ww, acc);
    }
    s.PART[it] += acc;
  }
}

// The slot parts of a group (2^lps threads share a (group, point) item of
// the LSC partials and rows), by its slots G: chains of ≤ ~6 slots.
__host__ __device__ inline int slot_parts_log2(int G) { return G >= 12 ? 2 : G >= 6 ? 1 : 0; }

// The LSC rows of item (jl, mn), slot part h of 2^lps: its group's slots
// o = oa + h, oa + h + 2^lps, ... < ob (local row (o − o0)·MN + mn, the
// normals of slot o and segment m at (o − o0)·M + m).
struct LscItem {
  int r, step, n, nstep;  // first local row and its stride; first NRM entry and its stride
  int count;              // rows of this part
};

__device__ __forceinline__ LscItem lsc_item(const Dims& D, const Split& S, const Own& w,
                                            const int* MOF, int jl, int mn, int h, int lps) {
  const int j = w.g0 + jl, sp = 1 << lps;
  const int oa = min(D.O, j * S.G), ob = min(D.O, oa + S.G);
  LscItem it;
  it.count = oa + h < ob ? (ob - oa - h + sp - 1) >> lps : 0;
  it.r = (oa + h - w.o0) * D.MN + mn;
  it.step = sp * D.MN;
  it.n = ((oa + h - w.o0) * D.M + MOF[mn]) * D.dim;
  it.nstep = sp * D.M * D.dim;
  return it;
}

// PART[jl·nv + i]: group g0 + jl's part of Aᵀw at control point i, in double,
// for the row cotangent w = ρz − y (DUAL: w = y): its slots through the
// normals (each slot part in slot order, the parts added by a butterfly),
// then its static rows through the transposed stencils (the CTA's copy of
// qp_cuda.group_ptr's entries), in that order. The iteration's fused row
// update (cluster_rows) forms the same sums.
template <int NT, bool DUAL>
__device__ void group_partials(const Dims& D, const Split& S, const Args& a, const Own& w,
                               const CSmem& s) {
  const int nv = D.dim * D.MN, lps = slot_parts_log2(S.G), n_items = S.gpc * D.MN;
  for_parts<NT>(n_items, lps, [&](int item, int h) {
    double p[3] = {0., 0., 0.};
    const bool live = item < n_items;
    const int jl = live ? item / D.MN : 0, mn = live ? item - jl * D.MN : 0;
    if (live) {
      const LscItem it = lsc_item(D, S, w, s.MOF, jl, mn, h, lps);
      for (int u = 0, r = it.r, n = it.n; u < it.count; ++u, r += it.step, n += it.nstep) {
        const double ww = (double)(DUAL ? s.Y[r] : a.rho_lsc * s.Z[r] - s.Y[r]);
#pragma unroll
        for (int d = 0; d < 3; ++d)
          if (d < D.dim) p[d] = fma((double)s.NRM[n + d], ww, p[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) p[d] = sum_parts(p[d], lps);
    if (live && h == 0)
#pragma unroll
      for (int d = 0; d < 3; ++d)  // constant indices: p stays in registers
        if (d < D.dim) s.PART[jl * nv + d * D.MN + mn] = p[d];
  });
  __syncthreads();
  static_partials<NT, DUAL>(D, S, a, w, s);
}

// Step (5)'s row updates: this CTA's LSC rows by group_partials' items (the
// item's control points in registers), each row's z̃ in double from VD and
// rounded once, over-relaxed, projected and its dual updated, and the next
// iteration's partials of ρz − y (`dual`, the chunk's last iteration: of y,
// for the exit test's Aᵀy) formed from the updated rows on the way
// (group_partials' sums); then its static rows and their partials. Ends
// with the static partials written (no barrier).
template <int NT>
__device__ void cluster_rows(const Dims& D, const Split& S, const Args& a, const Own& w,
                             const CSmem& s, float alpha, float beta, bool dual) {
  const int nv = D.dim * D.MN, lps = slot_parts_log2(S.G), n_items = S.gpc * D.MN;
  for_parts<NT>(n_items, lps, [&](int item, int h) {
    double p[3] = {0., 0., 0.};
    const bool live = item < n_items;
    const int jl = live ? item / D.MN : 0, mn = live ? item - jl * D.MN : 0;
    if (live) {
      const LscItem it = lsc_item(D, S, w, s.MOF, jl, mn, h, lps);
      double vd[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) vd[d] = d < D.dim ? s.VD[d * D.MN + mn] : 0.;
#pragma unroll 2
      for (int u = 0; u < it.count; ++u) {
        const int r = it.r + u * it.step, n = it.n + u * it.nstep;
        double nd[3];  // the row's normal, read and converted once
        double zt = 0.;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          nd[d] = d < D.dim ? (double)s.NRM[n + d] : 0.;
          if (d < D.dim) zt += nd[d] * vd[d];
        }
        float z = s.Z[r], y = s.Y[r], ax = s.AX[r];
        update_row((float)zt, z, y, ax, s.LN[r], INFINITY, a.rho_lsc, alpha, beta);
        s.Z[r] = z;
        s.Y[r] = y;
        s.AX[r] = ax;
        const double ww = (double)(dual ? y : a.rho_lsc * z - y);
#pragma unroll
        for (int d = 0; d < 3; ++d)
          if (d < D.dim) p[d] = fma(nd[d], ww, p[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) p[d] = sum_parts(p[d], lps);
    if (live && h == 0)
#pragma unroll
      for (int d = 0; d < 3; ++d)  // constant indices: p stays in registers
        if (d < D.dim) s.PART[jl * nv + d * D.MN + mn] = p[d];
  });
  for (int q = threadIdx.x; q < w.ns; q += NT) {
    const int r = w.nl + q;
    update_row(local_stat_row(s, q), s.Z[r], s.Y[r], s.AX[r], s.LN[r], s.UN[q], s.SRHO[q],
               alpha, beta);
  }
  __syncthreads();
  if (dual)
    static_partials<NT, true>(D, S, a, w, s);
  else
    static_partials<NT, false>(D, S, a, w, s);
}

// VA = Σ_j PART_j over the cluster, in group order j = 0 .. 7, rounded once.
template <int NT>
__device__ void reduce_partials(const Dims& D, const Split& S, const cg::cluster_group& cl,
                                const CSmem& s) {
  const int nv = D.dim * D.MN;
  for (int i = threadIdx.x; i < nv; i += NT) {
    double v[kGroups];
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
      v[j] = cl.map_shared_rank(s.PART, j / S.gpc)[(j % S.gpc) * nv + i];
    double acc = v[0];
#pragma unroll
    for (int j = 1; j < kGroups; ++j) acc += v[j];
    s.VA[i] = (double)(float)acc;  // rounded once, as the register builds' accumulator
  }
}

// P·ξ per dimension into PX (float), four threads an output, each a quarter
// of the terms, added in a fixed order (CTA 0 of the cluster build).
template <int NT>
__device__ void cost_product_parts(const Dims& D, const float* pn, const float* XI,
                                   float* PX) {
  const int q = (D.K + 3) / 4;
  for_parts<NT>(D.dk, 2, [&](int j, int h) {
    float acc = 0.f;
    if (j < D.dk) {
      const int d = j / D.K, k = j - d * D.K;
      const int l1 = min(D.K, (h + 1) * q);
      for (int l = min(D.K, h * q); l < l1; ++l) acc += pn[k * D.K + l] * XI[d * D.K + l];
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    acc += __shfl_xor_sync(kFull, acc, 2);
    if (h == 0 && j < D.dk) PX[j] = acc;
  });
}

// Threads a Kinv row takes (2^lp), by dim·K: chains of ≤ 16 terms a thread
// with two accumulators.
__device__ __forceinline__ int kinv_parts_log2(int dk) {
  return dk <= 64 ? 1 : dk <= 128 ? 2 : 3;
}

// One chunk of every agent's loop, one agent per cluster of C CTAs of NT
// threads (see "The cluster build"); the early return and the launches as in
// admm_chunk_kernel.
template <int NT>
__global__ void __launch_bounds__(NT, 2)
admm_cluster_kernel(Args a, int ck, int C, int n3k) {
  if (ck > 0 && a.done_count[ck - 1] == a.A) {  // every CTA of a cluster, or none
    if (threadIdx.x == 0 && blockIdx.x == 0) a.done_count[ck] = a.A;
    return;
  }
  extern __shared__ __align__(16) float smem[];
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const size_t agent = blockIdx.x / C;
  const Dims D = make_dims(a.dim, a.O, a.M, a.N, a.K, a.R_stat);
  const Split S = make_split(D, C, n3k);
  const CSmem s = cluster_layout(smem, D, S);
  const Own w = own_rows(D, S, rank);
  const int t = threadIdx.x, nrows = w.nl + w.ns;
  const int ld = n3k ? n3k_stride(D.MN) : D.MN;
  const float* n3 = n3k ? s.N3S : a.N3k;

  const float* xi_in = ck == 0 ? a.xi0 : a.xi;
  const float* z_in = ck == 0 ? a.z0 : a.z;
  const float* y_in = ck == 0 ? a.y0 : a.y;
  // the state, the normals, Kinv, N3k and the coefficients copied in flight
  // (cp.async), the 16-bit indices read meanwhile
  for (int lr = t; lr < nrows; lr += NT) {
    const size_t g = agent * D.R + agent_row(D, w, lr);
    copy_async(s.Z + lr, z_in + g);
    copy_async(s.Y + lr, y_in + g);
    copy_async(s.LN + lr, a.ln + g);
    if (ck > 0) copy_async(s.AX + lr, a.ax + g);
    if (lr >= w.nl) copy_async(s.UN + lr - w.nl, a.un + g);
  }
  const float* nrm_g = a.normals + (agent * D.O + w.o0) * D.M * D.dim;
  for (int i = t; i < (w.o1 - w.o0) * D.M * D.dim; i += NT) copy_async(s.NRM + i, nrm_g + i);
  const float* kinv_g = a.Kinv + (agent * D.dk + w.k0) * D.dk;
  for (int i = t; i < (w.k1 - w.k0) * D.dk; i += NT) copy_async(s.KI + i, kinv_g + i);
  if (n3k)
    for (int i = t; i < D.K * D.MN; i += NT) {
      const int k = i / D.MN;
      copy_async(s.N3S + k * ld + i - k * D.MN, a.N3k + i);
    }
  for (int j = t; j < D.dk; j += NT) {
    copy_async(s.XI + j, xi_in + agent * D.dk + j);
    copy_async(s.XIP + j, xi_in + agent * D.dk + j);
    copy_async(s.QN + j, a.qn + agent * D.dk + j);
  }
  // this CTA's static rows' stencils and ρ, by local row q
  for (int q = t; q < w.ns; q += NT) {
    const int st = w.s0 + q;
#pragma unroll
    for (int e = 0; e < kWidth; ++e)
      copy_async(s.SCOEF + q * kWidth + e, a.st_coef + st * kWidth + e);
    copy_async(s.SRHO + q, a.rho_stat + st);
  }
  for (int mn = t; mn < D.MN; mn += NT) s.MOF[mn] = mn / D.N;
#pragma unroll 4
  for (int i = t; i < w.ns * kWidth; i += NT)
    s.SIDX[i] = (unsigned short)__ldg(a.st_idx + w.s0 * kWidth + i);
  // its groups' transposed stencils: the global group pointers of groups
  // g0 .. g0 + gpc, then column i's entries of its groups packed at base[i]
  // (a prefix sum over the columns in warp 0, into VD's space), group jl's
  // from LGP[jl·nv + i] to LGP[(jl + 1)·nv + i], the rows local
  const int nv = D.dim * D.MN;
  const int* gp0 = a.grp_ptr + w.g0 * nv;
#pragma unroll 4
  for (int i = t; i < (S.gpc + 1) * nv; i += NT) s.LGP[i] = (unsigned short)__ldg(gp0 + i);
  copy_async_wait();
  __syncthreads();
  int* base = reinterpret_cast<int*>(s.VD);  // free until the control points
  if (t < 32) {
    int run = 0;
    for (int b = 0; b < nv; b += 32) {
      const int i = b + t;
      const int n = i < nv ? s.LGP[S.gpc * nv + i] - s.LGP[i] : 0;
      int incl = n;
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, off);
        if (t >= off) incl += u;
      }
      if (i < nv) base[i] = run + incl - n;
      run += __shfl_sync(kFull, incl, 31);
    }
  }
  __syncthreads();
  for (int i = t; i < nv; i += NT) {
    const int e0 = s.LGP[i], e1 = s.LGP[S.gpc * nv + i], b = base[i];
#pragma unroll 4
    for (int e = e0; e < e1; ++e) {
      s.EROW[b + e - e0] = (unsigned short)(__ldg(a.adj_row + e) - w.s0);
      s.ECOEF[b + e - e0] = __ldg(a.adj_coef + e);
    }
    for (int jl = 0; jl <= S.gpc; ++jl)
      s.LGP[jl * nv + i] = (unsigned short)(b + s.LGP[jl * nv + i] - e0);
  }
  __syncthreads();
  group_partials<NT, false>(D, S, a, w, s);  // of the state loaded
  if (ck == 0) {  // A·xi of the warm start
    cluster_points<NT>(D, s.XI, n3, ld, s.VD);
    __syncthreads();
    for_lsc_rows<NT>(D, w.nl, [&](int r, int o, int mn) {
      s.AX[r] = lsc_row(D, s.NRM, s.MOF, s.VD, o, mn);
    });
    for (int q = t; q < w.ns; q += NT) s.AX[w.nl + q] = local_stat_row(s, q);
    __syncthreads();
  }

  const float alpha = a.alpha, beta = a.one_minus_alpha;
  const int lp = kinv_parts_log2(D.dk), part = (D.dk + (1 << lp) - 1) >> lp;
  const int nk = w.k1 - w.k0;
  for (int it = 0; it < a.chunk; ++it) {
    // (1) the partials of Aᵀ(ρz − y) of this CTA's groups: formed by the
    // previous iteration's row updates (the first by the load)
    cl.sync();
    // (2) the whole accumulator; rhs = σξ − q + Aᵀ(ρz − y), in double
    reduce_partials<NT>(D, S, cl, s);
    __syncthreads();
    cluster_adjoint<NT>(D, n3, ld, s.VA, [&](int k, double g) {
      s.RHSD[k] = ((double)a.sigma * s.XI[k] - (double)s.QN[k]) + g;
    });
    __syncthreads();
    // (3) this CTA's rows of ξ̃ = Kinv·rhs, in double
    for_parts<NT>(nk, lp, [&](int r, int h) {
      double p = 0.;
      if (r < nk) {
        const float* kr = s.KI + r * D.dk;
        p = dot4(min(D.dk, h * part), min(D.dk, (h + 1) * part),
                 [&](int c) { return make_double2((double)kr[c], s.RHSD[c]); });
      }
      p = sum_parts(p, lp);
      if (h == 0 && r < nk) s.XTD[w.k0 + r] = p;
    });
    cl.sync();
    // (4) the other CTAs' rows of ξ̃
    for (int k = t; k < D.dk; k += NT) {
      const int owner = k / S.kr;
      if (owner != rank) s.XTD[k] = cl.map_shared_rank(s.XTD, owner)[k];
    }
    __syncthreads();
    // (5) control points of ξ̃; ξ ← αξ̃ + (1 − α)ξ; this CTA's rows
    cluster_points<NT>(D, s.XTD, n3, ld, s.VD);
    for (int j = t; j < D.dk; j += NT) s.XI[j] = alpha * (float)s.XTD[j] + beta * s.XI[j];
    __syncthreads();
    cluster_rows<NT>(D, S, a, w, s, alpha, beta, it == a.chunk - 1);
  }
  __syncthreads();

  // ---- exit tests on the actual iterate ----
  const float* scale_g = a.scale + agent * D.R;
  float viol = 0.f;
#pragma unroll 4
  for (int lr = t; lr < nrows; lr += NT) {
    const float axr = s.AX[lr];
    const float hi = lr < w.nl ? INFINITY : s.UN[lr - w.nl];
    const float vr = fmaxf(fmaxf(s.LN[lr] - axr, axr - hi), 0.f);
    viol = fmaxf(viol, vr / scale_g[agent_row(D, w, lr)]);
  }
  // PART holds the partials of Aᵀy (the last iteration's row updates)
  for (int off = 16; off > 0; off >>= 1) viol = fmaxf(viol, __shfl_xor_sync(kFull, viol, off));
  float* VIOL = s.RED + 8 * (NT / 32);  // this CTA's largest violation, read by CTA 0
  if ((t & 31) == 0) s.RED[t >> 5] = viol;
  __syncthreads();
  if (t == 0) {
    float m = s.RED[0];
    for (int u = 1; u < NT / 32; ++u) m = fmaxf(m, s.RED[u]);
    *VIOL = m;
  }
#pragma unroll 4
  for (int lr = t; lr < nrows; lr += NT) {
    const size_t g = agent * D.R + agent_row(D, w, lr);
    a.z[g] = s.Z[lr];
    a.y[g] = s.Y[lr];
    a.ax[g] = s.AX[lr];
  }
  cl.sync();
  if (rank == 0) {  // uniform over the CTA: its barriers are the CTA's own
    reduce_partials<NT>(D, S, cl, s);
    const float* pn = a.Pn + agent * D.K * D.K;  // into the free Kinv rows where it fits
    if (D.K * D.K <= S.kr * D.dk) {
#pragma unroll 4
      for (int i = t; i < D.K * D.K; i += NT) s.KI[i] = pn[i];
      pn = s.KI;
    }
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int u = 0; u < C; ++u) v[0] = fmaxf(v[0], *cl.map_shared_rank(VIOL, u));
    __syncthreads();
    float* PX = reinterpret_cast<float*>(s.RHSD);  // rhs is free here
    float* ATY = PX + D.dk;
    cluster_adjoint<NT>(D, n3, ld, s.VA, [&](int k, double g) { ATY[k] = (float)g; });
    cost_product_parts<NT>(D, pn, s.XI, PX);
    __syncthreads();
    dual_terms<NT>(D, PX, ATY, s.QN, s.XI, s.XIP, v);
    block_reduce8<NT>(v, s.RED);
    for (int j = t; j < D.dk; j += NT) a.xi[agent * D.dk + j] = s.XI[j];
    if (t == 0) exit_gates(a, v, agent, ck);
  }
  cl.sync();  // no CTA leaves while CTA 0 may still read its shared memory
}

// ---- the global build -------------------------------------------------

// One agent a block of kGlobalThreads, its rows and Kinv streamed from
// global memory through a ring of kGlobalStages stages in shared memory
// (see "The global build" at the top). The stage sizes: what leaves two
// blocks an SM in the H100's shared memory (one, where two never fit), at
// most kGlobalStageCap floats.
constexpr int kGlobalThreads = 256;
constexpr int kGlobalStages = 3;
constexpr int kGlobalStageCap = 8192;  // floats a stage (32 KB)
constexpr int kTileRanges = 6;  // copies a tile at most (z, y, A·xi, l, u or scale, normals)
constexpr size_t kOneBlockBytes = 232448;  // the H100's opt-in shared memory a block
constexpr size_t kTwoBlockBytes = (kOneBlockBytes + 1024) / 2 - 1024;  // 1 KB reserved a block

// The global build's tiles for a shape (mirrored by qp_cuda.global_tile_plan):
// G slots and GS static rows a group; 2^lps threads an LSC item, n2
// thread-items of a group's LSC partial in ntrips trips of the block; T
// slots an LSC tile, ST rows a static tile, KT rows a Kinv tile; the floats
// of a stage (0: no tile fits) and of what precedes the ring; nK Kinv tiles
// and nR row tiles a pass.
struct GPlan {
  int G, GS, lps, n2, ntrips, T, ST, KT, stage, resident, nK, nR;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// A stage's floats for an LSC tile of t slots: z, y, A·xi, l and scale of
// its rows and its slots' normals, each region 16-B aligned with room for
// a head of up to 3 floats (issue_copy); a static tile of n rows: z, y,
// A·xi, l, u and scale; a Kinv tile of k rows.
__host__ __device__ inline int lsc_tile_floats(const Dims& D, int t) {
  return 5 * round4(t * D.MN + 3) + round4(t * D.M * D.dim + 3);
}
__host__ __device__ inline int stat_tile_floats(int n) { return 6 * round4(n + 3); }
__host__ __device__ inline int kinv_tile_floats(const Dims& D, int k) {
  return round4(k * D.dk + 3);
}

// Group j's slots [oa, ob) and static rows [sa, sb), and its row tiles.
__host__ __device__ inline int group_o0(const Dims& D, const GPlan& P, int j) {
  return min(D.O, j * P.G);
}
__host__ __device__ inline int group_o1(const Dims& D, const GPlan& P, int j) {
  return min(D.O, group_o0(D, P, j) + P.G);
}
__host__ __device__ inline int group_s0(const Dims& D, const GPlan& P, int j) {
  return min(D.R_stat, j * P.GS);
}
__host__ __device__ inline int group_s1(const Dims& D, const GPlan& P, int j) {
  return min(D.R_stat, group_s0(D, P, j) + P.GS);
}
__host__ __device__ inline int group_lsc_tiles(const Dims& D, const GPlan& P, int j) {
  return (group_o1(D, P, j) - group_o0(D, P, j) + P.T - 1) / P.T;
}
__host__ __device__ inline int group_tiles(const Dims& D, const GPlan& P, int j) {
  return group_lsc_tiles(D, P, j) + (group_s1(D, P, j) - group_s0(D, P, j) + P.ST - 1) / P.ST;
}

GPlan global_plan(const Dims& D) {
  GPlan P{};
  P.G = (D.O + kGroups - 1) / kGroups;
  P.GS = (D.R_stat + kGroups - 1) / kGroups;
  P.lps = slot_parts_log2(P.G);
  P.n2 = ((D.MN << P.lps) + 31) & ~31;
  P.ntrips = (P.n2 + kGlobalThreads - 1) / kGlobalThreads;
  const int nv = D.dim * D.MN;
  P.resident = round4(2 * (4 * nv + 2 * D.dk + 3 * kGlobalThreads * P.ntrips + kGlobalStages) +
                      3 * D.dk + P.GS + 8 * (kGlobalThreads / 32) + D.MN + 2 * kGroups + 1);
  const int need = max(lsc_tile_floats(D, 1), max(stat_tile_floats(1), kinv_tile_floats(D, 1)));
  const size_t budgets[2] = {kTwoBlockBytes, kOneBlockBytes};
  for (const size_t budget : budgets) {
    const long s = ((long)(budget / 4) - P.resident) / kGlobalStages;
    const int stage = (int)(s < kGlobalStageCap ? s : kGlobalStageCap) & ~3;
    if (stage >= need) {
      P.stage = stage;
      break;
    }
  }
  if (!P.stage) return P;
  P.T = 1;
  while (P.T < P.G && lsc_tile_floats(D, P.T + 1) <= P.stage) ++P.T;
  P.ST = 1;
  while (P.ST < P.GS && stat_tile_floats(P.ST + 1) <= P.stage) ++P.ST;
  P.KT = 1;
  while (P.KT < D.dk && kinv_tile_floats(D, P.KT + 1) <= P.stage) ++P.KT;
  P.nK = (D.dk + P.KT - 1) / P.KT;
  P.nR = 0;
  for (int j = 0; j < kGroups; ++j) P.nR += group_tiles(D, P, j);
  // a row is read again only after the tile that wrote it and its group's
  // proxy fence (global_row_pass): at least kGlobalStages − 1 tiles a pass
  // outside any one group's
  for (int j = 0; j < kGroups; ++j)
    if (P.nK + P.nR - group_tiles(D, P, j) < kGlobalStages - 1) P.stage = 0;
  return P;
}

// The block's shared memory, bytes; 0 for a shape no block holds.
size_t global_smem(const Dims& D) {
  const GPlan P = global_plan(D);
  return P.stage ? sizeof(float) * ((size_t)P.resident + (size_t)kGlobalStages * P.stage) : 0;
}

// The block's arrays before the ring (floats; the doubles first): VD, SUM
// (the running sum of the group partials), GP (the group's partial), VA
// [dim*MN] and RHSD, XTD [dk] (doubles); IACC [3 · NT · ntrips] (doubles:
// each thread-item's LSC partial across the group's tiles); BAR
// [kGlobalStages] (the stages' mbarriers); XI, XIP, QN [dk]; WS [GS] (the
// group's static-row cotangents); RED [8 per warp]; MOF [MN], TT [2·8 + 1]
// (int: each group's first row tile and, from TT[9], its LSC tiles).
// Derived afresh where it is used, from the block's dynamic shared memory.
struct GSmem {
  double *VD, *SUM, *GP, *VA, *RHSD, *XTD, *IACC;
  unsigned long long* BAR;
  float *XI, *XIP, *QN, *WS, *RED, *RING;
  int *MOF, *TT;
};

template <int NT>
__device__ __forceinline__ GSmem gview(const Dims& D, const GPlan& P) {
  extern __shared__ __align__(16) float g_smem[];
  const int nv = D.dim * D.MN;
  GSmem s;
  s.VD = reinterpret_cast<double*>(g_smem);
  s.SUM = s.VD + nv;
  s.GP = s.SUM + nv;
  s.VA = s.GP + nv;
  s.RHSD = s.VA + nv;
  s.XTD = s.RHSD + D.dk;
  s.IACC = s.XTD + D.dk;
  s.BAR = reinterpret_cast<unsigned long long*>(s.IACC + 3 * NT * P.ntrips);
  s.XI = reinterpret_cast<float*>(s.BAR + kGlobalStages);
  s.XIP = s.XI + D.dk;
  s.QN = s.XIP + D.dk;
  s.WS = s.QN + D.dk;
  s.RED = s.WS + P.GS;
  s.MOF = reinterpret_cast<int*>(s.RED + 8 * (NT / 32));
  s.TT = s.MOF + D.MN;
  s.RING = g_smem + P.resident;
  return s;
}

// Where n floats at src lie in a 16-B aligned region of a stage: `head`
// floats in, so that source and copy agree modulo 16 B.
__device__ __forceinline__ int head_of(const float* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}
__device__ __forceinline__ const float* staged(const float* region, const float* src) {
  return region + head_of(src);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The stages' mbarriers: one arrival (the tile's expected bytes) a phase.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Waits for the phase of the given parity to complete; a wait past ~10^9
// polls (seconds) traps, so that a lost copy fails the launch.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned b = smem_addr(bar);
  for (long long polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1ll << 30)) __trap();
  }
}

// A bulk copy (the tensor memory accelerator) of `bytes` (a multiple of 16,
// both ends 16-B aligned) from global to shared memory, counted on `bar`.
__device__ __forceinline__ void copy_bulk(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier stores to global memory before the bulk
// copies (another proxy) issued after the next block barrier.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Copy k of tile n of the launch's stream: the first pass's row tiles (z
// and y of the state loaded, the normals), then per iteration the Kinv
// tiles and the row tiles (z, y, A·xi, l, u of the static rows, the
// normals; scale in the chunk's last iteration, for the exit test): its
// source, its floats (0: none) and its region's offset in the stage
// (lsc_region, stat_region).
struct TileCopy {
  const float* src;
  int n, off;
};

// An LSC tile's regions: z, y, A·xi, l, scale (c = round4(T·MN + 3) floats
// each), the normals from 5c; a static tile's: z, y, A·xi, l, u, scale
// (round4(ST + 3) each).
__device__ __forceinline__ int lsc_region(const Dims& D, const GPlan& P) {
  return round4(P.T * D.MN + 3);
}
__device__ __forceinline__ int stat_region(const GPlan& P) { return round4(P.ST + 3); }

__device__ __forceinline__ TileCopy tile_copy(const Args& a, const Dims& D, const GPlan& P,
                                              const int* TT, size_t agent, int ck, int n, int k) {
  const TileCopy none{nullptr, 0, 0};
  const bool first = n < P.nR;
  int it = 0, m = n;
  if (!first) {
    n -= P.nR;
    it = n / (P.nK + P.nR);
    m = n - it * (P.nK + P.nR);
    if (m < P.nK) {
      const int k0 = m * P.KT;
      return k ? none
               : TileCopy{a.Kinv + (agent * D.dk + k0) * D.dk, (min(D.dk, k0 + P.KT) - k0) * D.dk, 0};
    }
    m -= P.nK;
  }
  int j = 0;
  while (m >= TT[j + 1]) ++j;
  m -= TT[j];
  const bool last = !first && it == a.chunk - 1;
  const float* z = first && ck == 0 ? a.z0 : a.z;
  const float* y = first && ck == 0 ? a.y0 : a.y;
  if (m < TT[kGroups + 1 + j]) {  // an LSC tile: slots [lo, hi); k: z, y, A·xi, l, scale, normals
    if ((first && k >= 2 && k <= 4) || (k == 4 && !last)) return none;
    const int lo = group_o0(D, P, j) + m * P.T, hi = min(group_o1(D, P, j), lo + P.T);
    const int c = lsc_region(D, P);
    if (k == 5)
      return TileCopy{a.normals + (agent * D.O + lo) * D.M * D.dim, (hi - lo) * D.M * D.dim, 5 * c};
    const float* src = k == 0 ? z : k == 1 ? y : k == 2 ? a.ax : k == 3 ? a.ln : a.scale;
    return TileCopy{src + agent * D.R + (size_t)lo * D.MN, (hi - lo) * D.MN, k * c};
  }
  m -= TT[kGroups + 1 + j];  // a static tile: rows [lo, hi); k: z, y, A·xi, l, u, scale
  if ((first && k >= 2) || (k == 5 && !last)) return none;
  const int lo = group_s0(D, P, j) + m * P.ST, hi = min(group_s1(D, P, j), lo + P.ST);
  const float* src = k == 0 ? z : k == 1 ? y : k == 2 ? a.ax : k == 3 ? a.ln : k == 4 ? a.un
                                                                                   : a.scale;
  return TileCopy{src + agent * D.R + D.R_lsc + lo, hi - lo, k * stat_region(P)};
}

// Copy `lane` of tile n into its stage (n % kGlobalStages), by a lane of
// the warp whose turn it is (the warps take the tiles in turn, n % 8):
// lane k expects copy k's 16-B body on the stage's mbarrier and issues it
// as a bulk copy, and copies the floats before its source's first 16-B
// boundary and past its last 4 B at a time (cp.async; qp_cuda.copy_split);
// then lane 0 arrives, once a phase. `r` is tile_copy's, decoded before
// the stage is free.
__device__ __forceinline__ void issue_copy(const GPlan& P, const GSmem& s, int n, TileCopy r) {
  const int lane = threadIdx.x & 31;
  float* st = s.RING + (n % kGlobalStages) * P.stage;
  unsigned long long* bar = s.BAR + n % kGlobalStages;
  if (r.n) {
    const int head = head_of(r.src), pre = min(r.n, (4 - head) & 3);
    const int body = (r.n - pre) >> 2;
    float* dst = st + r.off + head;
    if (body) {
      mbar_expect(bar, 16u * body);
      copy_bulk(dst + pre, r.src + pre, 16u * body, bar);
    }
    for (int e = 0; e < pre; ++e) copy_async(dst + e, r.src + e);
    for (int e = pre + 4 * body; e < r.n; ++e) copy_async(dst + e, r.src + e);
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Whether this thread's warp issues tile n, and its lane's copy of it.
__device__ __forceinline__ TileCopy my_copy(const Args& a, const Dims& D, const GPlan& P,
                                            const GSmem& s, size_t agent, int ck, int n,
                                            bool& mine) {
  mine = n < P.nR + a.chunk * (P.nK + P.nR) &&
         (threadIdx.x >> 5) == n % (kGlobalThreads / 32);
  const int lane = threadIdx.x & 31;
  return mine && lane < kTileRanges ? tile_copy(a, D, P, s.TT, agent, ck, n, lane)
                                    : TileCopy{nullptr, 0, 0};
}

// The ring: tile `next` is consumed from stage next % kGlobalStages while
// the kGlobalStages − 1 tiles after it are in flight. acquire() decodes
// the tile kGlobalStages − 1 ahead (on the warp whose turn it is), waits
// for tile `next` (the thread's 4-B copies, then the stage's mbarrier at
// the tile's phase) and fences the thread's writes to shared memory (those
// copies, the static rows updated in their stage) from the bulk copies;
// then a block barrier makes every thread's copies visible and frees the
// stage of the tile before it, whose consumption every thread has
// finished, and the warp refills that stage with the tile ahead (a commit
// group a thread, empty but for the issuing warp's 4-B copies).
struct Ring {
  int next;
};

__device__ __forceinline__ const float* ring_acquire(Ring& R, const Args& a, const Dims& D,
                                                     const GPlan& P, const GSmem& s,
                                                     size_t agent, int ck) {
  const int n = R.next++, ahead = n + kGlobalStages - 1;
  bool mine;
  const TileCopy r = my_copy(a, D, P, s, agent, ck, ahead, mine);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kGlobalStages - 2) : "memory");
  mbar_wait(s.BAR + n % kGlobalStages, (n / kGlobalStages) & 1);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (mine) issue_copy(P, s, ahead, r);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return s.RING + (n % kGlobalStages) * P.stage;
}

// Pass mode: the launch's first pass (the partials of the state loaded;
// at ck 0 the state and A·xi of the warm start into the loop's buffers),
// or an iteration's row updates; `last`: the chunk's last iteration (its
// partials are of y, for the exit test's Aᵀy, and it reads scale).
struct PassMode {
  bool first, last;
};

// One LSC tile, slots [u0, u1) of a group whose slots start at oa: each
// thread-item (control point mn, slot part h) takes its slots o ≡ oa + h
// (mod 2^lps) of the tile in slot order, its partial carried across the
// group's tiles in IACC (`fresh`: the group's first tile).
template <int NT>
__device__ __forceinline__ void global_lsc_tile(const Args& a, const Dims& D, const GPlan& P,
                                                size_t agent, int ck, const float* st, int oa,
                                                int u0, int u1, bool fresh, PassMode pm,
                                                float alpha, float beta, float& viol) {
  const GSmem s = gview<NT>(D, P);
  const int sp = 1 << P.lps, c = lsc_region(D, P);
  const size_t rb = agent * D.R + (size_t)u0 * D.MN;
  const float* Zs = staged(st, (pm.first && ck == 0 ? a.z0 : a.z) + rb);
  const float* Ys = staged(st + c, (pm.first && ck == 0 ? a.y0 : a.y) + rb);
  const float* AXs = staged(st + 2 * c, a.ax + rb);
  const float* LNs = staged(st + 3 * c, a.ln + rb);
  const float* SCs = staged(st + 4 * c, a.scale + rb);
  const float* NRs = staged(st + 5 * c, a.normals + (agent * D.O + u0) * D.M * D.dim);
  float* zg = a.z + rb;
  float* yg = a.y + rb;
  float* axg = a.ax + rb;
  const double rinv = recip(a.rho_lsc);
  for (int k = 0; k < P.ntrips; ++k) {
    const int i2 = threadIdx.x + k * NT, mn = i2 >> P.lps, h = i2 & (sp - 1);
    if (i2 >= P.n2 || mn >= D.MN) continue;
    double* acc = s.IACC + 3 * k * NT + threadIdx.x;
    double p[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) p[d] = fresh ? 0. : acc[d * NT];
    int o = oa + h;
    if (o < u0) o += ((u0 - o + sp - 1) >> P.lps) << P.lps;
    const int m = s.MOF[mn];
    if (pm.first) {
      for (; o < u1; o += sp) {
        const int r = (o - u0) * D.MN + mn, n = ((o - u0) * D.M + m) * D.dim;
        const float z = Zs[r], y = Ys[r];
        const double ww = (double)(a.rho_lsc * z - y);
#pragma unroll
        for (int d = 0; d < 3; ++d)
          if (d < D.dim) p[d] = fma((double)NRs[n + d], ww, p[d]);
        if (ck == 0) {
          zg[r] = z;
          yg[r] = y;
          axg[r] = lsc_row(D, NRs, s.MOF, s.VD, o - u0, mn);
        }
      }
    } else {
      double vd[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) vd[d] = d < D.dim ? s.VD[d * D.MN + mn] : 0.;
      for (; o < u1; o += sp) {
        const int r = (o - u0) * D.MN + mn, n = ((o - u0) * D.M + m) * D.dim;
        double nd[3];  // the row's normal, read and converted once
        double zt = 0.;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          nd[d] = d < D.dim ? (double)NRs[n + d] : 0.;
          if (d < D.dim) zt += nd[d] * vd[d];
        }
        float z = Zs[r], y = Ys[r], ax = AXs[r];
        const float lo = LNs[r];
        update_row_rcp((float)zt, z, y, ax, lo, INFINITY, a.rho_lsc, rinv, alpha, beta);
        zg[r] = z;
        yg[r] = y;
        axg[r] = ax;
        if (pm.last) {
          const float vr = fmaxf(fmaxf(lo - ax, ax - INFINITY), 0.f);
          viol = fmaxf(viol, vr / SCs[r]);
        }
        const double ww = (double)(pm.last ? y : a.rho_lsc * z - y);
#pragma unroll
        for (int d = 0; d < 3; ++d)
          if (d < D.dim) p[d] = fma(nd[d], ww, p[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) acc[d * NT] = p[d];
  }
}

// The group's LSC partial from the thread-items' partials (zero where the
// group has no slot: `fresh`), the slot parts added by a butterfly, into
// GP. Every lane of a warp with a trip runs it (n2 is a multiple of 32).
template <int NT>
__device__ __forceinline__ void global_lsc_partial(const Dims& D, const GPlan& P, bool fresh) {
  const GSmem s = gview<NT>(D, P);
  for (int k = 0; k < P.ntrips; ++k) {
    const int i2 = threadIdx.x + k * NT, mn = i2 >> P.lps, h = i2 & ((1 << P.lps) - 1);
    if (i2 >= P.n2) break;
    const bool live = mn < D.MN;
    double p[3] = {0., 0., 0.};
    if (live && !fresh)
#pragma unroll
      for (int d = 0; d < 3; ++d) p[d] = s.IACC[(3 * k + d) * NT + threadIdx.x];
#pragma unroll
    for (int d = 0; d < 3; ++d) p[d] = sum_parts(p[d], P.lps);
    if (live && h == 0)
#pragma unroll
      for (int d = 0; d < 3; ++d)  // constant indices: p stays in registers
        if (d < D.dim) s.GP[d * D.MN + mn] = p[d];
  }
}

// One static tile, rows [q0, q1) of a group whose static rows start at sa:
// a thread a row; each row's cotangent (ρz − y, or y) into WS.
template <int NT>
__device__ __forceinline__ void global_stat_tile(const Args& a, const Dims& D, const GPlan& P,
                                                 size_t agent, int ck, const float* st, int sa,
                                                 int q0, int q1, PassMode pm, float alpha,
                                                 float beta, float& viol) {
  const GSmem s = gview<NT>(D, P);
  const int c = stat_region(P);
  const size_t rb = agent * D.R + D.R_lsc + q0;
  const float* Zs = staged(st, (pm.first && ck == 0 ? a.z0 : a.z) + rb);
  const float* Ys = staged(st + c, (pm.first && ck == 0 ? a.y0 : a.y) + rb);
  const float* AXs = staged(st + 2 * c, a.ax + rb);
  const float* LNs = staged(st + 3 * c, a.ln + rb);
  const float* UNs = staged(st + 4 * c, a.un + rb);
  const float* SCs = staged(st + 5 * c, a.scale + rb);
  for (int q = threadIdx.x; q < q1 - q0; q += NT) {
    const int sr = q0 + q;
    const float rho = __ldg(a.rho_stat + sr);
    if (pm.first) {
      const float z = Zs[q], y = Ys[q];
      if (ck == 0) {
        a.z[rb + q] = z;
        a.y[rb + q] = y;
        a.ax[rb + q] = stat_row(a, s.VD, sr);
      }
      s.WS[sr - sa] = rho * z - y;
      continue;
    }
    // in place in the stage, as the cluster build updates its rows in
    // shared memory
    float* Zq = const_cast<float*>(Zs) + q;
    float* Yq = const_cast<float*>(Ys) + q;
    float* AXq = const_cast<float*>(AXs) + q;
    update_row(stat_row(a, s.VD, sr), *Zq, *Yq, *AXq, LNs[q], UNs[q], rho, alpha, beta);
    const float z = *Zq, y = *Yq, ax = *AXq;
    a.z[rb + q] = z;
    a.y[rb + q] = y;
    a.ax[rb + q] = ax;
    if (pm.last) {
      const float vr = fmaxf(fmaxf(LNs[q] - ax, ax - UNs[q]), 0.f);
      viol = fmaxf(viol, vr / SCs[q]);
    }
    s.WS[sr - sa] = pm.last ? y : rho * z - y;
  }
}

// Group j's static partials (its entries of each transposed-stencil
// column, in entry order) added to its LSC partial, and the group's whole
// partial added to the running sum in group order (group 0 starts it):
// the cluster build's reduce_partials sums. Reads GP and WS behind a
// barrier.
template <int NT>
__device__ __forceinline__ void global_group_sum(const Args& a, const Dims& D, const GPlan& P,
                                                 int j, int sa) {
  const GSmem s = gview<NT>(D, P);
  const int nv = D.dim * D.MN;
  const int* gp = a.grp_ptr + j * nv;
  for (int i = threadIdx.x; i < nv; i += NT) {
    const int e1 = __ldg(gp + nv + i);
    double acc = 0.;
    for (int e = __ldg(gp + i); e < e1; ++e)
      acc = fma((double)__ldg(a.adj_coef + e), (double)s.WS[__ldg(a.adj_row + e) - sa], acc);
    const double p = s.GP[i] + acc;
    s.SUM[i] = j == 0 ? p : s.SUM[i] + p;
  }
}

// One pass over the agent's rows, group by group: its LSC tiles, its LSC
// partial, its static tiles, its partial into the running sum. Each
// thread's stores of the group's rows are fenced from the bulk copies
// that read them again in the next pass (issued after a later barrier).
template <int NT>
__device__ __forceinline__ void global_row_pass(const Args& a, const Dims& D, const GPlan& P,
                                                Ring& R, size_t agent, int ck, PassMode pm,
                                                float alpha, float beta, float& viol) {
  for (int j = 0; j < kGroups; ++j) {
    const int oa = group_o0(D, P, j), ob = group_o1(D, P, j);
    for (int u0 = oa; u0 < ob; u0 += P.T) {
      const float* st = ring_acquire(R, a, D, P, gview<NT>(D, P), agent, ck);
      global_lsc_tile<NT>(a, D, P, agent, ck, st, oa, u0, min(ob, u0 + P.T), u0 == oa, pm, alpha,
                          beta, viol);
    }
    global_lsc_partial<NT>(D, P, ob == oa);
    const int sa = group_s0(D, P, j), sb = group_s1(D, P, j);
    for (int q0 = sa; q0 < sb; q0 += P.ST) {
      const float* st = ring_acquire(R, a, D, P, gview<NT>(D, P), agent, ck);
      global_stat_tile<NT>(a, D, P, agent, ck, st, sa, q0, min(sb, q0 + P.ST), pm, alpha, beta,
                           viol);
    }
    fence_proxy_async_global();
    __syncthreads();
    global_group_sum<NT>(a, D, P, j, sa);
    __syncthreads();
  }
}

// One chunk of every agent's loop on the global build: the cluster build's
// order of operations (its fixed groups, partials, Kinv parts and exit
// test) in one block, the rows and Kinv streamed through the ring; the
// early return and the launches as in admm_chunk_kernel.
template <int NT>
__global__ void __launch_bounds__(NT, 2)
admm_global_kernel(Args a, int ck, GPlan P) {
  if (ck > 0 && a.done_count[ck - 1] == a.A) {
    if (threadIdx.x == 0 && blockIdx.x == 0) a.done_count[ck] = a.A;
    return;
  }
  const Dims D = make_dims(a.dim, a.O, a.M, a.N, a.K, a.R_stat);
  const int t = threadIdx.x, nv = D.dim * D.MN;
  const size_t agent = blockIdx.x;
  {
    const GSmem s = gview<NT>(D, P);
    if (t == 0) {  // the row tiles' table; the stages' mbarriers
      int n = 0;
      for (int j = 0; j < kGroups; ++j) {
        s.TT[j] = n;
        s.TT[kGroups + 1 + j] = group_lsc_tiles(D, P, j);
        n += group_tiles(D, P, j);
      }
      s.TT[kGroups] = n;
      for (int k = 0; k < kGlobalStages; ++k) mbar_init(s.BAR + k);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    for (int n = 0; n < kGlobalStages - 1; ++n) {  // the first tiles
      bool mine;
      const TileCopy r = my_copy(a, D, P, s, agent, ck, n, mine);
      if (mine) issue_copy(P, s, n, r);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const float* xi_in = ck == 0 ? a.xi0 : a.xi;
    for (int j = t; j < D.dk; j += NT) {
      s.XI[j] = xi_in[agent * D.dk + j];
      s.XIP[j] = s.XI[j];
      s.QN[j] = a.qn[agent * D.dk + j];
    }
    for (int mn = t; mn < D.MN; mn += NT) s.MOF[mn] = mn / D.N;
    __syncthreads();
    if (ck == 0) cluster_points<NT>(D, s.XI, a.N3k, D.MN, s.VD);  // A·xi of the warm start
  }
  Ring R{0};
  float viol = 0.f;
  const float alpha = a.alpha, beta = a.one_minus_alpha;
  global_row_pass<NT>(a, D, P, R, agent, ck, PassMode{true, false}, alpha, beta, viol);

  const int lp = kinv_parts_log2(D.dk), part = (D.dk + (1 << lp) - 1) >> lp;
  for (int it = 0; it < a.chunk; ++it) {
    {  // the accumulator, rounded once; rhs = σξ − q + Aᵀ(ρz − y), in double
      const GSmem s = gview<NT>(D, P);
      for (int i = t; i < nv; i += NT) s.VA[i] = (double)(float)s.SUM[i];
      __syncthreads();
      cluster_adjoint<NT>(D, a.N3k, D.MN, s.VA, [&](int k, double g) {
        s.RHSD[k] = ((double)a.sigma * s.XI[k] - (double)s.QN[k]) + g;
      });
    }
    // ξ̃ = Kinv·rhs in double, Kinv a tile of rows at a time
    for (int k0 = 0; k0 < D.dk; k0 += P.KT) {
      const GSmem s = gview<NT>(D, P);
      const int nk = min(D.dk, k0 + P.KT) - k0;
      const float* KI = staged(ring_acquire(R, a, D, P, s, agent, ck),
                               a.Kinv + (agent * D.dk + k0) * D.dk);
      for_parts<NT>(nk, lp, [&](int r, int h) {
        double p = 0.;
        if (r < nk) {
          const float* kr = KI + r * D.dk;
          p = dot4(min(D.dk, h * part), min(D.dk, (h + 1) * part),
                   [&](int c) { return make_double2((double)kr[c], s.RHSD[c]); });
        }
        p = sum_parts(p, lp);
        if (h == 0 && r < nk) s.XTD[k0 + r] = p;
      });
    }
    __syncthreads();
    {  // control points of ξ̃; ξ ← αξ̃ + (1 − α)ξ; the rows
      const GSmem s = gview<NT>(D, P);
      cluster_points<NT>(D, s.XTD, a.N3k, D.MN, s.VD);
      for (int j = t; j < D.dk; j += NT) s.XI[j] = alpha * (float)s.XTD[j] + beta * s.XI[j];
    }
    const bool last = it == a.chunk - 1;
    global_row_pass<NT>(a, D, P, R, agent, ck, PassMode{false, last}, alpha, beta, viol);
  }

  // ---- exit tests on the actual iterate (the last pass's partials: of y) ----
  const GSmem s = gview<NT>(D, P);
  for (int i = t; i < nv; i += NT) s.VA[i] = (double)(float)s.SUM[i];
  __syncthreads();
  float* PX = reinterpret_cast<float*>(s.RHSD);  // rhs is free here
  float* ATY = PX + D.dk;
  cluster_adjoint<NT>(D, a.N3k, D.MN, s.VA, [&](int k, double g) { ATY[k] = (float)g; });
  cost_product_parts<NT>(D, a.Pn + agent * D.K * D.K, s.XI, PX);
  __syncthreads();
  float v[8] = {viol, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  dual_terms<NT>(D, PX, ATY, s.QN, s.XI, s.XIP, v);
  block_reduce8<NT>(v, s.RED);
  for (int j = t; j < D.dk; j += NT) a.xi[agent * D.dk + j] = s.XI[j];
  if (t == 0) exit_gates(a, v, agent, ck);
}

// The one-block builds' kernels: the chunk kernel, its threads and its launch.
template <int NT, int KC>
struct OneBlock {
  static constexpr auto kern = admm_chunk_kernel<NT, KC>;
  static constexpr int threads = NT;
  static constexpr int blocks = 0;  // the carveout: all shared
  static void launch(const Args& a, int ck, int A, size_t smem, cudaStream_t stream) {
    admm_chunk_kernel<NT, KC><<<A, NT, smem, stream>>>(a, ck);
  }
};
struct GlobalBuild {
  static constexpr auto kern = admm_global_kernel<kGlobalThreads>;
  static constexpr int threads = kGlobalThreads;
  static constexpr int blocks = 0;  // the carveout: all shared (its two blocks take 226 KB)
};
template <int W, int KC>
struct Triple {
  static constexpr auto kern = admm_triple_kernel<W, KC>;
  static constexpr int threads = 32 * W;
  static constexpr int blocks = W <= 9 ? 4 : 3;  // __launch_bounds__'s
  static void launch(const Args& a, int ck, int A, size_t smem, cudaStream_t stream) {
    admm_triple_kernel<W, KC><<<A, 32 * W, smem, stream>>>(a, ck);
  }
};

// The kernel's attributes for blocks of `smem` bytes. The carveout: all of
// the SM's shared memory for the one-block builds; for the triple build the
// shared memory of the blocks it holds an SM (B::blocks, each with 1 KB
// reserved) and the rest of the SM's 256 KB as L1, which holds the stencil
// tables and N3k all its blocks read (the parent's 3-D build, at 28 KB of
// L1, spent 13–22% of its time more than with 124 KB: PERF.md §6).
template <class B>
cudaError_t prepare_kernel(size_t smem) {
  const auto kern = B::kern;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int pct = (int)cudaSharedmemCarveoutMaxShared;
  if (B::blocks > 0 && err == cudaSuccess) {
    int dev = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    const size_t need = (size_t)B::blocks * (smem + 1024);
    pct = (int)((100 * need + per_sm - 1) / per_sm);
    pct = pct < 100 ? pct : 100;
  }
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, pct);
  return err;
}

template <class B>
int launch_all(const Args& a, int A, size_t smem, cudaStream_t stream) {
  cudaError_t err = prepare_kernel<B>(smem);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = admm_n_chunks(a.max_iter, a.chunk);
  for (int ck = 0; ck < n_chunks; ++ck) {
    B::launch(a, ck, A, smem, stream);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <class B>
int blocks_per_sm(size_t smem) {
  cudaError_t err = prepare_kernel<B>(smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, B::kern, B::threads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// The opt-in shared memory a block may take on the current device, bytes.
size_t smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 48 * 1024;
  return (size_t)bytes;
}

// The build that takes a shape (see "The layout"): its threads and Kinv
// columns in registers (0: the cluster build), and a block's shared memory
// (the register builds).
struct Build {
  int threads, columns;
  size_t smem;
};

Build build_for(const Dims& D) {
  if (D.dk < 1) return Build{0, 0, 0};
  if (D.dk <= kMaxRegDk) {
    Build b{128, 30, sizeof(float) * smem_floats(D, 128, false)};
    if (D.dk > 60) {
      const int W = D.dk <= kTripleDk ? 9 : 10;
      b = Build{32 * W, W == 9 ? 30 : 32, sizeof(float) * triple_smem_floats(D, W)};
    }
    if (b.smem <= smem_limit()) return b;
  }
  return Build{kClusterThreads, 0, sizeof(float) * smem_floats(D, 256, true)};
}

// The register builds' launch (the triple build's two widths, <288,30> and
// <320,32>, and <128,30>); -1 for any other build.
int launch_registers(const Build& b, const Args& a, int A, cudaStream_t st) {
  switch (b.threads) {
    case 128: return launch_all<OneBlock<128, 30>>(a, A, b.smem, st);
    case 288: return launch_all<Triple<9, 30 - kTripleShared>>(a, A, b.smem, st);
    case 320: return launch_all<Triple<10, 32 - kTripleShared>>(a, A, b.smem, st);
    default: return -1;
  }
}

// The global build's launches (see launch_all), or a refusal of a shape
// whose block passes the device's shared memory.
int launch_global(const Args& a, int A, cudaStream_t stream) {
  const Dims D = make_dims(a.dim, a.O, a.M, a.N, a.K, a.R_stat);
  const GPlan P = global_plan(D);
  const size_t smem = global_smem(D);
  if (!smem || smem > smem_limit()) return kPastSharedMemory;
  cudaError_t err = prepare_kernel<GlobalBuild>(smem);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = admm_n_chunks(a.max_iter, a.chunk);
  for (int ck = 0; ck < n_chunks; ++ck) {
    admm_global_kernel<kGlobalThreads><<<A, kGlobalThreads, smem, stream>>>(a, ck, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// A CTA's shared memory at cluster size C, or 0 for a C other than 2, 4, 8.
size_t cluster_smem(const Dims& D, int C, int n3k) {
  if (C != 2 && C != 4 && C != 8) return 0;
  return sizeof(float) * cluster_smem_floats(D, make_split(D, C, n3k));
}

// The cluster kernel's attributes for CTAs of `smem` bytes: 0, or a refusal
// (kBadClusterSize, kPastSharedMemory) or a CUDA error. The carveout asks
// for the shared memory of the CTAs an SM holds (two, the most its
// registers allow, or one) and leaves the rest of the SM's 256 KB to L1.
int cluster_prepare(size_t smem) {
  if (smem == 0) return kBadClusterSize;
  if (smem > smem_limit()) return kPastSharedMemory;
  const auto kern = admm_cluster_kernel<kClusterThreads>;
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    const size_t cta = smem + 1024, need = ((size_t)per_sm >= 2 * cta ? 2 : 1) * cta;
    const int pct = (int)((100 * need + per_sm - 1) / per_sm);
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               pct < 100 ? pct : 100);
  }
  return (int)err;
}

// A launch of A clusters of C CTAs; `attr` holds the cluster dimension.
cudaLaunchConfig_t cluster_config(int A, int C, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(A * C);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of C CTAs resident on the device at once
// (cudaOccupancyMaxActiveClusters), or a refusal or minus a CUDA error.
int active_clusters(const Dims& D, int A, int C, int n3k) {
  const size_t smem = cluster_smem(D, C, n3k);
  const int rc = cluster_prepare(smem);
  if (rc != 0) return rc < 0 ? rc : -rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(A, C, smem, 0, attr);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, admm_cluster_kernel<kClusterThreads>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

int launch_cluster(const Args& a, int C, int n3k, cudaStream_t stream, int* clusters) {
  const Dims D = make_dims(a.dim, a.O, a.M, a.N, a.K, a.R_stat);
  const int n = active_clusters(D, a.A, C, n3k);
  *clusters = n;
  if (n < 0) return n == kBadClusterSize || n == kPastSharedMemory ? n : -n;
  if (n == 0) return kNotResident;
  const size_t smem = cluster_smem(D, C, n3k);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(a.A, C, smem, stream, attr);
  const int n_chunks = admm_n_chunks(a.max_iter, a.chunk);
  for (int ck = 0; ck < n_chunks; ++ck) {
    cudaError_t err = cudaLaunchKernelEx(&cfg, admm_cluster_kernel<kClusterThreads>, a, ck, C, n3k);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Threads per block (per CTA) of the build that takes the shape (dim, O, M,
// N, K, R_stat) (see "The layout"), or 0 if dim·K < 1.
extern "C" int admm_threads(int dim, int O, int M, int N, int K, int R_stat) {
  return build_for(make_dims(dim, O, M, N, K, R_stat)).threads;
}

// Kinv columns per thread (registers) of that build; 0 past the register
// builds (the memory build or the cluster build, by the batch: admm_launch's C).
extern "C" int admm_columns(int dim, int O, int M, int N, int K, int R_stat) {
  return build_for(make_dims(dim, O, M, N, K, R_stat)).columns;
}

// The opt-in shared memory a block may take on the current device, bytes.
extern "C" long long admm_smem_limit() { return (long long)smem_limit(); }

// Dynamic shared memory of one block of the shape's build, bytes: past the
// register builds, the memory build's block (C = 1), the global build's (C
// = 0) or a CTA of the cluster build at cluster size C with N3k staged or not
// (n3k; both ignored by the register builds; 0 for a C other than 0, 1, 2,
// 4, 8).
extern "C" long long admm_smem_bytes(int dim, int O, int M, int N, int K, int R_stat, int C,
                                     int n3k) {
  const Dims D = make_dims(dim, O, M, N, K, R_stat);
  const Build b = build_for(D);
  if (!b.columns && C == 0) return (long long)global_smem(D);
  return (long long)(b.columns || C == 1 ? b.smem : cluster_smem(D, C, n3k));
}

// Resident blocks (agents of the register builds, of the memory build, C = 1,
// and of the global build, C = 0; CTAs of the cluster build at C, n3k) per SM, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative: a refusal or minus
// the CUDA error.
extern "C" int admm_blocks_per_sm(int dim, int O, int M, int N, int K, int R_stat, int C,
                                  int n3k) {
  const Dims D = make_dims(dim, O, M, N, K, R_stat);
  const Build b = build_for(D);
  if (b.columns) {
    switch (b.threads) {
      case 128: return blocks_per_sm<OneBlock<128, 30>>(b.smem);
      case 288: return blocks_per_sm<Triple<9, 30 - kTripleShared>>(b.smem);
      default: return blocks_per_sm<Triple<10, 32 - kTripleShared>>(b.smem);
    }
  }
  if (!b.threads) return -1;
  if (C == 1)
    return b.smem <= smem_limit() ? blocks_per_sm<OneBlock<256, 0>>(b.smem)
                                  : kPastSharedMemory;
  if (C == 0) {
    const size_t smem = global_smem(D);
    return smem && smem <= smem_limit() ? blocks_per_sm<GlobalBuild>(smem) : kPastSharedMemory;
  }
  const size_t smem = cluster_smem(D, C, n3k);
  const int rc = cluster_prepare(smem);
  if (rc != 0) return rc < 0 ? rc : -rc;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, admm_cluster_kernel<kClusterThreads>, kClusterThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// Clusters of C CTAs (one agent each) resident on the device at once for a
// batch of A agents of the shape (cudaOccupancyMaxActiveClusters); negative:
// a refusal or minus the CUDA error.
extern "C" int admm_active_clusters(int dim, int O, int M, int N, int K, int R_stat, int A,
                                    int C, int n3k) {
  return active_clusters(make_dims(dim, O, M, N, K, R_stat), A, C, n3k);
}

// Queues the whole loop on `stream`: one launch per chunk of `chunk`
// iterations, one block per agent (the register builds; past them the memory
// build, C = 1, or the global build, C = 0) or one cluster of C CTAs per agent
// with N3k staged or not (n3k; the cluster build, whose resident clusters go
// to *clusters). Returns 0, a CUDA error code, -1 for a dk < 1, or a refusal:
// -2 for a C other than 0, 1, 2, 4, 8, -3 for a block or CTA past the
// device's shared memory, -4 for clusters that cannot be resident. No
// synchronisation.
extern "C" int admm_launch(const float* normals, const float* Kinv, const float* Pn,
                           const float* qn, const float* ln, const float* un,
                           const float* scale, const float* xi0, const float* z0,
                           const float* y0, const int* st_idx, const float* st_coef,
                           const float* rho_stat, const int* adj_ptr, const int* adj_row,
                           const float* adj_coef, const int* grp_ptr, const float* N3k,
                           const float* N3kT, float* xi, float* z, float* y, float* ax,
                           float* best, int* noimp, int* itdone, int* done_count, int A, int dim,
                           int O, int M, int N, int K, int R_stat, int max_iter, int chunk, int C,
                           int n3k, float rho_lsc, float stop_tol, float sigma, float alpha,
                           float one_minus_alpha, float eps_abs, void* stream, int* clusters) {
  const Dims D = make_dims(dim, O, M, N, K, R_stat);
  const Build b = build_for(D);
  Args a{normals, Kinv,    Pn,       qn,      ln,       un,      scale,   xi0,
         z0,      y0,      st_idx,   st_coef, rho_stat, adj_ptr, adj_row, adj_coef,
         grp_ptr, N3k,     N3kT,     xi,      z,        y,       ax,      best,
         noimp,   itdone,  done_count, A,     dim,      O,       M,       N,
         K,       R_stat,  max_iter, chunk,   rho_lsc,  stop_tol, sigma,  alpha,
         one_minus_alpha, eps_abs};
  const cudaStream_t st = (cudaStream_t)stream;
  *clusters = 0;
  if (b.columns) return launch_registers(b, a, A, st);
  if (!b.threads) return -1;
  if (C == 1)
    return b.smem <= smem_limit() ? launch_all<OneBlock<256, 0>>(a, A, b.smem, st)
                                  : kPastSharedMemory;
  if (C == 0) return launch_global(a, A, st);
  return launch_cluster(a, C, n3k, st, clusters);
}
