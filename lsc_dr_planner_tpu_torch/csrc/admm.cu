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
// Each block counts itself into done_count[ck] when its agent passes the test;
// when that count is the whole fleet, every later launch returns at once and
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
// The layout. One agent per block, so that the small batches of the simulator
// and the rescue (10–64 agents) run each iteration at one agent's latency, and
// the A=1024 bench batch runs in one wave when 8 blocks fit on an SM. Three
// builds, chosen from the shape (admm_threads, admm_columns), never from a
// failure:
//   <128, 30>  dim·K ≤ 60: 2-D, 56 for LSC (K = 28, the terminal derivatives
//              pinned) and 60 for DLSC, BVC and RSFC (K = 30); Kinv in
//              registers, thread 2i+h holding half h of row i; the Kinv loop
//              stops at the row's own columns, so dim·K 56 runs the additions
//              of a 28-column build in the same order;
//   <256, 48>  dim·K ≤ 96: 3-D (84 for LSC, 90 for the other modes), 256
//              threads with up to 48 Kinv registers each; __launch_bounds__
//              asks for three blocks per SM, which caps a thread at 85
//              registers (the 128-thread build asks for eight: 64);
//   <256, 0>   any other shape (3-D from M = 11 on: dim·K 102 at M = 12,
//              246 at M = 28; or rows past shared memory), the memory build:
//              Kinv is read where it lies, from shared memory where it fits
//              beside the rows (41.6 KB at dim·K 102), else through L1 and
//              L2; a thread pair takes rows i, i + 128, ... of each product.
//              The rows' state goes in shared memory where it fits (the
//              limit the device reports, 227 KB on the H100), else it stays
//              in global memory, updated in place in the loop's own z, y and
//              A·xi buffers (l, u and the normals read where they lie). Two
//              blocks per SM at most (128 registers). At dim·K 102 and 6,534
//              rows (A=1024, 200 iterations; 166 KB a block, one block an
//              SM) the shared copy of Kinv takes 45.0–45.1 ms on the H100
//              against 48.0–48.1 ms for Kinv through L1 and L2 (PERF.md §6,
//              the memory build's row and its placement A/B).
// The first two need their rows in shared memory; a shape whose rows do not
// fit there goes to the memory build. Per agent, shared memory holds z, y,
// A·xi and l over all R rows, u over the static rows only (the LSC rows are
// one-sided: prepare() makes their u +1e20 less an offset, which no iterate
// reaches, so the kernel takes it as +inf), the normals and a few dk- and
// dim·MN-vectors: 27.8 KB in the 2-D bench shape (dim=2, K=28, dk=56, O=16,
// M=10, N=6, R=960+410), 34.0 KB in 3-D (dk=90, R=960+615). ρ is one
// constant for the LSC rows and a shared row vector for the static rows (the
// per-family ρ of _solver_statics, as the Pallas kernel takes it); `scale` is
// read at the exit tests only. The shared operators (N3k and its transpose,
// the stencil tables: 18 KB in 2-D) are read through L1 by every block;
// copying them into each block's shared memory would cost the residency they
// buy. The 3-D z stencils are rows of the same tables.
//
// Every phase spreads over the block: the Kinv matvec and the N3k adjoint
// product run two threads per output, combined with one warp shuffle; the
// control points and the adjoint accumulator one thread per (d, mn); rows one
// thread each; the exit test's eight reductions are one warp-shuffle pass and
// one shared step. No float atomics: an agent's result does not depend on
// which agents share the launch (the rescue compacts different agents each
// step).
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
// What bounds it on the H100: the float32 FMA pipes and the latency of five
// barriers per iteration; the bound of the work itself (about 54 k flops per
// agent-iteration, 67 TFLOP/s) is some 0.16 ms for 200 iterations at A=1024.
// No tensor cores: the loop must stay float32 (TF32 breaks the ADMM algebra as
// bf16 did on the TPU, and the exit gates are already noisier than their
// thresholds in float32), its products are per-agent matvecs, and the FMA
// bound is far below the kernel's time. A 3xTF32 or agent-batched mma.sync
// path, and a persistent kernel that keeps the state in shared memory across
// chunks, are later work (ROADMAP Queue 2).
//
// Built by ops/qp_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point admm_launch (ctypes).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWidth = 3;  // stencil nonzeros per static row (qp.STENCIL_WIDTH)
constexpr int kMaxRegDk = 96;  // the largest dim·K of the register builds
constexpr unsigned kFull = 0xffffffffu;

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
  int dim, O, M, N, K, R_stat, max_iter, chunk;  // chunk: iterations between tests
  int rows_smem, kinv_smem;  // the memory build's placement (see Place)
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

// Where the memory build keeps an agent's rows and its Kinv: in shared memory
// (1) or global memory (0). The register builds keep the rows in shared memory.
struct Place {
  int rows_smem, kinv_smem;
};

// VD [dim*MN doubles]; XTD [dk doubles]; with the rows in shared memory Z, Y,
// AX, LN [R], UN [R_stat], NRM [O*M*dim]; XI, XIP, QN [dk]; VA [dim*MN]; RED
// [8 per warp]; MOF [MN] (int); KI [dk*dk] where Kinv is in shared memory.
__host__ __device__ inline size_t smem_floats(const Dims& D, int threads, Place P) {
  const size_t rows = P.rows_smem ? 4 * (size_t)D.R + D.R_stat + (size_t)D.O * D.M * D.dim : 0;
  return rows + 5 * (size_t)D.dk + 3 * (size_t)D.dim * D.MN + 8 * (threads / 32) + D.MN +
         (P.kinv_smem ? (size_t)D.dk * D.dk : 0);
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

// f(r, o, mn) for this thread's LSC rows r = o*MN + mn (no division per row).
template <int NT, class F>
__device__ __forceinline__ void for_lsc_rows(const Dims& D, F f) {
  int o = threadIdx.x / D.MN, mn = threadIdx.x % D.MN;
  const int step_o = NT / D.MN, step_mn = NT % D.MN;
  for (int r = threadIdx.x; r < D.R_lsc; r += NT) {
    f(r, o, mn);
    o += step_o;
    mn += step_mn;
    if (mn >= D.MN) {
      mn -= D.MN;
      ++o;
    }
  }
}

// Row value of LSC row (o, mn) and of static row s from the control points
// VD, each taken in double and rounded once.
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
// control-point accumulator VA [dim*MN]; one N3k product then gives ξ-space
// (adjoint_row). Ends with a barrier.
template <int NT, bool DUAL>
__device__ __forceinline__ void adjoint_points(const Dims& D, const Args& a, const float* Z,
                                               const float* Y, const float* NRM, const int* MOF,
                                               float* VA) {
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
    VA[i] = (float)acc;
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
// combined in a fixed order (deterministic).
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

// One chunk (a.chunk iterations and the exit tests) of every agent's loop,
// one agent per block of NT threads. KC > 0: KC >= ceil(dk / 2) Kinv columns
// per thread in registers (dk <= NT/2), the rows in shared memory; KC = 0:
// the memory build (Kinv and the rows where a.kinv_smem and a.rows_smem put
// them, any dk). Launch ck starts from the inputs (ck = 0) or from the state
// the previous launch stored. When every agent was done at the previous test
// (the plain loop's global exit) it returns at once and marks its own test
// done for the whole fleet too, so that no later launch resumes the loop.
template <int NT, int KC>
__global__ void __launch_bounds__(NT, NT == 128 ? 8 : KC ? 3 : 2)
admm_chunk_kernel(Args a, int ck) {
  if (ck > 0 && a.done_count[ck - 1] == (int)gridDim.x) {
    if (threadIdx.x == 0 && blockIdx.x == 0) a.done_count[ck] = gridDim.x;
    return;
  }
  extern __shared__ __align__(16) float smem[];
  const Dims D = make_dims(a.dim, a.O, a.M, a.N, a.K, a.R_stat);
  const int t = threadIdx.x;
  const size_t agent = blockIdx.x;
  // the rows' state in shared memory (always in the register builds)
  const bool rows_smem = KC > 0 || a.rows_smem;

  // The doubles first. From the adjoint to the Kinv product VD is free and
  // holds rhs (dk ≤ dim·MN: K ≤ MN, N3k being a basis of a subspace of the MN
  // control points); after the loop XTD holds the exit tests' Aᵀy and P·ξ.
  double* VD = reinterpret_cast<double*>(smem);
  double* RHSD = VD;
  double* XTD = VD + D.dim * D.MN;
  float* RHS = reinterpret_cast<float*>(XTD);
  float* XT = RHS + D.dk;
  float* next = XT + D.dk;
  float *Z, *Y, *AX, *LN, *UN, *NRM;  // UN: the static rows only
  if (rows_smem) {
    Z = next;
    Y = Z + D.R;
    AX = Y + D.R;
    LN = AX + D.R;
    UN = LN + D.R;
    NRM = UN + D.R_stat;
    next = NRM + D.O * D.M * D.dim;
  } else {  // in place in global memory
    Z = a.z + agent * D.R;
    Y = a.y + agent * D.R;
    AX = a.ax + agent * D.R;
    LN = const_cast<float*>(a.ln) + agent * D.R;
    UN = const_cast<float*>(a.un) + agent * D.R + D.R_lsc;
    NRM = const_cast<float*>(a.normals) + agent * D.O * D.M * D.dim;
  }
  float* XI = next;
  float* XIP = XI + D.dk;
  float* QN = XIP + D.dk;
  float* VA = QN + D.dk;
  float* RED = VA + D.dim * D.MN;
  int* MOF = reinterpret_cast<int*>(RED + 8 * (NT / 32));
  float* KI = reinterpret_cast<float*>(MOF + D.MN);  // the memory build's Kinv in shared memory

  const float* xi_in = ck == 0 ? a.xi0 : a.xi;
  const float* z_in = ck == 0 ? a.z0 : a.z;
  const float* y_in = ck == 0 ? a.y0 : a.y;
  if (rows_smem) {
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
  } else if (ck == 0) {
    for (int r = t; r < D.R; r += NT) {
      const size_t g = agent * D.R + r;
      Z[r] = z_in[g];
      Y[r] = y_in[g];
    }
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
    if (a.kinv_smem) {
      for (int i = t; i < D.dk * D.dk; i += NT) KI[i] = kinv_g[i];
    } else {
      KI = const_cast<float*>(kinv_g);
    }
  }
  const int row_sets = KC > 0 ? 1 : (D.dk + NT / 2 - 1) / (NT / 2);  // rows a thread pair takes
  __syncthreads();
  if (ck == 0) {  // A·xi of the warm start
    control_points<NT>(D, XI, a.N3k, VD);
    __syncthreads();
    for_lsc_rows<NT>(D, [&](int r, int o, int mn) { AX[r] = lsc_row(D, NRM, MOF, VD, o, mn); });
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
          if (a.kinv_smem) {
            for (int c = 0; c < ncols; ++c) acc = fma((double)kr[c], RHSD[c0 + c], acc);
          } else {
            for (int c = 0; c < ncols; ++c) acc = fma((double)__ldg(kr + c), RHSD[c0 + c], acc);
          }
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
    for_lsc_rows<NT>(D, [&](int r, int o, int mn) {
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
  const float* pn_g = a.Pn + agent * D.K * D.K;
  for (int j = t; j < D.dk; j += NT) {  // P·ξ
    const int d = j / D.K, k = j - d * D.K;
    float acc = 0.f;
    for (int l = 0; l < D.K; ++l) acc += pn_g[k * D.K + l] * XI[d * D.K + l];
    XT[j] = acc;
  }
  __syncthreads();
  for (int j = t; j < D.dk; j += NT) {
    const float px = XT[j], aty = RHS[j], q = QN[j], x = XI[j];
    v[1] = fmaxf(v[1], fabsf(px + q + aty));  // dual residual
    v[2] = fmaxf(v[2], fabsf(px));
    v[3] = fmaxf(v[3], fabsf(aty));
    v[4] = fmaxf(v[4], fabsf(q));
    v[5] = fmaxf(v[5], fabsf(x - XIP[j]));  // iterate change over the chunk
    v[6] = fmaxf(v[6], fabsf(x));
    v[7] += (0.5f * px + q) * x;  // objective
  }
  block_reduce8<NT>(v, RED);
  const bool feas = v[0] < a.stop_tol;
  const float rd = v[1], dmag = fmaxf(v[2], fmaxf(v[3], v[4]));
  const float dxi = v[5], xim = v[6], obj = v[7];

  for (int j = t; j < D.dk; j += NT) a.xi[agent * D.dk + j] = XI[j];
  if (rows_smem) {
    for (int r = t; r < D.R; r += NT) {
      const size_t g = agent * D.R + r;
      a.z[g] = Z[r];
      a.y[g] = Y[r];
      a.ax[g] = AX[r];
    }
  }
  if (t == 0) {
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
}

template <int NT, int KC>
cudaError_t prepare_kernel(size_t smem) {
  const auto kern = admm_chunk_kernel<NT, KC>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int NT, int KC>
int launch_all(const Args& a, int A, size_t smem, cudaStream_t stream) {
  cudaError_t err = prepare_kernel<NT, KC>(smem);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = admm_n_chunks(a.max_iter, a.chunk);
  for (int ck = 0; ck < n_chunks; ++ck) {
    admm_chunk_kernel<NT, KC><<<A, NT, smem, stream>>>(a, ck);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int NT, int KC>
int blocks_per_sm(size_t smem) {
  cudaError_t err = prepare_kernel<NT, KC>(smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, admm_chunk_kernel<NT, KC>, NT, smem);
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

// The build that takes a shape (see "The layout"): its threads, Kinv columns
// in registers (0: the memory build) and placement, and its shared memory.
struct Build {
  int threads, columns;
  Place place;
  size_t smem;
};

Build build_for(const Dims& D) {
  if (D.dk < 1) return Build{0, 0, {0, 0}, 0};
  const size_t limit = smem_limit();
  const Place rows{1, 0};
  if (D.dk <= kMaxRegDk) {
    const int threads = D.dk <= 60 ? 128 : 256;
    const size_t smem = sizeof(float) * smem_floats(D, threads, rows);
    if (smem <= limit) return Build{threads, D.dk <= 60 ? 30 : 48, rows, smem};
  }
  for (const Place p : {Place{1, 1}, rows, Place{0, 1}, Place{0, 0}}) {
    const size_t smem = sizeof(float) * smem_floats(D, 256, p);
    if (smem <= limit) return Build{256, 0, p, smem};
  }
  return Build{256, 0, {0, 0}, sizeof(float) * smem_floats(D, 256, Place{0, 0})};
}

}  // namespace

// Threads per block of the build that takes the shape (dim, O, M, N, K,
// R_stat) (see "The layout"), or 0 if dim·K < 1.
extern "C" int admm_threads(int dim, int O, int M, int N, int K, int R_stat) {
  return build_for(make_dims(dim, O, M, N, K, R_stat)).threads;
}

// Kinv columns per thread (registers) of that build; 0 for the memory build.
extern "C" int admm_columns(int dim, int O, int M, int N, int K, int R_stat) {
  return build_for(make_dims(dim, O, M, N, K, R_stat)).columns;
}

// The memory build's placement for the shape: 1 for the rows in shared
// memory, plus 2 for Kinv in shared memory (the register builds: 1).
extern "C" int admm_placement(int dim, int O, int M, int N, int K, int R_stat) {
  const Place p = build_for(make_dims(dim, O, M, N, K, R_stat)).place;
  return p.rows_smem + 2 * p.kinv_smem;
}

// Queues the whole loop on `stream`: one launch per chunk of `chunk` iterations,
// one block per agent.
// Returns the CUDA error code (0 on success, -1 for a dk < 1). No
// synchronisation.
extern "C" int admm_launch(const float* normals, const float* Kinv, const float* Pn,
                           const float* qn, const float* ln, const float* un,
                           const float* scale, const float* xi0, const float* z0,
                           const float* y0, const int* st_idx, const float* st_coef,
                           const float* rho_stat, const int* adj_ptr, const int* adj_row,
                           const float* adj_coef, const float* N3k, const float* N3kT,
                           float* xi, float* z, float* y, float* ax, float* best, int* noimp,
                           int* itdone, int* done_count, int A, int dim, int O, int M, int N,
                           int K, int R_stat, int max_iter, int chunk, float rho_lsc,
                           float stop_tol, float sigma, float alpha, float one_minus_alpha,
                           float eps_abs, void* stream) {
  const Dims D = make_dims(dim, O, M, N, K, R_stat);
  const Build b = build_for(D);
  Args a{normals, Kinv,    Pn,       qn,      ln,      un,   scale,      xi0,
         z0,      y0,      st_idx,   st_coef, rho_stat, adj_ptr, adj_row, adj_coef,
         N3k,     N3kT,    xi,       z,       y,       ax,   best,       noimp,
         itdone,  done_count, dim,   O,       M,       N,    K,          R_stat,
         max_iter, chunk, b.place.rows_smem, b.place.kinv_smem,
         rho_lsc,  stop_tol, sigma,  alpha, one_minus_alpha, eps_abs};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (b.columns) {
    case 30: return launch_all<128, 30>(a, A, b.smem, st);
    case 48: return launch_all<256, 48>(a, A, b.smem, st);
    default: return b.threads ? launch_all<256, 0>(a, A, b.smem, st) : -1;
  }
}

// Dynamic shared memory one block needs, in bytes (for reports and checks).
extern "C" long long admm_smem_bytes(int dim, int O, int M, int N, int K, int R_stat) {
  return (long long)build_for(make_dims(dim, O, M, N, K, R_stat)).smem;
}

// Resident blocks (agents) per SM for this shape, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative: minus the CUDA error.
extern "C" int admm_blocks_per_sm(int dim, int O, int M, int N, int K, int R_stat) {
  const Build b = build_for(make_dims(dim, O, M, N, K, R_stat));
  switch (b.columns) {
    case 30: return blocks_per_sm<128, 30>(b.smem);
    case 48: return blocks_per_sm<256, 48>(b.smem);
    default: return b.threads ? blocks_per_sm<256, 0>(b.smem) : -1;
  }
}
