// ADMM iteration loop of the batched trajectory QP, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel lsc_dr_planner_tpu/ops/qp_pallas.py::admm_loop_pallas
// (pl.pallas_call at :151, body _admm_block_kernel at :218-363). It computes
// what the plain loop lsc_dr_planner_tpu_torch/ops/qp.py::admm_loop_plain (the
// port of the XLA loop ops/qp.py::admm_loop) computes, with the same exit gates
// every 8 iterations: row-scaled feasibility, the relative dual residual (which
// the Pallas kernel dropped), iterate stall and objective patience, and the
// same global exit: the loop stops after the first test at which every agent
// is done. (A per-agent exit was measured on the H100 at A=1024: 0.7% of the
// agents then stopped up to 3% above the plain loop's objective and 0.18 m away
// in control points, outside the solver's comparison contract.)
//
// Layout: one launch per chunk of iterations, queued back to back with no
// host synchronisation; one thread block per agent, no padding of the fleet.
// During a chunk the agent's working set lives in dynamic shared memory: Kinv
// [dk, dk], the normals [O, M, dim], and z, y, A·xi, l, u, rho and the row
// cotangent over all R rows, plus a few dk-vectors (about 56 KB in the 2-D
// bench configuration: dim=2, K=28, dk=56, O=16, M=10, N=6, R=960+410).
// Between chunks xi, z, y, A·xi and the gate state go to global memory (about
// 70 MB of traffic per chunk at A=1024, some 25 µs). Each block counts itself
// into done_count[ck] when its agent passes the test. When that count is the
// whole fleet, every later launch returns at once and carries the count on to
// its own done_count entry, so the stop holds to the end of the queue and xi,
// z and y stay the iterate of the exit test. The shared operators An_stat
// [R_stat, dk] (92 KB) and N3k [K, M*N] are read from global memory by every
// block, so they stay in L2.
//
// What bounds it on the H100: one iteration of one agent is about 60 k fp32
// FMAs, most of them the two passes over An_stat (A·xi and Aᵀw for the static
// rows) and the LSC products. The 56 KB of shared memory and the register cap
// of __launch_bounds__(256, 4) let four agents share an SM; the serial dot
// products (56-long for the Kinv matvec, ~100-long partial sums over An_stat)
// set the latency of an iteration. Tensor cores, TMA and agent-batched GEMM
// tiles are not used.
//
// Built by ops/qp_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point admm_launch (ctypes).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // power of two: the block reductions halve it

struct Args {
  const float* normals;  // [A, O, M, dim]
  const float* Kinv;     // [A, dk, dk]
  const float* Pn;       // [A, K, K]
  const float* qn;       // [A, dk]
  const float* ln;       // [A, R]
  const float* un;       // [A, R]
  const float* rho;      // [A, R]
  const float* scale;    // [A, R]
  const float* xi0;      // [A, dk]
  const float* z0;       // [A, R]
  const float* y0;       // [A, R]
  const float* An;       // [R_stat, dk] shared static-row operator
  const float* N3k;      // [K, M*N] shared nullspace basis
  float* xi;            // [A, dk] state between launches, then the result
  float* z;             // [A, R]
  float* y;             // [A, R]
  float* ax;            // [A, R] A·xi of the iterate (scratch)
  float* best;          // [A] best feasible objective (scratch)
  int* noimp;           // [A] chunks without improvement (scratch)
  int* itdone;          // [A] iteration count at the first exit test passed
  int* done_count;      // [n_chunks] agents done at each test, zeroed
  int dim, O, M, N, K, R_stat, max_iter, chunk;  // chunk: iterations between tests
  float stop_tol, sigma, alpha, one_minus_alpha, eps_abs;
};

struct Dims {
  int dim, O, M, N, K, MN, dk, R_lsc, R_stat, R, P;
};

__host__ __device__ inline Dims make_dims(int dim, int O, int M, int N, int K,
                                          int R_stat, int threads) {
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
  D.P = threads / D.dk > 0 ? threads / D.dk : 1;  // partial sums per column
  return D;
}

__host__ __device__ inline size_t smem_floats(const Dims& D, int threads) {
  return (size_t)D.dk * D.dk + (size_t)D.O * D.M * D.dim + 7 * (size_t)D.R +
         5 * (size_t)D.dk + (size_t)D.dim * D.MN + (size_t)D.P * D.dk + threads;
}

__host__ __device__ inline int admm_n_chunks(int max_iter, int chunk) {
  const int n = (max_iter + chunk - 1) / chunk;
  return n > 1 ? n : 1;
}

__device__ float block_max(float v, float* red) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) red[t] = fmaxf(red[t], red[t + s]);
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float* red) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// out[dk] = Aᵀw for the row cotangent w[R]: the LSC rows through the per-dim
// normals and N3k, the static rows through An (column sums split into P
// partial sums). VU [dim*MN] and G [P*dk] are scratch.
__device__ void adjoint(const Dims& D, const float* w, const float* NRM,
                        const float* __restrict__ N3k, const float* __restrict__ An,
                        float* VU, float* G, float* out) {
  const int t = threadIdx.x, nt = blockDim.x;
  for (int i = t; i < D.dim * D.MN; i += nt) {
    const int d = i / D.MN, mn = i % D.MN, m = mn / D.N;
    float acc = 0.f;
    for (int o = 0; o < D.O; ++o)
      acc += NRM[(o * D.M + m) * D.dim + d] * w[o * D.MN + mn];
    VU[i] = acc;
  }
  for (int i = t; i < D.P * D.dk; i += nt) {
    const int p = i / D.dk, j = i % D.dk;
    float acc = 0.f;
    for (int r = p; r < D.R_stat; r += D.P) acc += w[D.R_lsc + r] * An[r * D.dk + j];
    G[i] = acc;
  }
  __syncthreads();
  for (int j = t; j < D.dk; j += nt) {
    const int d = j / D.K, k = j % D.K;
    float acc = 0.f;
    for (int mn = 0; mn < D.MN; ++mn) acc += N3k[k * D.MN + mn] * VU[d * D.MN + mn];
    for (int p = 0; p < D.P; ++p) acc += G[p * D.dk + j];
    out[j] = acc;
  }
  __syncthreads();
}

// VU[d*MN + mn] = Σ_k x[d*K + k]·N3k[k, mn]: the control points of x per dim.
__device__ void control_points(const Dims& D, const float* x,
                               const float* __restrict__ N3k, float* VU) {
  for (int i = threadIdx.x; i < D.dim * D.MN; i += blockDim.x) {
    const int d = i / D.MN, mn = i % D.MN;
    float acc = 0.f;
    for (int k = 0; k < D.K; ++k) acc += x[d * D.K + k] * N3k[k * D.MN + mn];
    VU[i] = acc;
  }
}

// Row r of A·x, given VU = control_points(x).
__device__ float row_value(const Dims& D, int r, const float* NRM, const float* VU,
                           const float* __restrict__ An, const float* x) {
  float acc = 0.f;
  if (r < D.R_lsc) {
    const int o = r / D.MN, mn = r % D.MN, m = mn / D.N;
    for (int d = 0; d < D.dim; ++d)
      acc += NRM[(o * D.M + m) * D.dim + d] * VU[d * D.MN + mn];
  } else {
    const float* arow = An + (size_t)(r - D.R_lsc) * D.dk;
    for (int j = 0; j < D.dk; ++j) acc += arow[j] * x[j];
  }
  return acc;
}

// One chunk (a.chunk iterations and the exit tests) of every agent's loop.
// Launch ck starts from the inputs (ck = 0) or from the state the previous
// launch stored. When every agent was done at the previous test (the plain
// loop's global exit) it returns at once and marks its own test done for the
// whole fleet too, so that no later launch resumes the loop.
__global__ void __launch_bounds__(kThreads, 4) admm_chunk_kernel(Args a, int ck) {
  if (ck > 0 && a.done_count[ck - 1] == (int)gridDim.x) {
    if (threadIdx.x == 0 && blockIdx.x == 0) a.done_count[ck] = gridDim.x;
    return;
  }
  extern __shared__ float smem[];
  const Dims D = make_dims(a.dim, a.O, a.M, a.N, a.K, a.R_stat, blockDim.x);
  const int t = threadIdx.x, nt = blockDim.x;
  const size_t agent = blockIdx.x;

  float* KINV = smem;
  float* NRM = KINV + D.dk * D.dk;
  float* Z = NRM + D.O * D.M * D.dim;
  float* Y = Z + D.R;
  float* AX = Y + D.R;
  float* LN = AX + D.R;
  float* UN = LN + D.R;
  float* RHO = UN + D.R;
  float* W = RHO + D.R;
  float* XI = W + D.R;
  float* XIP = XI + D.dk;
  float* RHS = XIP + D.dk;
  float* XT = RHS + D.dk;
  float* QN = XT + D.dk;
  float* VU = QN + D.dk;
  float* G = VU + D.dim * D.MN;
  float* RED = G + D.P * D.dk;

  const float* kinv_g = a.Kinv + agent * D.dk * D.dk;
  const float* nrm_g = a.normals + agent * D.O * D.M * D.dim;
  const float* pn_g = a.Pn + agent * D.K * D.K;
  const float* scale_g = a.scale + agent * D.R;
  const float* xi_in = ck == 0 ? a.xi0 : a.xi;
  const float* z_in = ck == 0 ? a.z0 : a.z;
  const float* y_in = ck == 0 ? a.y0 : a.y;
  for (int i = t; i < D.dk * D.dk; i += nt) KINV[i] = kinv_g[i];
  for (int i = t; i < D.O * D.M * D.dim; i += nt) NRM[i] = nrm_g[i];
  for (int r = t; r < D.R; r += nt) {
    const size_t g = agent * D.R + r;
    Z[r] = z_in[g];
    Y[r] = y_in[g];
    LN[r] = a.ln[g];
    UN[r] = a.un[g];
    RHO[r] = a.rho[g];
    if (ck > 0) AX[r] = a.ax[g];
  }
  for (int j = t; j < D.dk; j += nt) {
    XI[j] = xi_in[agent * D.dk + j];
    XIP[j] = XI[j];
    QN[j] = a.qn[agent * D.dk + j];
  }
  __syncthreads();
  if (ck == 0) {  // A·xi of the warm start
    control_points(D, XI, a.N3k, VU);
    __syncthreads();
    for (int r = t; r < D.R; r += nt) AX[r] = row_value(D, r, NRM, VU, a.An, XI);
    __syncthreads();
  }

  const float alpha = a.alpha, beta = a.one_minus_alpha;
  for (int s = 0; s < a.chunk; ++s) {
    // rhs = σξ − q + Aᵀ(ρz − y)
    for (int r = t; r < D.R; r += nt) W[r] = RHO[r] * Z[r] - Y[r];
    __syncthreads();
    adjoint(D, W, NRM, a.N3k, a.An, VU, G, RHS);
    for (int j = t; j < D.dk; j += nt) RHS[j] = (a.sigma * XI[j] - QN[j]) + RHS[j];
    __syncthreads();
    // ξ̃ = Kinv·rhs
    for (int i = t; i < D.dk; i += nt) {
      float acc = 0.f;
      for (int j = 0; j < D.dk; ++j) acc += KINV[i * D.dk + j] * RHS[j];
      XT[i] = acc;
    }
    __syncthreads();
    control_points(D, XT, a.N3k, VU);
    for (int j = t; j < D.dk; j += nt) XI[j] = alpha * XT[j] + beta * XI[j];
    __syncthreads();
    // z̃ = A·ξ̃, over-relaxation, projection onto [l, u], dual update
    for (int r = t; r < D.R; r += nt) {
      const float zt = row_value(D, r, NRM, VU, a.An, XT);
      const float zmix = alpha * zt + beta * Z[r];
      const float zn = fminf(fmaxf(zmix + Y[r] / RHO[r], LN[r]), UN[r]);
      Y[r] = Y[r] + RHO[r] * (zmix - zn);
      Z[r] = zn;
      AX[r] = alpha * zt + beta * AX[r];
    }
    __syncthreads();
  }

  // ---- exit tests on the actual iterate ----
  float v = 0.f;
  for (int r = t; r < D.R; r += nt) {
    const float ax = AX[r];
    const float vr = fmaxf(fmaxf(LN[r] - ax, ax - UN[r]), 0.f);
    v = fmaxf(v, vr / scale_g[r]);
  }
  const bool feas = block_max(v, RED) < a.stop_tol;

  adjoint(D, Y, NRM, a.N3k, a.An, VU, G, RHS);  // Aᵀy
  for (int j = t; j < D.dk; j += nt) {           // P·ξ
    const int d = j / D.K, k = j % D.K;
    float acc = 0.f;
    for (int l = 0; l < D.K; ++l) acc += pn_g[k * D.K + l] * XI[d * D.K + l];
    XT[j] = acc;
  }
  __syncthreads();
  float rd = 0.f, pxm = 0.f, atym = 0.f, qnm = 0.f, dxi = 0.f, xim = 0.f, obj = 0.f;
  for (int j = t; j < D.dk; j += nt) {
    const float px = XT[j], aty = RHS[j], q = QN[j], x = XI[j];
    rd = fmaxf(rd, fabsf(px + q + aty));
    pxm = fmaxf(pxm, fabsf(px));
    atym = fmaxf(atym, fabsf(aty));
    qnm = fmaxf(qnm, fabsf(q));
    dxi = fmaxf(dxi, fabsf(x - XIP[j]));
    xim = fmaxf(xim, fabsf(x));
    obj += (0.5f * px + q) * x;
  }
  rd = block_max(rd, RED);
  pxm = block_max(pxm, RED);
  atym = block_max(atym, RED);
  qnm = block_max(qnm, RED);
  dxi = block_max(dxi, RED);
  xim = block_max(xim, RED);
  obj = block_sum(obj, RED);

  float best = ck == 0 ? INFINITY : a.best[agent];
  int noimp = ck == 0 ? 0 : a.noimp[agent];
  int itdone = ck == 0 ? a.max_iter : a.itdone[agent];
  const float dmag = fmaxf(pxm, fmaxf(atym, qnm));
  const bool opt = rd < a.eps_abs + 1e-3f * dmag;
  const bool stalled = dxi < 1e-4f * fmaxf(1.f, xim);
  const bool improved = obj < best - 2e-4f * fmaxf(1.f, fabsf(obj));
  if (feas && improved) best = obj;
  noimp = (feas && !improved) ? noimp + 1 : 0;
  const bool done = feas && (opt || stalled || noimp >= 2);
  if (done && itdone == a.max_iter) itdone = (ck + 1) * a.chunk;

  for (int j = t; j < D.dk; j += nt) a.xi[agent * D.dk + j] = XI[j];
  for (int r = t; r < D.R; r += nt) {
    const size_t g = agent * D.R + r;
    a.z[g] = Z[r];
    a.y[g] = Y[r];
    a.ax[g] = AX[r];
  }
  if (t == 0) {
    a.best[agent] = best;
    a.noimp[agent] = noimp;
    a.itdone[agent] = itdone;
    if (done) atomicAdd(a.done_count + ck, 1);
  }
}

}  // namespace

// Queues the whole loop on `stream`: one launch per chunk of `chunk` iterations,
// one block per agent.
// Returns the CUDA error code (0 on success). No synchronisation.
extern "C" int admm_launch(const float* normals, const float* Kinv, const float* Pn,
                           const float* qn, const float* ln, const float* un,
                           const float* rho, const float* scale, const float* xi0,
                           const float* z0, const float* y0, const float* An,
                           const float* N3k, float* xi, float* z, float* y, float* ax,
                           float* best, int* noimp, int* itdone, int* done_count, int A,
                           int dim, int O, int M, int N, int K, int R_stat, int max_iter,
                           int chunk, float stop_tol, float sigma, float alpha,
                           float one_minus_alpha, float eps_abs, void* stream) {
  Args a{normals, Kinv, Pn,   qn,     ln,   un,    rho,    scale,      xi0,
         z0,      y0,   An,   N3k,    xi,   z,     y,      ax,         best,
         noimp,   itdone, done_count, dim, O, M, N, K, R_stat, max_iter,
         chunk,   stop_tol, sigma, alpha, one_minus_alpha, eps_abs};
  const Dims D = make_dims(dim, O, M, N, K, R_stat, kThreads);
  const size_t smem = sizeof(float) * smem_floats(D, kThreads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        admm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_chunks = admm_n_chunks(max_iter, chunk);
  for (int ck = 0; ck < n_chunks; ++ck) {
    admm_chunk_kernel<<<A, kThreads, smem, (cudaStream_t)stream>>>(a, ck);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Dynamic shared memory one block needs, in bytes (for reports and checks).
extern "C" long long admm_smem_bytes(int dim, int O, int M, int N, int K, int R_stat) {
  const Dims D = make_dims(dim, O, M, N, K, R_stat, kThreads);
  return (long long)(sizeof(float) * smem_floats(D, kThreads));
}
