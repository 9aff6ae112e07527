// Preparation of the batched trajectory QP, for NVIDIA Hopper (sm_90a).
//
// Replaces the pre-loop body of lsc_dr_planner_tpu/ops/qp.py::solve (:498-571),
// which XLA ran fused on the TPU (jnp, with jnp.linalg.cholesky at :540 and
// cho_solve on the identity; no Pallas original). It computes what the torch
// body lsc_dr_planner_tpu_torch/ops/qp.py::_prepare_plain computes, for one
// agent per block, in one launch for the fleet:
//   - the pins and their particular solution xpart = X_pin·pins;
//   - every inequality row in constraint_bounds's flat order (the LSC rows,
//     the velocity and acceleration caps, the comm pairs, the variable
//     bounds): l, u, ρ, scale, the pin offset b_off and ln, un;
//   - the reduced cost: tvec, qflat, qn and Pn_dim;
//   - the KKT matrix ρ_lsc·Σ_m S_m⊗T_lsc[m] + I_dim⊗(Pn_dim + G_stat + σI), its
//     inverse Kinv, and a per-agent `info` (0, or the order of the first
//     non-positive pivot, whose agent gets a NaN Kinv, as jnp.linalg.cholesky
//     gives NaN: nothing raises, nothing is read by the host);
//   - the warm start xi0 = N_nullᵀ(x0 − xpart), z0 = A·xi0 and y.
//
// Rounding. Everything but the inverse is float32, as in the plain body and
// the JAX package, and in their order. The elementwise outputs (l, u, ρ,
// scale, tvec, qflat) repeat the plain body's operations one for one (the
// plain body multiplies by its scalars once, qp.py::prepare_scalars). Each
// sum repeats the order in which the plain body's einsums sum on the CPU
// (measured there; the JAX package's alike, which the CPU tests hold the
// plain body to): a chain of fused multiply-adds from 0 in the index's order,
// or, for the contractions over a point's dimensions and over the neighbour
// slots (the LSC rows' offsets, the LSC Gram), a product, then an addition, a
// term (the _rn intrinsics keep nvcc from fusing or reordering them). On the
// card the plain body's einsums are cuBLAS's fused chains throughout, so the
// two agree bit for bit but for an ulp in those two. The order matters for
// qn = N_nullᵀ(q + P_base·xpart), a small difference of terms up to ~1e2
// times its size: its float32 rounding is as large as qn for agents far from
// the origin, and the ADMM solutions move with it (by 0.15 m at A = 1024
// between two orders; BVC's converged share by some 5 points with an exact
// qn). The KKT matrix is assembled in float32, then factored, inverted and
// multiplied out in double in shared memory, and Kinv is rounded once: its
// condition number is about 1.6e5, so a float32 factor leaves Kinv up to
// ~1e-3 from the inverse (the plain body's torch.cholesky_solve does; a
// float32 version of this kernel's was 3.5 times as far on some agents), and
// the ADMM solutions barely depend on that (~1e-6 m at A = 256).
//
// The inverse. K = L D Lᵀ (L unit lower triangular), right-looking, one
// barrier a column; then X = L⁻¹, right-looking, one barrier a column, into
// the upper triangle; then Kinv = Xᵀ D⁻¹ X, each entry a dot product over
// k ≥ max(i, j) in the same order for (i, j) and (j, i), so Kinv is
// symmetric. The matrix lives in shared memory as double [dk][dk | 1] (the odd
// row pitch keeps a half-warp's column reads on distinct banks): 25.5 KB in
// the main path's 2-D shape (dk = 56), 74.5 KB at the largest dk, 96, which
// needs the dynamic shared memory opt-in above 48 KB. The updates and the
// product spread over the block as a grid of 16 x 16 threads.
//
// What bounds it on the H100: bytes. Each agent reads about 13 KB (its
// inputs; the statics, 30–60 KB, are shared by the fleet through L1 and L2)
// and writes about 67 KB (Kinv and nine R-vectors) in the main path's shape,
// some 82 MB at A = 1024: 0.025 ms at 3.35 TB/s. The operations (dk³ for the
// factor, the inverse and the product, done in double) are some 0.2 GFLOP at
// A = 1024. The 2·dk barriers of the factor and the inverse set a block's
// latency; 7 blocks fit on an SM in 2-D (shared memory), 3 at dk = 96.
//
// Built by ops/qp_prepare_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point qp_prepare_launch (ctypes).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;  // the block as a grid of kRows x kSide threads
constexpr int kRows = kThreads / kSide;
constexpr int kMaxDk = 96;  // the largest dim·K taken (the ADMM kernel's)
constexpr int kWidth = 3;   // stencil nonzeros per static row (qp.STENCIL_WIDTH)
constexpr int kPhi = 3;     // pinned control points (c0, c1, c2)
constexpr float kInf = 1e20f;

// An input tensor: its data and the element strides of its (up to) four
// dimensions, the agent's first; unused dimensions have stride 0.
struct Tin {
  const void* p;
  long long s[4];
};

// Everything one launch takes; mirrored by ops/qp_prepare_cuda.py::_Args.
struct PrepArgs {
  // per-agent inputs (qp.QPInputs): [A, dim] p0, v0, a0, goal, vmax, amax;
  // [A, M] terminal_mask; [A, O, M, dim] normals; [A, O, M, N] rhs and
  // active (bool); [A, dim, M, N] lb, ub, x0; [A] comm half-range; [A, R] y0
  // (p null: cold start)
  Tin p0, v0, a0, goal, tmask, normals, rhs, active, vmax, amax, lb, ub, chr, x0, y0;
  // statics (qp.torch_statics, float32, contiguous)
  const float* X_pin;       // [MN, 3]
  const float* P_blk;       // [N, N] one segment's block of P_base = I_M ⊗ P_blk
  const float* N_null;      // [MN, K]
  const float* N3k;         // [K, MN]
  const float* Pn_base;     // [K, K]
  const float* T_term;      // [M, K, K]
  const float* G_stat;      // [K, K]
  const float* T_lsc;       // [M, K, K]
  const float* kernel_rho;  // [R]
  const float* An_stat;     // [R_stat, dk] the static rows in reduced coordinates
  const int* st_idx;        // [R_stat, kWidth] flat control point d·MN + mn
  // outputs, contiguous
  float* normals_out;  // [A, O, M, dim]
  float* Kinv;         // [A, dk, dk]
  float* Pn;           // [A, K, K]
  float* qn;           // [A, dk]
  float* ln;           // [A, R]
  float* un;
  float* rho;
  float* scale;
  float* xi;     // [A, dk]
  float* z;      // [A, R]
  float* y;      // [A, R]
  float* xpart;  // [A, dim, MN]
  float* b_off;  // [A, R]
  float* l;
  float* u;
  float* tvec;   // [A, MN]
  float* qflat;  // [A, dim, MN]
  int* info;     // [A]
  double* kmat;  // [A, dk, dk] the KKT matrix as assembled, or null
  int A, dim, O, M, N, K, phi, R_stat, use_comm;
  // qp.prepare_scalars as float32
  float c_vel, c_acc, vcap, acap, tdiag, qcoef, rho_lsc, sigma;
};

struct Dims {
  int dim, O, M, N, n, K, MN, dk, ld, R_lsc, R_stat, R, nv, na, nc;
};

__host__ __device__ inline Dims make_dims(int dim, int O, int M, int N, int K, int R_stat) {
  Dims D;
  D.dim = dim;
  D.O = O;
  D.M = M;
  D.N = N;
  D.n = N - 1;
  D.K = K;
  D.MN = M * N;
  D.dk = dim * K;
  D.ld = D.dk | 1;
  D.R_lsc = O * M * N;
  D.R_stat = R_stat;
  D.R = D.R_lsc + R_stat;
  D.nv = M * D.n;            // velocity rows per dimension
  D.na = M * (D.n - 1);      // acceleration rows per dimension
  D.nc = M * (M + 1) / 2;    // comm pairs per dimension (when used)
  return D;
}

// KM [dk][ld], INVD [dk] in double; S [M][dim][dim], INNER [dim·MN], NRM
// [O·M·dim], XP [dim·MN], XI [dk], PINS [dim·3], TD [M] in float.
__host__ __device__ inline size_t smem_bytes(const Dims& D) {
  const size_t doubles = (size_t)D.dk * D.ld + D.dk;
  const size_t floats = (size_t)D.M * D.dim * D.dim + 2 * (size_t)D.dim * D.MN +
                        (size_t)D.O * D.M * D.dim + D.dk + (size_t)D.dim * kPhi + D.M;
  return 8 * doubles + 4 * floats;
}

__device__ __forceinline__ long long offset(const Tin& t, long long a, int i, int j, int k) {
  return a * t.s[0] + i * t.s[1] + j * t.s[2] + k * t.s[3];
}

__device__ __forceinline__ float in(const Tin& t, long long a, int i = 0, int j = 0, int k = 0) {
  return __ldg(static_cast<const float*>(t.p) + offset(t, a, i, j, k));
}

__device__ __forceinline__ bool in_bool(const Tin& t, long long a, int i, int j, int k) {
  return __ldg(static_cast<const unsigned char*>(t.p) + offset(t, a, i, j, k)) != 0;
}

// Pn_dim entry i (k·K + l): Pn_base + Σ_m tdiag_m·T_term[m], the sum first.
__device__ __forceinline__ float pn_entry(const PrepArgs& a, const Dims& D, const float* TD,
                                          int i) {
  float acc = 0.f;
  for (int m = 0; m < D.M; ++m) acc = __fmaf_rn(TD[m], __ldg(a.T_term + m * D.K * D.K + i), acc);
  return __fadd_rn(__ldg(a.Pn_base + i), acc);
}

__global__ void __launch_bounds__(kThreads) qp_prepare_kernel(PrepArgs a) {
  extern __shared__ double smem[];
  const Dims D = make_dims(a.dim, a.O, a.M, a.N, a.K, a.R_stat);
  const int t = threadIdx.x, tx = t % kSide, ty = t / kSide;
  const long long ag = blockIdx.x;

  double* KM = smem;
  double* INVD = KM + (size_t)D.dk * D.ld;
  float* S = reinterpret_cast<float*>(INVD + D.dk);
  float* INNER = S + D.M * D.dim * D.dim;
  float* NRM = INNER + D.dim * D.MN;
  float* XP = NRM + D.O * D.M * D.dim;
  float* XI = XP + D.dim * D.MN;
  float* PINS = XI + D.dk;
  float* TD = PINS + D.dim * kPhi;

  // ---- the agent's normals (written out contiguous), pins, terminal weights
  const int n_nrm = D.O * D.M * D.dim;
  for (int i = t; i < n_nrm; i += kThreads) {
    const int d = i % D.dim, om = i / D.dim;
    const float v = in(a.normals, ag, om / D.M, om % D.M, d);
    NRM[i] = v;
    a.normals_out[ag * n_nrm + i] = v;
  }
  if (t < D.dim) {  // c0 = p, c1 = p + v·dt/n, c2 = a·dt²/(n(n−1)) + 2c1 − c0
    const float p = in(a.p0, ag, t), c1 = __fadd_rn(p, __fmul_rn(in(a.v0, ag, t), a.c_vel));
    PINS[t * kPhi] = p;
    PINS[t * kPhi + 1] = c1;
    PINS[t * kPhi + 2] =
        __fsub_rn(__fadd_rn(__fmul_rn(in(a.a0, ag, t), a.c_acc), __fmul_rn(2.f, c1)), p);
  }
  for (int m = t; m < D.M; m += kThreads) TD[m] = __fmul_rn(a.tdiag, in(a.tmask, ag, m));
  __syncthreads();

  // Every sum below is float32 in the order of the plain body's einsums on the
  // CPU (measured; the JAX package's alike): a chain of fused multiply-adds
  // from 0 in the index's order, or, for the LSC rows' offsets and the LSC
  // Gram, a product, then an addition, a term.

  // ---- particular solution xpart = X_pin·pins; tvec and qflat
  for (int i = t; i < D.dim * D.MN; i += kThreads) {
    const int d = i / D.MN, v = i - d * D.MN, m = v / D.N;
    float xp = 0.f;
    for (int p = 0; p < kPhi; ++p) xp = __fmaf_rn(__ldg(a.X_pin + v * kPhi + p), PINS[d * kPhi + p], xp);
    XP[i] = xp;
    const long long g = ag * D.dim * D.MN + i;
    a.xpart[g] = xp;
    const bool term = v - m * D.N == D.n;
    a.qflat[g] = term ? __fmul_rn(__fmul_rn(a.qcoef, in(a.tmask, ag, m)), in(a.goal, ag, d)) : 0.f;
    if (d == 0) a.tvec[ag * D.MN + v] = term ? TD[m] : 0.f;
  }
  __syncthreads();

  // ---- qflat + (P_base·xpart + tvec∘xpart) (P_base = I_M ⊗ P_blk: the
  // segment's block); the LSC Gram S[m] = Σ_o n nᵀ
  for (int i = t; i < D.dim * D.MN; i += kThreads) {
    const int d = i / D.MN, v = i - d * D.MN, m = v / D.N, k = v - m * D.N;
    const bool term = k == D.n;
    const float* x = XP + d * D.MN + m * D.N;  // segment m's points
    const float* pb = a.P_blk + k * D.N;
    float acc = 0.f;  // the zeros of P_base outside the block leave the chain as it is
    for (int j = 0; j < D.N; ++j) acc = __fmaf_rn(__ldg(pb + j), x[j], acc);
    acc = __fadd_rn(acc, __fmul_rn(term ? TD[m] : 0.f, x[k]));
    const float q = term ? __fmul_rn(__fmul_rn(a.qcoef, in(a.tmask, ag, m)), in(a.goal, ag, d)) : 0.f;
    INNER[i] = __fadd_rn(q, acc);
  }
  for (int i = t; i < D.M * D.dim * D.dim; i += kThreads) {
    const int e = i % D.dim, d = (i / D.dim) % D.dim, m = i / (D.dim * D.dim);
    float acc = __fmul_rn(NRM[m * D.dim + d], NRM[m * D.dim + e]);
    for (int o = 1; o < D.O; ++o) {
      const float* nr = NRM + (o * D.M + m) * D.dim;
      acc = __fadd_rn(acc, __fmul_rn(nr[d], nr[e]));
    }
    S[i] = acc;
  }

  // ---- the rows, in constraint_bounds's flat order, each pin offset b_off
  // in qp.py::_rows_batched's operations; y
  for (int r = t; r < D.R; r += kThreads) {
    float lo, hi, bo;
    if (r < D.R_lsc) {  // LSC row (o, m, i): one-sided
      const int o = r / D.MN, v = r - o * D.MN, m = v / D.N, i = v - m * D.N;
      lo = in_bool(a.active, ag, o, m, i) ? in(a.rhs, ag, o, m, i) : -kInf;
      hi = kInf;
      const float* nr = NRM + (o * D.M + m) * D.dim;
      bo = __fmul_rn(nr[0], XP[v]);
      for (int d = 1; d < D.dim; ++d) bo = __fadd_rn(bo, __fmul_rn(nr[d], XP[d * D.MN + v]));
    } else {
      const int s = r - D.R_lsc;
      int q = s;
      if (q < D.dim * D.nv) {  // velocity (d, m, i), vacuous at m = 0, i < 2
        const int d = q / D.nv, w = q - d * D.nv, m = w / D.n, i = w - m * D.n;
        const float* x = XP + d * D.MN + m * D.N + i;
        hi = (m == 0 && i < 2) ? kInf : __fmul_rn(in(a.vmax, ag, d), a.vcap);
        lo = -hi;
        bo = __fsub_rn(x[1], x[0]);
      } else if ((q -= D.dim * D.nv) < D.dim * D.na) {  // acceleration, vacuous at m = i = 0
        const int d = q / D.na, w = q - d * D.na, m = w / (D.n - 1), i = w - m * (D.n - 1);
        const float* x = XP + d * D.MN + m * D.N + i;
        hi = (m == 0 && i == 0) ? kInf : __fmul_rn(in(a.amax, ag, d), a.acap);
        lo = -hi;
        bo = __fadd_rn(__fsub_rn(x[2], __fmul_rn(2.f, x[1])), x[0]);
      } else if (a.use_comm && (q -= D.dim * D.na) < D.dim * D.nc) {  // comm pair (mi ≤ mm)
        const int d = q / D.nc;
        int mi = 0, p = q - d * D.nc;
        while (p >= D.M - mi) p -= D.M - mi++;
        const float* x = XP + d * D.MN;
        hi = in(a.chr, ag);
        lo = -hi;
        bo = __fsub_rn(x[(mi + p) * D.N + D.n], x[mi * D.N]);
      } else {  // variable bound (d, m, i), vacuous where pinned
        q = s - D.dim * (D.nv + D.na + (a.use_comm ? D.nc : 0));
        const int d = q / D.MN, v = q - d * D.MN, m = v / D.N, i = v - m * D.N;
        const bool pin = m == 0 && i < kPhi;
        lo = pin ? -kInf : in(a.lb, ag, d, m, i);
        hi = pin ? kInf : in(a.ub, ag, d, m, i);
        bo = XP[d * D.MN + v];
      }
    }
    const float h = __fmul_rn(6.f, __fmul_rn(0.5f, __fsub_rn(hi, lo)));
    const long long g = ag * D.R + r;
    a.l[g] = lo;
    a.u[g] = hi;
    a.b_off[g] = bo;
    a.ln[g] = __fsub_rn(lo, bo);
    a.un[g] = __fsub_rn(hi, bo);
    a.rho[g] = __ldg(a.kernel_rho + r);
    a.scale[g] = isnan(h) ? h : fminf(fmaxf(h, 0.02f), 1.f);
    a.y[g] = a.y0.p ? in(a.y0, ag, r) : 0.f;
  }

  // ---- warm start ξ0 = N_nullᵀ(x0 − xpart); Pn_dim = Pn_base + Σ_m tdiag_m T_term[m]
  for (int i = t; i < D.dk; i += kThreads) {
    const int d = i / D.K, k = i - d * D.K;
    float acc = 0.f;
    for (int m = 0, v = 0; m < D.M; ++m)
      for (int j = 0; j < D.N; ++j, ++v)
        acc = __fmaf_rn(__ldg(a.N_null + v * D.K + k),
                        __fsub_rn(in(a.x0, ag, d, m, j), XP[d * D.MN + v]), acc);
    XI[i] = acc;
    a.xi[ag * D.dk + i] = acc;
  }
  for (int i = t; i < D.K * D.K; i += kThreads) a.Pn[ag * D.K * D.K + i] = pn_entry(a, D, TD, i);
  __syncthreads();

  // ---- qn = N_nullᵀ(qflat + P_base·xpart + tvec∘xpart); control points of ξ0
  for (int i = t; i < D.dk; i += kThreads) {
    const int d = i / D.K, k = i - d * D.K;
    const float* w = INNER + d * D.MN;
    float acc = 0.f;
    for (int v = 0; v < D.MN; ++v) acc = __fmaf_rn(__ldg(a.N_null + v * D.K + k), w[v], acc);
    a.qn[ag * D.dk + i] = acc;
  }
  // ---- the KKT matrix's lower triangle (row d·K + k, column e·K + l):
  // ρ_lsc·Σ_m S[m][d][e]·T_lsc[m][k][l], plus (Pn + G_stat) + σ on the
  // diagonal blocks; the upper triangle zero (it will hold L⁻¹)
  for (int i = ty; i < D.dk; i += kRows) {
    const int d = i / D.K, k = i - d * D.K;
    for (int j = tx; j < D.dk; j += kSide) {
      float v = 0.f;
      if (j <= i) {
        const int e = j / D.K, l = j - e * D.K;
        float g = 0.f;
        for (int m = 0; m < D.M; ++m)
          g = __fmaf_rn(S[(m * D.dim + d) * D.dim + e], __ldg(a.T_lsc + (m * D.K + k) * D.K + l), g);
        v = __fmul_rn(a.rho_lsc, g);
        if (d == e)
          v = __fadd_rn(v, __fadd_rn(__fadd_rn(pn_entry(a, D, TD, k * D.K + l),
                                               __ldg(a.G_stat + k * D.K + l)),
                                     k == l ? a.sigma : 0.f));
        if (a.kmat) {
          a.kmat[(ag * D.dk + i) * D.dk + j] = v;
          a.kmat[(ag * D.dk + j) * D.dk + i] = v;
        }
      }
      KM[i * D.ld + j] = v;
    }
  }
  __syncthreads();

  // ---- z0 = A·ξ0 as qp.py::_fwd forms it: an LSC row (o, m, i) is
  // Σ_k N3[m][i][k]·(Σ_d n[o][m][d]·ξ[d][k]), a static row s of dimension d
  // Σ_k An_stat[s][d·K + k]·ξ[d][k] (its other dimensions' entries are zeros)
  for (int r = t; r < D.R; r += kThreads) {
    float acc = 0.f;
    if (r < D.R_lsc) {
      const int o = r / D.MN, v = r - o * D.MN, m = v / D.N;
      const float* nr = NRM + (o * D.M + m) * D.dim;
      for (int k = 0; k < D.K; ++k) {
        float c = 0.f;
        for (int d = 0; d < D.dim; ++d) c = __fmaf_rn(nr[d], XI[d * D.K + k], c);
        acc = __fmaf_rn(__ldg(a.N3k + k * D.MN + v), c, acc);
      }
    } else {
      const int s = r - D.R_lsc;
      const int d = __ldg(a.st_idx + s * kWidth) / D.MN;  // the row's dimension
      const float* an = a.An_stat + (size_t)s * D.dk + d * D.K;
      for (int k = 0; k < D.K; ++k) acc = __fmaf_rn(XI[d * D.K + k], __ldg(an + k), acc);
    }
    a.z[ag * D.R + r] = acc;
  }

  // ---- K = L D Lᵀ, right-looking: column j of KM keeps L's column times d_j
  int fail = 0;
  for (int j = 0; j < D.dk; ++j) {
    const double dj = KM[j * D.ld + j];
    if (!(dj > 0.)) {  // not positive definite (or NaN): the same for every thread
      fail = j + 1;
      break;
    }
    const double rj = 1. / dj;
    if (t == 0) INVD[j] = rj;
    for (int i = j + 1 + ty; i < D.dk; i += kRows) {
      const double cij = KM[i * D.ld + j] * rj;
      for (int l = j + 1 + tx; l <= i; l += kSide) KM[i * D.ld + l] -= cij * KM[l * D.ld + j];
    }
    __syncthreads();
  }
  float* kinv = a.Kinv + ag * D.dk * D.dk;
  if (fail) {
    for (int i = t; i < D.dk * D.dk; i += kThreads) kinv[i] = __int_as_float(0x7fc00000);
    if (t == 0) a.info[ag] = fail;
    return;
  }
  if (t == 0) a.info[ag] = 0;
  for (int i = ty; i < D.dk; i += kRows)  // L = (column j) / d_j, unit diagonal
    for (int j = tx; j < i; j += kSide) KM[i * D.ld + j] *= INVD[j];
  __syncthreads();

  // ---- X = L⁻¹ (unit lower), right-looking; X[i][c] (i > c) kept at KM[c][i]
  for (int k = 0; k + 1 < D.dk; ++k) {
    for (int i = k + 1 + ty; i < D.dk; i += kRows) {
      const double lik = KM[i * D.ld + k];
      for (int c = tx; c <= k; c += kSide)
        KM[c * D.ld + i] -= lik * (c == k ? 1. : KM[c * D.ld + k]);
    }
    __syncthreads();
  }

  // ---- Kinv = Xᵀ D⁻¹ X, rounded once
  for (int i = ty; i < D.dk; i += kRows)
    for (int j = tx; j < D.dk; j += kSide) {
      double s = 0.;
      for (int k = max(i, j); k < D.dk; ++k) {
        const double xi_ = k == i ? 1. : KM[i * D.ld + k];
        const double xj_ = k == j ? 1. : KM[j * D.ld + k];
        s += xi_ * xj_ * INVD[k];
      }
      kinv[i * D.dk + j] = (float)s;
    }
}

}  // namespace

// sizeof(PrepArgs), for the wrapper's check of its mirror of the layout.
extern "C" long long qp_prepare_args_size() { return sizeof(PrepArgs); }

// The largest dim*K taken.
extern "C" int qp_prepare_max_dk() { return kMaxDk; }

// Dynamic shared memory of one block, in bytes.
extern "C" long long qp_prepare_smem_bytes(int dim, int O, int M, int N, int K) {
  return (long long)smem_bytes(make_dims(dim, O, M, N, K, 0));
}

// Resident blocks (agents) per SM for this shape; negative: minus the CUDA error.
extern "C" int qp_prepare_blocks_per_sm(int dim, int O, int M, int N, int K) {
  const size_t smem = smem_bytes(make_dims(dim, O, M, N, K, 0));
  cudaError_t err = cudaFuncSetAttribute(
      qp_prepare_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, qp_prepare_kernel, kThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// Queues the preparation of the agents of `args` (a PrepArgs) on `stream`, one
// block per agent. Returns the CUDA error code (0 on success; -1 for a shape
// the kernel does not take). No synchronisation. (The struct is passed as
// void*: a parameter of a type in the anonymous namespace would give the
// entry internal linkage.)
extern "C" int qp_prepare_launch(const void* args, void* stream) {
  const PrepArgs& a = *static_cast<const PrepArgs*>(args);
  const Dims D = make_dims(a.dim, a.O, a.M, a.N, a.K, a.R_stat);
  if (a.A < 1 || a.dim < 1 || D.dk > kMaxDk || a.K < 1 || a.O < 1 || a.phi != kPhi ||
      D.n < 2 || a.M < 1)
    return -1;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      qp_prepare_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  qp_prepare_kernel<<<a.A, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
