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
// qn). No float32 sum goes to a tensor core. The KKT matrix is assembled in
// float32, then factored, inverted and multiplied out in double, and Kinv is
// rounded once: its condition number is about 1.6e5, so a float32 factor
// leaves Kinv up to ~1e-3 from the inverse (the plain body's
// torch.cholesky_solve does), and the ADMM solutions barely depend on that
// (~1e-6 m at A = 256).
//
// What bounds it on the H100: bytes. Each agent reads about 13 KB (its
// inputs; the statics, 30–90 KB, are shared by the fleet through L1 and L2)
// and writes about 67 KB (Kinv and nine R-vectors) in the main path's shape,
// some 83 MB at A = 1024: 0.025 ms at 3.35 TB/s. The double operations (dk³
// for the factor, the inverse and the product) are some 0.2 GFLOP at
// A = 1024, a few µs on the FP64 tensor cores. What a block takes is latency:
// chains of dependent loads and sums, and the inverse's serial panels. So the
// design keeps as many agents resident as it can and overlaps their chains:
//   - 128 threads a block and the matrix in shared memory as the lower
//     triangle of its 8 x 8 tiles, dk padded to a multiple of 8 with an
//     identity (whose factor is the identity: the padded factor equals the
//     unpadded one, and the padding is never written out). 20.5 KB in 2-D
//     (dk = 56), so with at most 64 registers 8 blocks fit on an SM and
//     A = 1024 runs in one wave on 132 SMs; 43.8 KB in 3-D (dk 84, padded to
//     88), where a second build takes up to 128 registers (4 blocks an SM).
//   - All warps share the float32 stages (three block barriers): the pins,
//     xpart, the LSC Gram, Pn, the reduced cost's terms, ξ0 and the KKT
//     matrix's lower tiles, a thread an (k, l) for all dim² blocks at once.
//   - Then warp 0 factors and inverts, alone (only __syncwarp), while the
//     other three write the rows and qn; each then takes z0's chunks from a
//     shared counter while any are left, and all four meet at a named
//     barrier (bar.sync 1, 128) to share the product's tiles. In 2-D the
//     rows take longer than the inverse and warp 0 helps with z0; in 3-D the
//     inverse takes longer and the row warps help with the product.
//   - K = L D Lᵀ by panels of 8 columns: the diagonal tile column by column
//     (__syncwarp), the panel's rows below it a lane a row, the diagonal
//     tile's unit lower inverse a lane a column, and the trailing tiles by
//     rank-8 products on the FP64 tensor cores (mma.sync m8n8k4 f64, the
//     fragments of CUTLASS's SM80_8x8x4_F64F64F64F64_TN), a row of tiles at
//     a time, two tiles at a time, each product's halves in two
//     accumulators.
//   - W = L⁻¹ in place, block column by block column from the last (LAPACK's
//     trtri order): the column's tiles times the inverted diagonal tile into
//     a staging buffer, then W[I][J] = −Σ_{K=J+1..I} W[I][K]·staged[K].
//   - Kinv = Wᵀ D⁻¹ W, each lower tile once (K ascending), rounded to float32
//     and written to (i, j) and (j, i), so Kinv is exactly symmetric.
//   - The tiles are swizzled (column c of row r at c ^ 4·((r >> 1) & 1)), so
//     the fragments' loads, a row of A or a column of B per quad, meet no
//     bank conflict.
// Three builds, chosen from the shape (kernel_for): <8> up to 8 tile rows,
// <4> above while the tiles fit in shared memory (dim·K 102 at M = 12 in
// 3-D: 13 tile rows, 62 KB a block, 3 blocks an SM), and <2, global> beyond
// (from ~216 in 3-D: 254 KB of tiles at dim·K 246). In <8> and <4>, after
// the float32 stages no block barrier is left but the one named barrier:
// the factor warp waits only on itself, where a right-looking factor and
// inverse a column at a time over the block take 2·dk block barriers (112
// in 2-D).
// The global build keeps the agent's tiles in a float64 workspace in global
// memory (the wrapper's, A x 64·n_tiles doubles), the normals and Pn in the
// agent's own outputs. Its first form ran the <4> algorithm there, and
// `clock64` marks on the H100 (dim·K 246, A = 168; PERF.md §6) showed every
// stage waiting on L2 with 4 warps a block: the float32 stages 0.79 M
// cycles, the factor warp 2.41 M and the inverse 0.95 M, the row warps 1.03
// M for the rows and 2.43 M for z0, the product 0.45 M. So it runs a block of
// 512 threads, two an SM (a batch of up to 264 agents resident at once), and
// every warp takes every stage in turn: the float32 stages, the rows and qn,
// z0's chunks, then the factor and the inverse panel by panel
// (factor_and_invert_block: each panel's L in shared memory, the trailing
// tiles a pair a warp, W's tiles a warp each, a tile's operations those of
// factor_and_invert, so Kinv is the same bits), then the product. Device
// memory is the only limit.
//
// Built by ops/qp_prepare_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point qp_prepare_launch (ctypes).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
// Resident blocks an SM is built for (the registers a thread may take): 8 up
// to kSmallTiles tile rows (2-D), 4 above, where shared memory allows no more
// than 5 and the factor warp takes up to 128 registers instead of 64.
constexpr int kSmallTiles = 8;
// The global build: a block of kGlobalThreads, two an SM (at most 64
// registers a thread), so that a batch of up to 264 agents is resident at
// once; every warp takes the factor's, the inverse's and the product's tiles.
constexpr int kGlobalThreads = 512;
constexpr int kGlobalBlocks = 2;
constexpr int kBarJoin = 1;        // the factor and row warps' named barrier (0 is __syncthreads)
constexpr int kMaxDim = 3;
constexpr int kSegRows = 8;  // z0's LSC rows of a segment, taken 8 at a time
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
  const float* An_statT;    // [dk, R_stat] the static rows in reduced coordinates, transposed
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
  double* work;  // [A, 64·n_tiles] the tiles of the global build (else null)
  int A, dim, O, M, N, K, phi, R_stat, use_comm;
  // qp.prepare_scalars as float32
  float c_vel, c_acc, vcap, acap, tdiag, qcoef, rho_lsc, sigma;
};

struct Dims {
  int dim, O, M, N, n, K, MN, dk, nT, dkp, n_tiles, R_lsc, R_stat, R, nv, na, nc;
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
  D.nT = (D.dk + 7) / 8;  // tile rows of the padded matrix
  D.dkp = 8 * D.nT;
  D.n_tiles = D.nT * (D.nT + 1) / 2;  // its lower triangle's tiles
  D.R_lsc = O * M * N;
  D.R_stat = R_stat;
  D.R = D.R_lsc + R_stat;
  D.nv = M * D.n;            // velocity rows per dimension
  D.na = M * (D.n - 1);      // acceleration rows per dimension
  D.nc = M * (M + 1) / 2;    // comm pairs per dimension (when used)
  return D;
}

// XB, in doubles: the inverse's staged column STG [nT − 1][64] and INVD [dkp]
// while the factor warps run; before, Pn_dim [K][K] in float.
__host__ __device__ inline int xb_doubles(const Dims& D) {
  const int stg = 64 * (D.nT - 1) + D.dkp, pn = (D.K * D.K + 1) / 2;
  return stg > pn ? stg : pn;
}

// TL [n_tiles][64] (the lower tiles) and XB in double; S [M][dim][dim], INNER
// [dim·MN], NRM [O·M·dim], XP [dim·MN], XI [dk], PINS [dim·3], TD [M] in
// float; FAIL and POOL, ints. The global build (kGlobal) keeps TL in the
// agent's workspace, NRM in its normals output and Pn_dim in its Pn output:
// its doubles are the panel (then the inverse's staged column) PNL
// [nT − 1][64], INVD [dkp] and the diagonal tile DT [64].
__host__ __device__ inline size_t smem_bytes(const Dims& D, bool global) {
  const size_t doubles = global ? 64 * (size_t)D.nT + D.dkp
                                : 64 * (size_t)D.n_tiles + xb_doubles(D);
  const size_t floats = (size_t)D.M * D.dim * D.dim + 2 * (size_t)D.dim * D.MN +
                        (global ? 0 : (size_t)D.O * D.M * D.dim) + D.dk + (size_t)D.dim * kPhi +
                        D.M + 2;
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
#pragma unroll 4
  for (int m = 0; m < D.M; ++m) acc = __fmaf_rn(TD[m], __ldg(a.T_term + m * D.K * D.K + i), acc);
  return __fadd_rn(__ldg(a.Pn_base + i), acc);
}

// ---- the double tiles --------------------------------------------------

// Entry (r, c) of an 8 x 8 tile, swizzled.
__device__ __forceinline__ int sw(int r, int c) { return (r << 3) | (c ^ ((r & 2) << 1)); }

// Lower tile (I, J), J ≤ I, of the tiles TL.
__device__ __forceinline__ double* tile(double* TL, int I, int J) {
  return TL + ((I * (I + 1) / 2 + J) << 6);
}
__device__ __forceinline__ const double* tile(const double* TL, int I, int J) {
  return TL + ((I * (I + 1) / 2 + J) << 6);
}

// (I, J) of the u-th tile of a lower triangle of tiles, row by row.
__device__ __forceinline__ void tile_of(int u, int& I, int& J) {
  I = 0;
  while ((I + 1) * (I + 2) / 2 <= u) ++I;
  J = u - I * (I + 1) / 2;
}

// (I, J) moved on to the next tile of a lower triangle, row by row, where
// J has run past I (the walk of tile_of without its search).
__device__ __forceinline__ void next_tile(int& I, int& J) {
  while (J > I) {
    J -= I + 1;
    ++I;
  }
}

// Entry (r, c) of W's tile T: a diagonal tile holds W's strictly lower part
// (its diagonal is 1, its upper part 0).
__device__ __forceinline__ double w_at(const double* T, bool diag, int r, int c) {
  const double v = T[sw(r, c)];
  return !diag || r > c ? v : (r == c ? 1. : 0.);
}

// c += a·b on the FP64 tensor cores: A 8 x 4 (lane: row lane/4, column
// lane%4), B 4 x 8 (row lane%4, column lane/4), C 8 x 8 (row lane/4,
// columns 2·(lane%4) and 2·(lane%4) + 1).
__device__ __forceinline__ void dmma(double& c0, double& c1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(c0), "+d"(c1)
               : "d"(a), "d"(b));
}

// Named barrier kBarJoin: the factor warp and the row warps meet before the
// product, once each is done.
__device__ __forceinline__ void join_all() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kBarJoin), "r"(kThreads) : "memory");
}

// The factor warp's part: K = L D Lᵀ and W = L⁻¹ from the assembled tiles.
// Returns 0, or the order of the first non-positive pivot.
__device__ int factor_and_invert(const Dims& D, double* TL, double* STG, double* INVD,
                                 int lane) {
  const int g = lane >> 2, q = lane & 3, nT = D.nT;
  // this lane's entries (i, l), l ≤ i, of a diagonal tile (36: lanes 0-3 take two)
  int ei[2], el[2];
  for (int s = 0; s < 2; ++s) tile_of(lane + 32 * s, ei[s], el[s]);
  const int n_e = lane < 4 ? 2 : 1;

  // ---- K = L D Lᵀ by panels of 8 columns
  for (int p = 0; p < nT; ++p) {
    double* T = tile(TL, p, p);
    // the diagonal tile, column by column: L's column times d_j, d_j
    for (int j = 0; j < 8; ++j) {
      const double dj = T[sw(j, j)];
      if (!(dj > 0.)) return 8 * p + j + 1;  // not positive definite (or NaN): every lane
      const double rj = __drcp_rn(dj);
      if (lane == 0) INVD[8 * p + j] = rj;
      for (int s = 0; s < n_e; ++s)
        if (el[s] > j) T[sw(ei[s], el[s])] -= (T[sw(ei[s], j)] * rj) * T[sw(el[s], j)];
      __syncwarp();
    }
    // the panel's rows below the diagonal tile, a lane a row: L[i][j] =
    // (K[i][j] − Σ_{l<j} L[i][l]·T[j][l])/d_j, T's strict lower part L·d
    for (int row = 8 * (p + 1) + lane; row < D.dkp; row += 32) {
      double* R = tile(TL, row >> 3, p);
      const int r = row & 7;
      double lr[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        double s = R[sw(r, j)];
#pragma unroll
        for (int l = 0; l < j; ++l) s -= lr[l] * T[sw(j, l)];
        lr[j] = s * INVD[8 * p + j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) R[sw(r, j)] = lr[j];
    }
    __syncwarp();
    // the diagonal tile's unit lower inverse in place, a lane a column
    {
      const int c = lane;
      double w[8];
      if (c < 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          double s = i == c ? 1. : 0.;
#pragma unroll
          for (int k = 0; k < i; ++k)
            if (k >= c) s -= (T[sw(i, k)] * INVD[8 * p + k]) * w[k];
          w[i] = s;
        }
      }
      __syncwarp();
      if (c < 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i > c) T[sw(i, c)] = w[i];
      }
    }
    // the trailing tiles (I, J), p < J ≤ I: K[I][J] −= L[I][p]·(L[J][p]·D_p)ᵀ,
    // a row of tiles at a time (its A fragments loaded once), two tiles at a
    // time, the two halves of each rank-8 product in two accumulators
    const double d0 = T[sw(q, q)], d1 = T[sw(4 + q, 4 + q)];
    for (int I = p + 1; I < nT; ++I) {
      const double* LI = tile(TL, I, p);
      const double a0 = -LI[sw(g, q)], a1 = -LI[sw(g, 4 + q)];
      for (int J = p + 1; J <= I; J += 2) {
        const bool two = J < I;
        double* C0 = tile(TL, I, J);
        double* C1 = C0 + 64;  // tile (I, J + 1)
        const double* L0 = tile(TL, J, p);
        const double* L1 = tile(TL, J + two, p);
        double c0 = C0[sw(g, 2 * q)], c1 = C0[sw(g, 2 * q + 1)], e0 = 0., e1 = 0.;
        double f0 = 0., f1 = 0., h0 = 0., h1 = 0.;
        const double b0 = d0 * L0[sw(g, q)], b1 = d1 * L0[sw(g, 4 + q)];
        const double b2 = d0 * L1[sw(g, q)], b3 = d1 * L1[sw(g, 4 + q)];
        if (two) {
          f0 = C1[sw(g, 2 * q)];
          f1 = C1[sw(g, 2 * q + 1)];
        }
        dmma(c0, c1, a0, b0);
        dmma(e0, e1, a1, b1);
        if (two) {
          dmma(f0, f1, a0, b2);
          dmma(h0, h1, a1, b3);
        }
        C0[sw(g, 2 * q)] = c0 + e0;
        C0[sw(g, 2 * q + 1)] = c1 + e1;
        if (two) {
          C1[sw(g, 2 * q)] = f0 + h0;
          C1[sw(g, 2 * q + 1)] = f1 + h1;
        }
      }
    }
    __syncwarp();
  }

  // ---- W = L⁻¹ in place, block column by block column from the last
  for (int J = nT - 2; J >= 0; --J) {
    const double* Wjj = tile(TL, J, J);
    const int m = nT - 1 - J;
    for (int u = 0; u < m; ++u) {  // staged[K] = L[K][J]·W[J][J], K = J + 1 + u
      const double* L = tile(TL, J + 1 + u, J);
      double c0 = 0., c1 = 0., e0 = 0., e1 = 0.;
      dmma(c0, c1, L[sw(g, q)], w_at(Wjj, true, q, g));
      dmma(e0, e1, L[sw(g, 4 + q)], w_at(Wjj, true, 4 + q, g));
      double* St = STG + 64 * u;
      St[sw(g, 2 * q)] = c0 + e0;
      St[sw(g, 2 * q + 1)] = c1 + e1;
    }
    __syncwarp();
    for (int u = 0; u < m; ++u) {  // W[I][J] = −Σ_{K=J+1..I} W[I][K]·staged[K], I = J + 1 + u
      const int I = J + 1 + u;
      double c0 = 0., c1 = 0., e0 = 0., e1 = 0.;
      for (int K = J + 1; K <= I; ++K) {
        const double* Wik = tile(TL, I, K);
        const double* St = STG + 64 * (K - J - 1);
        dmma(c0, c1, -w_at(Wik, K == I, g, q), St[sw(q, g)]);
        dmma(e0, e1, -w_at(Wik, K == I, g, 4 + q), St[sw(4 + q, g)]);
      }
      double* Wij = tile(TL, I, J);
      Wij[sw(g, 2 * q)] = c0 + e0;
      Wij[sw(g, 2 * q + 1)] = c1 + e1;
    }
    __syncwarp();
  }
  return 0;
}

// The global build's K = L D Lᵀ and W = L⁻¹ on the tiles in the workspace, over
// every warp of the block, each tile's arithmetic as factor_and_invert's (the
// same operations in the same order, so the same bits). A panel p: (a) warp 0
// factors the diagonal tile in shared memory (DT); (b) a thread a row of the
// panel below it, written to its tile and to the shared panel PNL; (c) warp 0
// inverts DT's unit lower part and writes the tile back, while (d) every warp
// takes trailing tile pairs (I, J), J ≤ I, their L operands from PNL and the
// pivots from DT's diagonal. W block column by block column from the last:
// the staged column over the warps into PNL, then W[I][J] a warp a tile, the
// longest chains first. Returns 0 or the order of the first non-positive
// pivot, in every thread.
template <int NT>
__device__ int factor_and_invert_block(const Dims& D, double* TL, double* PNL, double* INVD,
                                       double* DT, int* FAIL, int warp, int lane) {
  constexpr int NW = NT / 32;
  const int g = lane >> 2, q = lane & 3, nT = D.nT;
  int ei[2], el[2];
  for (int s = 0; s < 2; ++s) tile_of(lane + 32 * s, ei[s], el[s]);
  const int n_e = lane < 4 ? 2 : 1;
  // warp 0 takes the trailing jobs last in each round: it starts them late
  const int wj = warp == 0 ? NW - 1 : warp - 1;

  for (int p = 0; p < nT; ++p) {
    // (a) the diagonal tile, column by column: L's column times d_j, d_j
    if (warp == 0) {
      const double* Tg = tile(TL, p, p);
      DT[lane] = Tg[lane];
      DT[lane + 32] = Tg[lane + 32];
      __syncwarp();
      int fail = 0;
      for (int j = 0; j < 8; ++j) {
        const double dj = DT[sw(j, j)];
        if (!(dj > 0.)) {  // not positive definite (or NaN): every lane
          fail = 8 * p + j + 1;
          break;
        }
        const double rj = __drcp_rn(dj);
        if (lane == 0) INVD[8 * p + j] = rj;
        for (int s = 0; s < n_e; ++s)
          if (el[s] > j) DT[sw(ei[s], el[s])] -= (DT[sw(ei[s], j)] * rj) * DT[sw(el[s], j)];
        __syncwarp();
      }
      if (lane == 0) *FAIL = fail;
    }
    __syncthreads();
    if (*FAIL) return *FAIL;
    // (b) the panel's rows below the diagonal tile, a thread a row: L[i][j] =
    // (K[i][j] − Σ_{l<j} L[i][l]·T[j][l])/d_j
    for (int row = 8 * (p + 1) + (int)threadIdx.x; row < D.dkp; row += NT) {
      double* R = tile(TL, row >> 3, p);
      double* P = PNL + 64 * ((row >> 3) - p - 1);
      const int r = row & 7;
      double lr[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        double s = R[sw(r, j)];
#pragma unroll
        for (int l = 0; l < j; ++l) s -= lr[l] * DT[sw(j, l)];
        lr[j] = s * INVD[8 * p + j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        R[sw(r, j)] = lr[j];
        P[sw(r, j)] = lr[j];
      }
    }
    __syncthreads();
    // (c) the diagonal tile's unit lower inverse in place, a lane a column
    if (warp == 0) {
      const int c = lane;
      double w[8];
      if (c < 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          double s = i == c ? 1. : 0.;
#pragma unroll
          for (int k = 0; k < i; ++k)
            if (k >= c) s -= (DT[sw(i, k)] * INVD[8 * p + k]) * w[k];
          w[i] = s;
        }
      }
      __syncwarp();
      if (c < 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i > c) DT[sw(i, c)] = w[i];
      }
      __syncwarp();
      double* Tg = tile(TL, p, p);
      Tg[lane] = DT[lane];
      Tg[lane + 32] = DT[lane + 32];
    }
    // (d) the trailing tiles (I, J), p < J ≤ I: K[I][J] −= L[I][p]·(L[J][p]·D_p)ᵀ,
    // two tiles (J, J + 1) a job, row I holding (I − p + 1)/2 jobs; the
    // pivots from DT's diagonal, which (c) does not write
    const double d0 = DT[sw(q, q)], d1 = DT[sw(4 + q, 4 + q)];
    int I = p + 1, jj = wj;
    for (;;) {
      while (I < nT && jj >= (I - p + 1) / 2) jj -= (I - p + 1) / 2, ++I;
      if (I >= nT) break;
      const int J = p + 1 + 2 * jj;
      const bool two = J < I;
      const double* LI = PNL + 64 * (I - p - 1);
      const double a0 = -LI[sw(g, q)], a1 = -LI[sw(g, 4 + q)];
      double* C0 = tile(TL, I, J);
      double* C1 = C0 + 64;  // tile (I, J + 1)
      const double* L0 = PNL + 64 * (J - p - 1);
      const double* L1 = PNL + 64 * (J + two - p - 1);
      double c0 = C0[sw(g, 2 * q)], c1 = C0[sw(g, 2 * q + 1)], e0 = 0., e1 = 0.;
      double f0 = 0., f1 = 0., h0 = 0., h1 = 0.;
      const double b0 = d0 * L0[sw(g, q)], b1 = d1 * L0[sw(g, 4 + q)];
      const double b2 = d0 * L1[sw(g, q)], b3 = d1 * L1[sw(g, 4 + q)];
      if (two) {
        f0 = C1[sw(g, 2 * q)];
        f1 = C1[sw(g, 2 * q + 1)];
      }
      dmma(c0, c1, a0, b0);
      dmma(e0, e1, a1, b1);
      if (two) {
        dmma(f0, f1, a0, b2);
        dmma(h0, h1, a1, b3);
      }
      C0[sw(g, 2 * q)] = c0 + e0;
      C0[sw(g, 2 * q + 1)] = c1 + e1;
      if (two) {
        C1[sw(g, 2 * q)] = f0 + h0;
        C1[sw(g, 2 * q + 1)] = f1 + h1;
      }
      jj += NW;
    }
    __syncthreads();
  }

  // ---- W = L⁻¹ in place, block column by block column from the last
  for (int J = nT - 2; J >= 0; --J) {
    const double* Wjj = tile(TL, J, J);
    const int m = nT - 1 - J;
    for (int u = warp; u < m; u += NW) {  // staged[K] = L[K][J]·W[J][J], K = J + 1 + u
      const double* L = tile(TL, J + 1 + u, J);
      double c0 = 0., c1 = 0., e0 = 0., e1 = 0.;
      dmma(c0, c1, L[sw(g, q)], w_at(Wjj, true, q, g));
      dmma(e0, e1, L[sw(g, 4 + q)], w_at(Wjj, true, 4 + q, g));
      double* St = PNL + 64 * u;
      St[sw(g, 2 * q)] = c0 + e0;
      St[sw(g, 2 * q + 1)] = c1 + e1;
    }
    __syncthreads();
    for (int u = warp; u < m; u += NW) {  // W[I][J] = −Σ_{K=J+1..I} W[I][K]·staged[K]
      const int I = nT - 1 - u;           // the longest chains first
      double c0 = 0., c1 = 0., e0 = 0., e1 = 0.;
#pragma unroll 4
      for (int K = J + 1; K <= I; ++K) {
        const double* Wik = tile(TL, I, K);
        const double* St = PNL + 64 * (K - J - 1);
        dmma(c0, c1, -w_at(Wik, K == I, g, q), St[sw(q, g)]);
        dmma(e0, e1, -w_at(Wik, K == I, g, 4 + q), St[sw(4 + q, g)]);
      }
      double* Wij = tile(TL, I, J);
      Wij[sw(g, 2 * q)] = c0 + e0;
      Wij[sw(g, 2 * q + 1)] = c1 + e1;
    }
    __syncthreads();
  }
  return 0;
}

// Kinv = Wᵀ D⁻¹ W: each lower tile once, K ascending, rounded once and written
// to (i, j) and (j, i); warp w of nw takes every nw-th tile.
__device__ void product(const PrepArgs& a, const Dims& D, const double* TL, const double* INVD,
                        int w, int nw, int lane, long long ag) {
  const int g = lane >> 2, q = lane & 3, nT = D.nT;
  float* kinv = a.Kinv + ag * D.dk * D.dk;
  for (int I = 0, J = w; next_tile(I, J), I < nT; J += nw) {
    double c0 = 0., c1 = 0., e0 = 0., e1 = 0.;
    for (int K = I; K < nT; ++K) {
      const double* Wki = tile(TL, K, I);
      const double* Wkj = tile(TL, K, J);
      dmma(c0, c1, w_at(Wki, K == I, q, g), INVD[8 * K + q] * w_at(Wkj, K == J, q, g));
      dmma(e0, e1, w_at(Wki, K == I, 4 + q, g), INVD[8 * K + 4 + q] * w_at(Wkj, K == J, 4 + q, g));
    }
    c0 += e0;
    c1 += e1;
    const int i = 8 * I + g;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * J + 2 * q + e;
      if (i < D.dk && j < D.dk && (I > J || g >= 2 * q + e)) {
        const float v = (float)(e ? c1 : c0);
        kinv[i * D.dk + j] = v;
        kinv[j * D.dk + i] = v;
      }
    }
  }
}

// The row warps' part: the rows (l, u, b_off, ln, un, ρ, scale, y) and qn.
// rt: the thread among the row warps' nr.
__device__ void rows_and_qn(const PrepArgs& a, const Dims& D, const float* INNER,
                            const float* NRM, const float* XP, int rt, int nr, long long ag) {
  // ---- the rows, in constraint_bounds's flat order, each pin offset b_off
  // in qp.py::_rows_batched's operations; y
  for (int r = rt; r < D.R; r += nr) {
    float lo, hi, bo;
    if (r < D.R_lsc) {  // LSC row (o, m, i): one-sided
      const int o = r / D.MN, v = r - o * D.MN, m = v / D.N, i = v - m * D.N;
      lo = in_bool(a.active, ag, o, m, i) ? in(a.rhs, ag, o, m, i) : -kInf;
      hi = kInf;
      const float* nr_ = NRM + (o * D.M + m) * D.dim;
      bo = __fmul_rn(nr_[0], XP[v]);
      for (int d = 1; d < D.dim; ++d) bo = __fadd_rn(bo, __fmul_rn(nr_[d], XP[d * D.MN + v]));
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

  // ---- qn = N_nullᵀ(qflat + P_base·xpart + tvec∘xpart)
  for (int i = rt; i < D.dk; i += nr) {
    const int d = i / D.K, k = i - d * D.K;
    const float* w = INNER + d * D.MN;
    float acc = 0.f;
#pragma unroll 4
    for (int v = 0; v < D.MN; ++v) acc = __fmaf_rn(__ldg(a.N_null + v * D.K + k), w[v], acc);
    a.qn[ag * D.dk + i] = acc;
  }
}

// z0 = A·ξ0 as qp.py::_fwd forms it, in chunks of 32 a warp takes from the
// shared counter POOL: first the LSC segments (o, m), a lane a segment and
// its N rows (o, m, i), each Σ_k N3[m][i][k]·(Σ_d n[o][m][d]·ξ[d][k]); then the
// static rows, a lane a row s of dimension d, Σ_k An_stat[s][d·K + k]·ξ[d][k]
// (its other dimensions' entries are zeros), U of its loads in flight.
template <int U>
__device__ void z0_pool(const PrepArgs& a, const Dims& D, const float* NRM, const float* XI,
                        int* POOL, int lane, long long ag) {
  const int n_seg = D.O * D.M;
  const int seg_chunks = (n_seg + 31) / 32, chunks = seg_chunks + (D.R_stat + 31) / 32;
  for (;;) {
    int c = 0;
    if (lane == 0) c = atomicAdd(POOL, 1);
    c = __shfl_sync(0xffffffffu, c, 0);
    if (c >= chunks) return;
    if (c < seg_chunks && 32 * c + lane < n_seg) {
      const int om = 32 * c + lane, m = om % D.M;
      const float* nrm = NRM + om * D.dim;
      float* z = a.z + ag * D.R + om * D.N;
      for (int i0 = 0; i0 < D.N; i0 += kSegRows) {
        float acc[kSegRows] = {};
#pragma unroll 2
        for (int k = 0; k < D.K; ++k) {
          float cs = 0.f;
          for (int d = 0; d < D.dim; ++d) cs = __fmaf_rn(nrm[d], XI[d * D.K + k], cs);
          const float* n3 = a.N3k + k * D.MN + m * D.N + i0;
#pragma unroll
          for (int i = 0; i < kSegRows; ++i)
            if (i0 + i < D.N) acc[i] = __fmaf_rn(__ldg(n3 + i), cs, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < kSegRows; ++i)
          if (i0 + i < D.N) z[i0 + i] = acc[i];
      }
    } else if (c >= seg_chunks && 32 * (c - seg_chunks) + lane < D.R_stat) {
      const int s = 32 * (c - seg_chunks) + lane;
      const int d = __ldg(a.st_idx + s * kWidth) / D.MN;  // the row's dimension
      const float* an = a.An_statT + (size_t)d * D.K * D.R_stat + s;
      float acc = 0.f;
#pragma unroll U
      for (int k = 0; k < D.K; ++k)
        acc = __fmaf_rn(XI[d * D.K + k], __ldg(an + (size_t)k * D.R_stat), acc);
      a.z[ag * D.R + D.R_lsc + s] = acc;
    }
  }
}

// kGlobal: the tiles in the agent's workspace a.work, read through L1 and L2
// (the shapes whose tiles do not fit in shared memory), a block of
// kGlobalThreads whose warps all take every stage in turn.
template <int kMinBlocks, bool kGlobal>
__global__ void __launch_bounds__(kGlobal ? kGlobalThreads : kThreads, kMinBlocks)
    qp_prepare_kernel(PrepArgs a) {
  constexpr int NT = kGlobal ? kGlobalThreads : kThreads;
  extern __shared__ double smem[];
  const Dims D = make_dims(a.dim, a.O, a.M, a.N, a.K, a.R_stat);
  const int t = threadIdx.x;
  const long long ag = blockIdx.x;
  const int n_nrm = D.O * D.M * D.dim;

  double* TL = kGlobal ? a.work + ag * 64 * D.n_tiles : smem;
  double* STG = kGlobal ? smem : TL + 64 * D.n_tiles;
  double* INVD = STG + 64 * (D.nT - 1);
  double* DT = INVD + D.dkp;  // the global build's diagonal tile
  // Pn_dim: in STG until the factor warps start, or the agent's Pn output
  float* PN = kGlobal ? a.Pn + ag * D.K * D.K : reinterpret_cast<float*>(STG);
  float* S = reinterpret_cast<float*>(kGlobal ? DT + 64 : STG + xb_doubles(D));
  float* INNER = S + D.M * D.dim * D.dim;
  float* NRM = kGlobal ? a.normals_out + ag * n_nrm : INNER + D.dim * D.MN;
  float* XP = kGlobal ? INNER + D.dim * D.MN : NRM + n_nrm;
  float* XI = XP + D.dim * D.MN;
  float* PINS = XI + D.dk;
  float* TD = PINS + D.dim * kPhi;
  int* FAIL = reinterpret_cast<int*>(TD + D.M);
  int* POOL = FAIL + 1;

  // ---- the agent's normals (written out contiguous), pins, terminal weights
  for (int i = t; i < n_nrm; i += NT) {
    const int d = i % D.dim, om = i / D.dim;
    const float v = in(a.normals, ag, om / D.M, om % D.M, d);
    NRM[i] = v;
    if (!kGlobal) a.normals_out[ag * n_nrm + i] = v;
  }
  if (t < D.dim) {  // c0 = p, c1 = p + v·dt/n, c2 = a·dt²/(n(n−1)) + 2c1 − c0
    const float p = in(a.p0, ag, t), c1 = __fadd_rn(p, __fmul_rn(in(a.v0, ag, t), a.c_vel));
    PINS[t * kPhi] = p;
    PINS[t * kPhi + 1] = c1;
    PINS[t * kPhi + 2] =
        __fsub_rn(__fadd_rn(__fmul_rn(in(a.a0, ag, t), a.c_acc), __fmul_rn(2.f, c1)), p);
  }
  for (int m = t; m < D.M; m += NT) TD[m] = __fmul_rn(a.tdiag, in(a.tmask, ag, m));
  if (t == 0) *POOL = 0;
  __syncthreads();

  // Every sum below is float32 in the order of the plain body's einsums on the
  // CPU (measured; the JAX package's alike): a chain of fused multiply-adds
  // from 0 in the index's order, or, for the LSC rows' offsets and the LSC
  // Gram, a product, then an addition, a term.

  // ---- particular solution xpart = X_pin·pins; tvec and qflat; the LSC Gram
  // S[m] = Σ_o n nᵀ
  for (int i = t; i < D.dim * D.MN; i += NT) {
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
  // (the global build reads its normals from global memory: its chains'
  // loads unrolled, the chains' order kept)
  for (int i = t; i < D.M * D.dim * D.dim; i += NT) {
    const int e = i % D.dim, d = (i / D.dim) % D.dim, m = i / (D.dim * D.dim);
    float acc = __fmul_rn(NRM[m * D.dim + d], NRM[m * D.dim + e]);
    auto gram_term = [&](int o) {
      const float* nr = NRM + (o * D.M + m) * D.dim;
      acc = __fadd_rn(acc, __fmul_rn(nr[d], nr[e]));
    };
    if constexpr (kGlobal) {
#pragma unroll 8
      for (int o = 1; o < D.O; ++o) gram_term(o);
    } else {
      for (int o = 1; o < D.O; ++o) gram_term(o);
    }
    S[i] = acc;
  }
  for (int i = t; i < D.K * D.K; i += NT) {
    const float v = pn_entry(a, D, TD, i);
    PN[i] = v;
    if (!kGlobal) a.Pn[ag * D.K * D.K + i] = v;
  }
  __syncthreads();

  // ---- qflat + (P_base·xpart + tvec∘xpart) (P_base = I_M ⊗ P_blk: the
  // segment's block)
  for (int i = t; i < D.dim * D.MN; i += NT) {
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
  // ---- warm start ξ0 = N_nullᵀ(x0 − xpart)
  for (int i = t; i < D.dk; i += NT) {
    const int d = i / D.K, k = i - d * D.K;
    float acc = 0.f;
#pragma unroll 4
    for (int v = 0; v < D.MN; ++v)
      acc = __fmaf_rn(__ldg(a.N_null + v * D.K + k),
                      __fsub_rn(in(a.x0, ag, d, v / D.N, v % D.N), XP[d * D.MN + v]), acc);
    XI[i] = acc;
    a.xi[ag * D.dk + i] = acc;
  }
  // ---- the KKT matrix's lower tiles (row d·K + k, column e·K + l):
  // ρ_lsc·Σ_m S[m][d][e]·T_lsc[m][k][l], plus (Pn + G_stat) + σ on the
  // diagonal blocks, a thread an (k, l) for every (d, e), e ≤ d; the padding
  // rows an identity (the diagonal tiles' upper parts are never read)
  for (int x = t; D.dkp > D.dk && x < 64 * D.nT; x += NT) {
    const int r = (x >> 3) & 7, i = 8 * (D.nT - 1) + r;
    const int j = 8 * (x >> 6) + ((x & 7) ^ ((r & 2) << 1));  // sw(r, c) inverted
    if (i >= D.dk) tile(TL, D.nT - 1, x >> 6)[x & 63] = i == j ? 1. : 0.;
  }
  for (int kl = t; kl < D.K * D.K; kl += NT) {
    const int k = kl / D.K, l = kl - k * D.K;
    float g[kMaxDim * (kMaxDim + 1) / 2] = {};
    auto kkt_term = [&](int m) {
      const float tl = __ldg(a.T_lsc + m * D.K * D.K + kl);
      const float* Sm = S + m * D.dim * D.dim;
#pragma unroll
      for (int d = 0; d < kMaxDim; ++d)
#pragma unroll
        for (int e = 0; e <= d; ++e)
          if (d < D.dim)
            g[d * (d + 1) / 2 + e] = __fmaf_rn(Sm[d * D.dim + e], tl, g[d * (d + 1) / 2 + e]);
    };
    if constexpr (kGlobal) {  // T_lsc's loads unrolled, the chains' order kept
#pragma unroll 4
      for (int m = 0; m < D.M; ++m) kkt_term(m);
    } else {
      for (int m = 0; m < D.M; ++m) kkt_term(m);
    }
    const float diag = __fadd_rn(__fadd_rn(PN[kl], __ldg(a.G_stat + kl)), k == l ? a.sigma : 0.f);
#pragma unroll
    for (int d = 0; d < kMaxDim; ++d)
#pragma unroll
      for (int e = 0; e <= d; ++e) {
        if (d >= D.dim || (d == e && k < l)) continue;
        float v = __fmul_rn(a.rho_lsc, g[d * (d + 1) / 2 + e]);
        if (d == e) v = __fadd_rn(v, diag);
        const int i = d * D.K + k, j = e * D.K + l;
        tile(TL, i >> 3, j >> 3)[sw(i & 7, j & 7)] = v;
        if (a.kmat) {
          a.kmat[(ag * D.dk + i) * D.dk + j] = v;
          a.kmat[(ag * D.dk + j) * D.dk + i] = v;
        }
      }
  }
  __syncthreads();

  const int warp = t >> 5, lane = t & 31;
  int fail;
  if constexpr (kGlobal) {
    // ---- every warp: the rows and qn, z0's chunks, the factor and inverse
    rows_and_qn(a, D, INNER, NRM, XP, t, NT, ag);
    z0_pool<8>(a, D, NRM, XI, POOL, lane, ag);
    fail = factor_and_invert_block<NT>(D, TL, STG, INVD, DT, FAIL, warp, lane);
  } else {
    // ---- warp 0 factors and inverts, the others write the rows and qn; then
    // each takes z0's chunks while any are left, and all meet for the product
    if (warp == 0) {
      const int f = factor_and_invert(D, TL, STG, INVD, lane);
      if (lane == 0) *FAIL = f;
    } else {
      rows_and_qn(a, D, INNER, NRM, XP, t - 32, kThreads - 32, ag);
    }
    z0_pool<4>(a, D, NRM, XI, POOL, lane, ag);
    join_all();
    fail = *FAIL;
  }
  if (fail) {
    float* kinv = a.Kinv + ag * D.dk * D.dk;
    for (int i = t; i < D.dk * D.dk; i += NT) kinv[i] = __int_as_float(0x7fc00000);
  } else {
    product(a, D, TL, INVD, warp, NT / 32, lane, ag);
  }
  if (t == 0) a.info[ag] = fail;
}

// The opt-in shared memory a block may take on the current device, bytes.
size_t smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 48 * 1024;
  return (size_t)bytes;
}

// The tiles in the agent's workspace where they do not fit in shared memory.
bool global_tiles(const Dims& D) { return smem_bytes(D, false) > smem_limit(); }

// The resident blocks an SM the shape's build is built for (see kSmallTiles,
// kGlobalBlocks).
int min_blocks(const Dims& D) {
  return global_tiles(D) ? kGlobalBlocks : D.nT <= kSmallTiles ? 8 : 4;
}

// The build for this shape, its threads and its shared memory.
using Kernel = void (*)(PrepArgs);
Kernel kernel_for(const Dims& D) {
  if (global_tiles(D)) return qp_prepare_kernel<kGlobalBlocks, true>;
  return min_blocks(D) == 8 ? qp_prepare_kernel<8, false> : qp_prepare_kernel<4, false>;
}

int block_threads(const Dims& D) { return global_tiles(D) ? kGlobalThreads : kThreads; }

size_t block_smem(const Dims& D) { return smem_bytes(D, global_tiles(D)); }

}  // namespace

// sizeof(PrepArgs), for the wrapper's check of its mirror of the layout.
extern "C" long long qp_prepare_args_size() { return sizeof(PrepArgs); }

// Doubles of the workspace one agent's tiles take in global memory (0: the
// tiles fit in shared memory and no workspace is read).
extern "C" long long qp_prepare_work_doubles(int dim, int O, int M, int N, int K) {
  const Dims D = make_dims(dim, O, M, N, K, 0);
  return global_tiles(D) ? 64LL * D.n_tiles : 0;
}

// The build that takes the shape: its blocks an SM (qp_prepare_kernel's first
// template argument: 8, 4, or kGlobalBlocks); qp_prepare_work_doubles tells
// the global build.
extern "C" int qp_prepare_build(int dim, int O, int M, int N, int K) {
  return min_blocks(make_dims(dim, O, M, N, K, 0));
}

// Dynamic shared memory of one block, in bytes.
extern "C" long long qp_prepare_smem_bytes(int dim, int O, int M, int N, int K) {
  return (long long)block_smem(make_dims(dim, O, M, N, K, 0));
}

// Resident blocks (agents) per SM for this shape; negative: minus the CUDA error.
extern "C" int qp_prepare_blocks_per_sm(int dim, int O, int M, int N, int K) {
  const Dims D = make_dims(dim, O, M, N, K, 0);
  const size_t smem = block_smem(D);
  const Kernel k = kernel_for(D);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, block_threads(D), smem);
  return err == cudaSuccess ? n : -(int)err;
}

// Queues the preparation of the agents of `args` (a PrepArgs) on `stream`, one
// block per agent. Returns the CUDA error code (0 on success; -1 for a shape
// the kernel does not take, or the global build without its workspace). No
// synchronisation. (The struct is passed as void*: a parameter of a type in
// the anonymous namespace would give the entry internal linkage.)
extern "C" int qp_prepare_launch(const void* args, void* stream) {
  const PrepArgs& a = *static_cast<const PrepArgs*>(args);
  const Dims D = make_dims(a.dim, a.O, a.M, a.N, a.K, a.R_stat);
  if (a.A < 1 || a.dim < 1 || a.dim > kMaxDim || a.K < 1 || a.O < 1 || a.phi != kPhi ||
      D.n < 2 || a.M < 1 || (global_tiles(D) && !a.work))
    return -1;
  const size_t smem = block_smem(D);
  const Kernel k = kernel_for(D);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k<<<a.A, block_threads(D), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
