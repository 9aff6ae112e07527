// Three stages of the fleet planning step, for NVIDIA Hopper (sm_90a), each
// one launch that equals its plain torch body in
// lsc_dr_planner_tpu_torch/planner/stages.py bit for bit. None replaces a
// Pallas kernel: the JAX package ran these stages as XLA fusions inside its
// one jitted step; the port ran them as ~125 small torch kernels a step, each
// issued by the host (~25-30 us apiece on the card's host) while the device
// waited, whatever the fleet's size. Every kernel runs one agent a block of
// 128 threads (4 warps): at <= 64 registers 8 blocks fit an SM, so the main
// path's 1,024 agents are all resident at once on the H100's 132 SMs.
//
// - select_nearest, the neighbour selection (stages.neighbor_slots; the JAX
//   package's lsc_dr_planner_tpu/planner/pipeline.py:226-252, lax.top_k at
//   :247): each agent's OA nearest other agents of its scenario by
//   L-infinity distance, out-of-range ones and the agent itself at 1e9,
//   nearest first and the lower index first among ties; valid where the
//   distance is below 1e8. Keys are distance bits << 32 | index (distances
//   are never negative, so the integer order is (distance, index) order and
//   every key is unique): the arithmetic is a subtraction, abs, max and a
//   compare, so the result is exact, ties included. The scenario's positions
//   are staged in shared memory a tile of 128*K at a time (16-B cp.async);
//   thread t takes candidates t, t + 128, ..., sorts each tile's K keys with
//   a bitonic network and merges them into its ascending list of the K
//   smallest (K = 8 while a thread has at most 8 candidates, A <= 1,024;
//   else 16 or 32, at least min(OA, candidates a thread)). Each warp then
//   takes its lanes' OA smallest, a round a key: two redux.sync minima (the
//   keys' high and low words) over the lanes' heads, the winner popping to
//   its next key, already in a register while the one after it loads from
//   shared memory; the four warps' ascending lists are merged by rank (a
//   key's index in its list plus the keys below it in the other three, a
//   binary search each). Run alone (neighbor_slots_launch) or as the first
//   phase of the prediction kernel (step_front_launch with select on).
//   Bound: the plain body's [S, A, A] matrix is gone; it reads S*A*12 bytes
//   and writes S*A*OA*9, and its least work is S*A*A candidate tests of 9
//   operations (0.14 us at the main path's A = 1,024). Its time is the
//   block's chain: the tile's loads, a sort of 8, OA rounds of two
//   reductions (about half of it; a round that settles ties by a ballot,
//   and a cut-off at a bound from the first OA/4 rounds, measured slower).
// - step_front_launch (stages.step_front, and with select on
//   stages.front_with_neighbors; pipeline.py:292-445 of the JAX package,
//   ops/trajectory.py:22, 83, 99). Stage 1, the obstacle prediction, and
//   stage 2, the initial trajectory: each slot's source read through `order`
//   (or the block's own selection) from the fleet's own arrays, or from a
//   gathered NeighborData; the previous solution shifted by a segment or
//   re-parameterised by the DLSC sub-step, constant velocity where there is
//   none (RSFC always), the position (BVC), the disturbance reset, the
//   dynamic obstacles of the agent's scenario after the agent slots, the
//   single-agent padding slot, the size prediction where the mode reads it;
//   the agent's own prediction, held where it is disturbed. The LSC family's
//   source rows (M*N*3 floats each, 720 B on the main path) and the agent's
//   own are staged in shared memory by 16-B cp.async from all four warps,
//   while the threads write the slots' attributes a (slot, field) each; the
//   reset reads each row's first point from there; then every output is
//   written four floats a thread with 16-B stores (one agent's obs_pred is
//   O*M*N*3 contiguous floats), each from shared memory: four floats of a
//   shifted row at once, or element by element the sub-step's sum or
//   position + velocity * the point's time from a table (element r is
//   point r / 3, axis r % 3). N (n + 1) is a template argument (6, or any
//   at run time: the sub-step's sum unrolls); the front reads no world
//   dimension (every slot is predicted on all three axes). Bound:
//   bytes. At A = 1,024, O = 16, M = 10, N = 6 it moves 14.1 MB (obs_pred
//   11.8 MB written), 4.2 us at 3.35 TB/s; the sources it gathers are each
//   agent's 720 B of points, 0.7 MB read once, L2-resident.
// - the wide builds (neighbor_slots_wide_kernel, step_front_wide_kernel),
//   for every shape past the narrow builds above (OA > 32 with a selection,
//   O > 64, or rows past shared memory; the reference caps no neighbour
//   set): select_wide, a radix select of the OA-th smallest distance over
//   the block (four passes of 8 bits, a shared histogram each), the keys
//   below it and the lowest indices at it placed in index order by ballot
//   counts, and a bitonic sort of the OA keys in shared memory: exact as
//   select_nearest; the prediction's slot tables in dynamic shared memory
//   sized by O, and the source rows staged a chunk of slots at a time (as
//   many as 64 KB hold), each chunk's reset and outputs done before the
//   next is staged. Outputs bit for bit the plain bodies', as the narrow
//   builds'. Their limits are shared memory's: the tables ~46 B a slot
//   and one chunk's rows (O up to ~4,000 slots at M = 10), the sort's keys
//   8 B an agent slot (OA up to ~27,000).
// - goal_qp_inputs_launch (stages.goal_qp_inputs; planner/goal.py:26-122 and
//   pipeline.py:566-690 of the JAX package). Stage 5: the goal of every goal
//   mode (the closed-form goal LP over the O last-point LSC rows and the six
//   SFC faces, the right-hand detour with its deadlock test, the host's goal,
//   the static goal) and the disturbed agents' hold; and the QP-input assembly
//   of stage 6: the terminal segments, the LSC rows' right-hand sides with the
//   QP margin and their activity (segment 0's first phi points off), the
//   variable bounds (the world, the SFC boxes and the waypoint comm box on the
//   segment ends), the comm half-range and the masked warm start. One block of
//   128 threads an agent: warp 0 solves the goal LP, a lane a row and a warp
//   maximum (max and min are exact, so any order serves), then all threads
//   write the rows, bounds and duals. Bound: bytes, 35.2 MB at the main
//   path's call (the anchors 11.8 MB, the warm start's duals 5.6 MB in and 5.6
//   MB out, the margins and rows 3.9 MB each), 10.5 us at 3.35 TB/s.
//
// Times on the card, beside their bounds and the plain bodies': PERF.md
// section 6 (chip_smoke.py's stage_timing and stage_timing_main).
//
// Rounding: every float operation is the plain body's, in its order, each
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn keep nvcc
// from contracting a*b + c into a fused multiply-add; torch runs each op as
// its own kernel and never fuses); sums over coordinates and Bezier points run
// left to right (geometry._dotn, trajectory.subsegment_first); norms are the
// float64 square root of the float32 sum (geometry._norm); the detour's cross
// product rounds as geometry._cross; the Python scalars arrive as the float32
// torch rounds them to (stages.stage_scalars).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kBlockThreads = 128;  // every stage kernel: one agent a block of 4 warps
constexpr int kWarps = kBlockThreads / 32;
constexpr int kMaxSlots = 64;       // O, the obstacle slots an agent
constexpr int kMaxAgentSlots = 32;  // OA: a warp's lanes hold its nearest keys
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use (227 KB)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-6f;      // goal.py's _EPS, the rows' activity threshold
typedef unsigned long long u64;

enum Mode { kLsc = 0, kBvc = 1, kRsfc = 2 };
enum Goal { kGoalLp = 0, kGoalRightHand = 1, kGoalHost = 2, kGoalStatic = 3 };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// geometry._dotn: (a0*b0 + a1*b1) [+ a2*b2]
__device__ __forceinline__ float dotn(const float* a, const float* b, int d) {
  float s = add(mul(a[0], b[0]), mul(a[1], b[1]));
  if (d > 2) s = add(s, mul(a[2], b[2]));
  return s;
}

// geometry._norm: the float64 square root of the float32 sum of squares
__device__ __forceinline__ float norm64(const float* x, int d) {
  return __double2float_rn(__dsqrt_rn(static_cast<double>(dotn(x, x, d))));
}

// geometry._cross's component a*b - c*d: the second product rounded to
// float32, the difference in float64, then rounded once
__device__ __forceinline__ float fms(float a, float b, float c, float d) {
  return __double2float_rn(__dsub_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                                     static_cast<double>(mul(c, d))));
}

// ---------------------------------------------------------------------------
// shared-memory staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(s)), "l"(g));
}

// the same, kept in L1 too: the blocks of an SM read one scenario's positions
__device__ __forceinline__ void cp_async16_l1(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(s)), "l"(g));
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(s)), "l"(g));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// queue the copy of n floats from g to s by `threads` threads (this one
// `rank` among them): 16 B a copy where both ends are 16-B aligned (`l1`:
// cached in L1 as well), else 4; complete after cp_async_wait_all and a
// barrier
template <bool l1 = false>
__device__ __forceinline__ void stage_floats(float* s, const float* g, int n, int rank,
                                             int threads) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(g) | smem_addr(s)) & 15) == 0) {
    const int n4 = n >> 2;
    for (int e = rank; e < n4; e += threads) {
      if (l1) cp_async16_l1(s + 4 * e, g + 4 * e);
      else cp_async16(s + 4 * e, g + 4 * e);
    }
    done = 4 * n4;
  }
  for (int e = done + rank; e < n; e += threads) cp_async4(s + e, g + e);
}

// out[0, total) of this agent, rows of `span` floats, four consecutive
// floats a thread (value(row, r) the element at column r of a row; run(row,
// r, v) may fill v with the four from (row, r) at once where they lie in
// one row, and says whether it did): one 16-B store where `out` is 16-B
// aligned, else four
template <class F, class G>
__device__ __forceinline__ void store_runs(float* __restrict__ out, int total, int span,
                                           F value, G run) {
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  int f = 4 * threadIdx.x, row = f / span, r = f - row * span;
  for (; f < total; f += 4 * kBlockThreads) {
    float v[4];
    if (!(f + 4 <= total && r + 4 <= span && run(row, r, v))) {
      int ro = row, rr = r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = f + q < total ? value(ro, rr) : 0.0f;
        if (++rr == span) {
          rr = 0;
          ++ro;
        }
      }
    }
    if (vec && f + 4 <= total) {
      *reinterpret_cast<float4*>(out + f) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int q = 0; q < 4 && f + q < total; ++q) out[f + q] = v[q];
    }
    r += 4 * kBlockThreads;
    while (r >= span) {
      r -= span;
      ++row;
    }
  }
}

// ---------------------------------------------------------------------------
// neighbour selection
// ---------------------------------------------------------------------------

// a <= b afterwards
__device__ __forceinline__ void cex(u64& a, u64& b) {
  const u64 lo = a < b ? a : b, hi = a < b ? b : a;
  a = lo;
  b = hi;
}

// b ascending: a bitonic sorting network, every index a constant
template <int K>
__device__ __forceinline__ void sort_keys(u64 (&b)[K]) {
#pragma unroll
  for (int size = 2; size <= K; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          if ((i & size) == 0) cex(b[i], b[j]);
          else cex(b[j], b[i]);
        }
      }
    }
  }
}

// b (ascending) <- the K smallest of b and c (both ascending): the
// elementwise minimum of b and reversed c is bitonic and holds them; then
// the half-cleaners sort it
template <int K>
__device__ __forceinline__ void merge_low(u64 (&b)[K], const u64 (&c)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) b[i] = b[i] < c[K - 1 - i] ? b[i] : c[K - 1 - i];
#pragma unroll
  for (int stride = K >> 1; stride > 0; stride >>= 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int j = i ^ stride;
      if (j > i) cex(b[i], b[j]);
    }
  }
}

// the K of the list a thread keeps: the least of 8, 16, 32 that holds
// min(OA, its candidates), so that its list keeps every key of the OA
// nearest it scans
__host__ __device__ inline int list_len(int A, int OA) {
  const int c = (A + kBlockThreads - 1) / kBlockThreads;
  const int need = OA < c ? OA : c;
  return need <= 8 ? 8 : need <= 16 ? 16 : 32;
}

// floats of shared memory select_nearest<K> takes: the positions of a tile
// (its lists past their first two keys reuse them)
__host__ __device__ constexpr int select_floats(int K) { return 3 * kBlockThreads * K; }

// The OA nearest keys of agent i among the A positions p [A, 3] (its
// scenario's), ascending, into s_key[0, OA), by the whole block; s_u:
// select_floats(K) floats of 16-B aligned shared memory. Needs 1 <= OA <=
// 32 and OA < A. Ends with a barrier.
template <int K>
__device__ void select_nearest(const float* __restrict__ p, int A, int i, int OA, float range,
                               bool use_range, float* s_u, u64* s_top, u64* s_key) {
  constexpr int kTile = kBlockThreads * K;  // candidates a tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float px = __ldg(p + 3 * i), py = __ldg(p + 3 * i + 1), pz = __ldg(p + 3 * i + 2);
  u64 best[K];
  for (int t0 = 0; t0 < A; t0 += kTile) {
    const int n = A - t0 < kTile ? A - t0 : kTile;
    if (t0 > 0) __syncthreads();  // every thread is done with the last tile
    stage_floats<true>(s_u, p + 3LL * t0, 3 * n, tid, kBlockThreads);
    cp_async_wait_all();
    __syncthreads();
    u64 c[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int jl = tid + k * kBlockThreads;
      u64 key = ~0ull;
      if (jl < n) {
        const int j = t0 + jl;
        const float* q = s_u + 3 * jl;
        float d = fmaxf(fmaxf(fabsf(sub(px, q[0])), fabsf(sub(py, q[1]))), fabsf(sub(pz, q[2])));
        if (j == i) d = add(d, 1e9f);  // dist + eye * 1e9 (+0 elsewhere)
        if (use_range && !(d < range)) d = 1e9f;
        key = (static_cast<u64>(__float_as_uint(d)) << 32) | static_cast<unsigned>(j);
      }
      c[k] = key;
    }
    sort_keys<K>(c);
    if (t0 == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) best[k] = c[k];
    } else {
      merge_low<K>(best, c);
    }
  }
  // the lists past their first two keys in shared memory, key k of thread
  // t at s_list[k * 128 + t] (over the positions)
  __syncthreads();
  u64* s_list = reinterpret_cast<u64*>(s_u);
#pragma unroll
  for (int k = 2; k < K; ++k) s_list[k * kBlockThreads + tid] = best[k];
  // the warp's OA smallest, one a round: the least head by its high word
  // (the distance), then by its low word (the index) among the lanes that
  // hold that high word; the one lane that holds it pops (keys are unique;
  // an exhausted list holds ~0, which only an exhausted warp takes), its
  // next key already in a register and the one after it loading meanwhile
  u64 head = best[0], next = best[1], mine = ~0ull;
  int h = 1;
  for (int r = 0; r < OA; ++r) {
    const unsigned hi = static_cast<unsigned>(head >> 32), lo = static_cast<unsigned>(head);
    const unsigned mhi = __reduce_min_sync(kFull, hi);
    const unsigned mlo = __reduce_min_sync(kFull, hi == mhi ? lo : kFull);
    if (lane == r) mine = (static_cast<u64>(mhi) << 32) | mlo;  // lane r keeps round r's key
    if (hi == mhi && lo == mlo) {
      head = next;
      ++h;
      next = h < K ? s_list[h * kBlockThreads + tid] : ~0ull;
    }
  }
  s_top[warp * 32 + lane] = mine;  // ~0 past OA
  __syncthreads();
  // the four ascending rows merged by rank: a real key among the OA
  // smallest lies in its warp's row with every smaller key of the others;
  // its rank is its index plus their keys below it
  if (lane < OA) {
    int rank = lane;
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const u64* other = s_top + ((warp + w) % kWarps) * 32;
      int at = 0;
#pragma unroll
      for (int step = 16; step; step >>= 1)
        if (other[at + step - 1] < mine) at += step;
      rank += at + (other[at] < mine);
    }
    if (rank < OA) s_key[rank] = mine;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// neighbour selection for any OA (the wide builds)
// ---------------------------------------------------------------------------

// the sort's length for OA keys: the least power of two >= OA
__host__ __device__ inline int sort_len(int OA) {
  int P = 1;
  while (P < OA) P <<= 1;
  return P;
}

// floats of shared memory select_wide takes: the keys [sort_len(OA)] (u64),
// the digit histogram [256], the warps' ballot counts [2][2][kWarps] and the
// pass's digit and rank
__host__ __device__ inline int select_wide_floats(int OA) {
  return 2 * sort_len(OA) + 256 + 4 * kWarps + 4;
}

// The OA nearest keys of agent i among the A positions p [A, 3] (its
// scenario's), ascending, into s_key[0, OA), by the whole block: a radix
// select of the OA-th smallest distance (four passes of 8 bits over the
// distance bits, a shared histogram each; integer counts, so the result does
// not depend on the order of the atomics), then the keys below it and the
// lowest indices at it, placed by block-wide ballot counts in index order,
// then a bitonic sort of the OA keys in shared memory. Exact as
// select_nearest: the same keys, the same order. s_u: select_wide_floats(OA)
// floats of 16-B aligned shared memory (s_key is its start). Needs 1 <= OA <
// A. Ends with a barrier.
__device__ void select_wide(const float* __restrict__ p, int A, int i, int OA, float range,
                            bool use_range, float* s_u) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = sort_len(OA);
  u64* s_key = reinterpret_cast<u64*>(s_u);
  unsigned* s_hist = reinterpret_cast<unsigned*>(s_key + P);
  int* s_cnt = reinterpret_cast<int*>(s_hist + 256);  // [2][2][kWarps]
  int* s_ctl = s_cnt + 4 * kWarps;                    // the pass's digit and rank
  const float px = __ldg(p + 3 * i), py = __ldg(p + 3 * i + 1), pz = __ldg(p + 3 * i + 2);
  auto bits_of = [&](int j) -> unsigned {
    const float* q = p + 3 * j;
    float d = fmaxf(fmaxf(fabsf(sub(px, __ldg(q))), fabsf(sub(py, __ldg(q + 1)))),
                    fabsf(sub(pz, __ldg(q + 2))));
    if (j == i) d = add(d, 1e9f);  // dist + eye * 1e9 (+0 elsewhere)
    if (use_range && !(d < range)) d = 1e9f;
    return __float_as_uint(d);
  };

  // the distance bits of the OA-th smallest key, 8 bits a pass; `need`: its
  // rank among the keys of its distance (distances are never negative, so
  // their bits order as unsigned integers)
  unsigned prefix = 0, mask = 0;
  int need = OA;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += kBlockThreads) s_hist[b] = 0;
    __syncthreads();
    for (int j = tid; j < A; j += kBlockThreads) {
      const unsigned b = bits_of(j);
      if ((b & mask) == prefix) atomicAdd(s_hist + ((b >> shift) & 255), 1u);
    }
    __syncthreads();
    if (warp == 0) {  // the digit whose bins hold the need-th key: a lane 8 bins
      unsigned c[8], sum = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += c[k] = s_hist[8 * lane + k];
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned up = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += up;
      }
      unsigned below = incl - sum;
      if (below < static_cast<unsigned>(need) && static_cast<unsigned>(need) <= incl) {
        int k = 0;
        while (below + c[k] < static_cast<unsigned>(need)) below += c[k++];
        s_ctl[0] = 8 * lane + k;
        s_ctl[1] = need - static_cast<int>(below);
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(s_ctl[0]) << shift;
    mask |= 255u << shift;
    need = s_ctl[1];
  }

  // the keys below that distance (OA - need of them) and the `need` lowest
  // indices at it, a tile of 128 candidates at a time in index order: a
  // key's place is its rank among the tile's by ballots, plus the counts of
  // the tiles before (s_cnt double-buffered: one barrier a tile)
  const unsigned lt = (1u << lane) - 1;
  int n_less = 0, n_tie = 0;
  for (int t0 = 0, buf = 0; t0 < A; t0 += kBlockThreads, buf ^= 1) {
    const int j = t0 + tid;
    const unsigned b = j < A ? bits_of(j) : ~0u;
    const bool less = b < prefix, tie = b == prefix;
    const unsigned bl = __ballot_sync(kFull, less), bt = __ballot_sync(kFull, tie);
    int* cnt = s_cnt + buf * 2 * kWarps;
    if (lane == 0) {
      cnt[warp] = __popc(bl);
      cnt[kWarps + warp] = __popc(bt);
    }
    __syncthreads();
    int less_at = n_less + __popc(bl & lt), tie_at = n_tie + __popc(bt & lt);
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) {
        less_at += cnt[w];
        tie_at += cnt[kWarps + w];
      }
      n_less += cnt[w];
      n_tie += cnt[kWarps + w];
    }
    const u64 key = (static_cast<u64>(b) << 32) | static_cast<unsigned>(j);
    if (less) s_key[less_at] = key;
    else if (tie && tie_at < need) s_key[OA - need + tie_at] = key;
    if (n_less == OA - need && n_tie >= need) break;  // every thread alike
  }
  for (int e = OA + tid; e < P; e += kBlockThreads) s_key[e] = ~0ull;
  __syncthreads();
  // ascending: a bitonic sort of the P keys, a pair a thread a step
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int e = tid; e < P / 2; e += kBlockThreads) {
        const int lo = 2 * stride * (e / stride) + (e % stride), hi = lo + stride;
        const u64 x = s_key[lo], y = s_key[hi];
        if ((x > y) == ((lo & size) == 0)) {
          s_key[lo] = y;
          s_key[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// key -> (order into the flattened fleet, valid)
__device__ __forceinline__ long long key_row(u64 key, long long first) {
  return static_cast<long long>(key & 0xffffffffull) + first;
}
__device__ __forceinline__ bool key_valid(u64 key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32)) < 1e8f;
}

template <int K>
__global__ void __launch_bounds__(kBlockThreads, K > 8 ? 4 : 8)
neighbor_slots_kernel(const float* __restrict__ pos, int A, int OA, float range, int use_range,
                      long long* __restrict__ order, bool* __restrict__ valid) {
  extern __shared__ float4 smem4[];
  __shared__ u64 s_top[kWarps * 32];
  __shared__ u64 s_key[kMaxAgentSlots];
  const long long agent = blockIdx.x;
  const int s = static_cast<int>(agent / A), i = static_cast<int>(agent - static_cast<long long>(s) * A);
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(s) * A;
  select_nearest<K>(pos + first * 3, A, i, OA, range, use_range != 0,
                    reinterpret_cast<float*>(smem4), s_top, s_key);
  if (tid < OA) {
    const u64 key = s_key[tid];
    order[agent * OA + tid] = key_row(key, first);
    valid[agent * OA + tid] = key_valid(key);
  }
}

// the wide build: select_wide, any OA < A
__global__ void __launch_bounds__(kBlockThreads, 8)
neighbor_slots_wide_kernel(const float* __restrict__ pos, int A, int OA, float range,
                           int use_range, long long* __restrict__ order,
                           bool* __restrict__ valid) {
  extern __shared__ float4 smem4[];
  const long long agent = blockIdx.x;
  const int s = static_cast<int>(agent / A), i = static_cast<int>(agent - static_cast<long long>(s) * A);
  const long long first = static_cast<long long>(s) * A;
  select_wide(pos + first * 3, A, i, OA, range, use_range != 0, reinterpret_cast<float*>(smem4));
  const u64* s_key = reinterpret_cast<const u64*>(smem4);
  for (int o = threadIdx.x; o < OA; o += kBlockThreads) {
    const u64 key = s_key[o];
    order[agent * OA + o] = key_row(key, first);
    valid[agent * OA + o] = key_valid(key);
  }
}

// ---------------------------------------------------------------------------
// stages 1 and 2
// ---------------------------------------------------------------------------

// the pointers of step_front_launch, in the wrapper's order (ops/step_cuda.py)
struct FrontPtrs {
  const long long* order;  // [A, OA] source rows (null: row a*OA + o of the sources)
  const bool* slot_valid;  // [A, OA]
  const float* src_prev;   // [rows, M, N, 3]
  const bool* src_has_prev;
  const float* src_pos;    // [rows, 3] (with select: the fleet's, [S*A, 3])
  const float* src_vel;
  const float* src_radius;  // [rows]
  const float* src_downwash;
  const float* src_goal;   // [rows, 3]
  const float* prev;       // [A, M, N, 3] the agents' own
  const bool* has_prev;
  const float* pos;        // [A, 3]
  const float* vel;
  const bool* disturbed;
  const float* max_acc;    // [A, 3] (column 0)
  const float* dyn_pos;    // [S*OD, 3]
  const float* dyn_vel;
  const float* dyn_radius;  // [S*OD]
  const float* dyn_downwash;
  const float* dyn_max_acc;
  const bool* dyn_valid;
  const float* growth;     // [M, N]
  const float* sub;        // [N, N] (null: shift one segment)
  float* obs_pred;         // [A, O, M, N, 3]
  bool* obs_valid;         // [A, O]
  bool* obs_is_agent;
  float* obs_radius;
  float* obs_downwash;
  float* obs_max_acc;
  float* obs_pos_now;      // [A, O, 3]
  float* obs_goal;
  float* initial;          // [A, M, N, 3]
  float* sizes;            // [A, O, M, N] (null: not written)
  long long* order_out;    // [A, OA] with select (else null)
  bool* valid_out;
};

struct FrontArgs {
  FrontPtrs p;
  int A, S, O, OA, OD, M, n, mode, size_growth, use_guard, select, use_range;
  float dt, reset, guard, range;
  int chunk;  // the wide builds' slots staged at once (front_wide_smem)
};

// the dynamic shared memory of step_front_kernel, in floats: the points'
// times [M*N] at 0, the sub-step matrix [N*N] at `sub`, and at `u` the
// selection's tile or, after it, the LSC family's OA + 1 rows (the slots'
// sources, then the agent's own)
struct FrontSmem {
  int sub, u, floats;
};

__host__ __device__ inline FrontSmem front_smem(int M, int N, int OA, int mode, int K, bool select) {
  FrontSmem s;
  s.sub = (M * N + 3) & ~3;
  s.u = s.sub + ((N * N + 3) & ~3);
  const int rows = mode == kLsc ? (OA + 1) * M * N * 3 : 0;
  const int sel = select ? select_floats(K) : 0;
  s.floats = s.u + (rows > sel ? rows : sel);
  return s;
}

// the wide builds' dynamic shared memory, in floats (each part 16-B aligned):
// the points' times [M*N] at 0, the sub-step matrix [N*N], the slot tables
// sized by O (the narrow builds' static arrays), and at `u` the selection's
// keys or, after it, `chunk` slots' LSC rows at a time
struct WideSmem {
  int sub, src, valid, kind, p, v, radius, max_acc, is_agent, u, floats, chunk;
};

constexpr int kWideRowBytes = 64 * 1024;  // the wide builds' staged rows at most

__host__ __device__ inline int r4(int f) { return (f + 3) & ~3; }

// chunk: slots whose rows are staged at once (0: as many as kWideRowBytes
// and `limit` bytes of shared memory allow, at most O + 1, at least 1)
__host__ __device__ inline WideSmem front_wide_smem(int M, int N, int O, int OA, int mode,
                                                    bool select, int chunk, int limit) {
  WideSmem s;
  s.sub = r4(M * N);
  s.src = s.sub + r4(N * N);
  s.valid = s.src + r4(2 * O);  // long long [O]
  s.kind = s.valid + r4((O + 3) / 4);  // bool [O]
  s.p = s.kind + r4(O + 1);
  s.v = s.p + r4(3 * (O + 1));
  s.radius = s.v + r4(3 * (O + 1));
  s.max_acc = s.radius + r4(O);
  s.is_agent = s.max_acc + r4(O);
  s.u = s.is_agent + r4((O + 3) / 4);
  const int sel = select && OA > 0 ? select_wide_floats(OA) : 0;
  const int MN3 = M * N * 3;
  if (mode != kLsc) {
    s.chunk = O + 1;
  } else if (chunk == 0) {
    const int room = limit / 4 - s.u, cap = kWideRowBytes / 4;
    s.chunk = (room < cap ? room : cap) / MN3;
    if (s.chunk > O + 1) s.chunk = O + 1;
    if (s.chunk < 1) s.chunk = 1;
  } else {
    s.chunk = chunk;
  }
  const int rows = mode == kLsc ? s.chunk * MN3 : 0;
  s.floats = s.u + (rows > sel ? rows : sel);
  return s;
}

// trajectory.const_vel_ctrl's time of point (m, i): (m + i/n)*dt
__device__ __forceinline__ float cv_time(int m, int i, int n, float dt) {
  return mul(add(static_cast<float>(m), div(static_cast<float>(i), static_cast<float>(n))), dt);
}

// a slot's prediction: from its row (the LSC family's shift or sub-step),
// position + velocity * time (constant velocity; velocity 0: the position,
// BVC's and the reset's hold), or 0 (the padding slot)
enum Kind { kRow = 0, kCv = 1, kPad = 2 };

// element r = (m*N + i)*3 + d of the prediction from the source's row: the
// row shifted one segment, the last point held; or (sub) segment 0
// re-parameterised, sum_k S[k, i] * c_k left to right, the rest as it is
// (r < 3N: segment 0, point i = r / 3)
template <int NT>
__device__ __forceinline__ float row_value(const float* __restrict__ row,
                                           const float* __restrict__ s_sub, bool substep, int N,
                                           int MN3, int r, int d) {
  if (!substep) return r < MN3 - 3 * N ? row[r + 3 * N] : row[MN3 - 3 + d];
  if (r >= 3 * N) return row[r];
  const int i = r / 3;
  float acc = mul(s_sub[i], row[d]);
#pragma unroll
  for (int k = 1; k < (NT ? NT : N); ++k) acc = add(acc, mul(s_sub[k * N + i], row[3 * k + d]));
  return acc;
}

template <int NT, int K, bool kSelect>
__global__ void __launch_bounds__(kBlockThreads, K > 8 ? 4 : 8) step_front_kernel(FrontArgs a) {
  const FrontPtrs& P = a.p;
  const int ag = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int O = a.O, OA = a.OA, M = a.M, N = NT ? NT : a.n + 1;
  const int N3 = 3 * N, MN3 = M * N3;
  const int per = a.A / a.S, s = ag / per;
  const bool substep = P.sub != nullptr, rows = a.mode == kLsc;
  extern __shared__ float4 smem4[];
  float* s_t = reinterpret_cast<float*>(smem4);
  const FrontSmem L = front_smem(M, N, OA, a.mode, K, kSelect);
  float* s_sub = s_t + L.sub;
  float* s_u = s_t + L.u;
  __shared__ u64 s_top[kSelect ? kWarps * 32 : 1];
  __shared__ u64 s_key[kSelect ? kMaxAgentSlots : 1];
  __shared__ long long s_src[kMaxSlots];  // the agent slots' source rows
  __shared__ bool s_valid[kMaxSlots];
  __shared__ int s_kind[kMaxSlots + 1];  // Kind of slot o; [O] the agent's own
  __shared__ float s_p[kMaxSlots + 1][3], s_v[kMaxSlots + 1][3];
  __shared__ float s_radius[kMaxSlots], s_max_acc[kMaxSlots];
  __shared__ bool s_is_agent[kMaxSlots];

  for (int e = tid; e < M * N; e += kBlockThreads) {
    const int m = e / N;
    s_t[e] = cv_time(m, e - m * N, a.n, a.dt);
  }
  if (substep)
    for (int e = tid; e < N * N; e += kBlockThreads) s_sub[e] = P.sub[e];

  // 1. the agent slots' sources: the block's own selection, or `order`
  if constexpr (kSelect) {
    if (OA > 0) {
      const long long first = static_cast<long long>(s) * per;
      select_nearest<K>(P.src_pos + first * 3, per, ag - s * per, OA, a.range, a.use_range != 0,
                        s_u, s_top, s_key);
      if (tid < OA) {
        const u64 key = s_key[tid];
        const long long at = static_cast<long long>(ag) * OA + tid;
        s_src[tid] = P.order_out[at] = key_row(key, first);
        s_valid[tid] = P.valid_out[at] = key_valid(key);
      }
    }
  } else {
    if (tid < OA) {
      const long long at = static_cast<long long>(ag) * OA + tid;
      s_src[tid] = P.order ? P.order[at] : at;
      s_valid[tid] = P.slot_valid[at];
    }
  }
  __syncthreads();

  // 2. the rows in flight (a warp a row) while the threads decide each
  // slot's kind and write the slots' attributes
  if (rows) {
    for (int o = tid >> 5; o <= OA; o += kWarps) {
      const float* g = o < OA ? P.src_prev + s_src[o] * MN3 : P.prev + static_cast<long long>(ag) * MN3;
      stage_floats(s_u + o * MN3, g, MN3, lane, 32);
    }
  }
  for (int o = tid; o <= O; o += kBlockThreads) {
    int kind = kCv;
    float p[3] = {0.0f, 0.0f, 0.0f}, v[3] = {0.0f, 0.0f, 0.0f};
    if (o == O || o < OA) {  // the agent's own, or an agent slot
      const long long src = o == O ? ag : s_src[o];
      const float* p3 = (o == O ? P.pos : P.src_pos) + src * 3;
      const float* v3 = (o == O ? P.vel : P.src_vel) + src * 3;
      const bool hp = o == O ? P.has_prev[ag] : P.src_has_prev[src];
      for (int d = 0; d < 3; ++d) p[d] = p3[d];
      if ((o == O && P.disturbed[ag]) || a.mode == kBvc) {
        kind = kCv;  // const_vel_ctrl(pos, 0)
      } else if (a.mode == kRsfc || !hp) {
        for (int d = 0; d < 3; ++d) v[d] = v3[d];
      } else {
        kind = kRow;
      }
      if (o < O) {
        s_radius[o] = P.src_radius[src];
        s_max_acc[o] = 0.0f;
        s_is_agent[o] = true;
      }
    } else if (a.OD > 0) {  // a dynamic obstacle of the agent's scenario
      const long long di = static_cast<long long>(s) * a.OD + (o - OA);
      for (int d = 0; d < 3; ++d) {
        p[d] = P.dyn_pos[di * 3 + d];
        v[d] = P.dyn_vel[di * 3 + d];
      }
      s_radius[o] = P.dyn_radius[di];
      s_max_acc[o] = P.dyn_max_acc[di];
      s_is_agent[o] = false;
    } else {  // the single agent's padding slot
      kind = kPad;
      s_radius[o] = 0.1f;
      s_max_acc[o] = 0.0f;
      s_is_agent[o] = false;
    }
    s_kind[o] = kind;
    for (int d = 0; d < 3; ++d) {
      s_p[o][d] = p[d];
      s_v[o][d] = v[d];
    }
  }
  // the attributes, a (slot, field) a thread, one pass at O <= 18: valid,
  // is_agent, radius, downwash, max_acc, pos_now[3], goal[3]
  for (int e = tid; e < O * 7; e += kBlockThreads) {
    const int o = e / 7, f = e - o * 7;
    const long long so = static_cast<long long>(ag) * O + o;
    const bool agent = o < OA, dyn = !agent && a.OD > 0;
    const long long src = agent ? s_src[o] : dyn ? static_cast<long long>(s) * a.OD + (o - OA) : 0;
    switch (f) {
      case 0: P.obs_valid[so] = agent ? s_valid[o] : dyn && P.dyn_valid[src]; break;
      case 1: P.obs_is_agent[so] = agent; break;
      case 2: P.obs_radius[so] = agent ? P.src_radius[src] : dyn ? P.dyn_radius[src] : 0.1f; break;
      case 3:
        P.obs_downwash[so] = agent ? P.src_downwash[src] : dyn ? P.dyn_downwash[src] : 1.0f;
        break;
      case 4: P.obs_max_acc[so] = dyn ? P.dyn_max_acc[src] : 0.0f; break;
      default: {  // pos_now, goal: the source's, the obstacle's position (twice), or 0
        const float* g = agent ? (f == 5 ? P.src_pos : P.src_goal) + src * 3
                               : dyn ? P.dyn_pos + src * 3 : nullptr;
        float* out = (f == 5 ? P.obs_pos_now : P.obs_goal) + so * 3;
        const float x = g ? g[0] : 0.0f, y = g ? g[1] : 0.0f, z = g ? g[2] : 0.0f;
        out[0] = x;
        out[1] = y;
        out[2] = z;
      }
    }
  }
  if (rows) cp_async_wait_all();
  __syncthreads();

  // 3. the disturbance reset: a slot whose predicted first point is off its
  // observed position by more than `reset` holds the position
  if (tid < OA && s_kind[tid] == kRow) {
    const float* row = s_u + tid * MN3;
    float e[3];
    for (int d = 0; d < 3; ++d)
      e[d] = sub(row_value<NT>(row, s_sub, substep, N, MN3, d, d), s_p[tid][d]);
    if (norm64(e, 3) > a.reset) {
      s_kind[tid] = kCv;
      for (int d = 0; d < 3; ++d) s_v[tid][d] = 0.0f;
    }
  }
  __syncthreads();

  // 4. the outputs, four floats a thread: element r = 3*(m*N + i) + d of a
  // slot's prediction
  auto pred = [&](int o, int r) -> float {
    const int q = r / 3, d = r - 3 * q;
    switch (s_kind[o]) {
      case kRow:
        return row_value<NT>(s_u + (o == O ? OA : o) * MN3, s_sub, substep, N, MN3, r, d);
      case kCv:
        return add(s_p[o][d], mul(s_v[o][d], s_t[q]));
      default:
        return 0.0f;
    }
  };
  // the shift's runs: four floats of a row, one segment on
  auto shifted = [&](int o, int r, float (&v)[4]) {
    if (substep || s_kind[o] != kRow || r + 4 > MN3 - N3) return false;
    const float* row = s_u + (o == O ? OA : o) * MN3 + r + N3;
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = row[q];
    return true;
  };
  auto none = [](int, int, float (&)[4]) { return false; };
  store_runs(P.obs_pred + static_cast<long long>(ag) * O * MN3, O * MN3, MN3, pred, shifted);
  store_runs(P.initial + static_cast<long long>(ag) * MN3, MN3, MN3,
             [&](int, int r) { return pred(O, r); },
             [&](int, int r, float (&v)[4]) { return shifted(O, r, v); });

  // the size prediction (plain LSC and RSFC read it)
  if (P.sizes != nullptr) {
    float guard = 0.0f;
    if (a.use_guard) {
      const float* v3 = P.vel + ag * 3;
      guard = div(mul(a.guard, dotn(v3, v3, 3)), P.max_acc[ag * 3]);
    }
    const int MN = M * N;
    store_runs(P.sizes + static_cast<long long>(ag) * O * MN, O * MN, MN, [&](int o, int mi) {
      float x = s_radius[o];
      if (a.size_growth && (!s_is_agent[o] || a.mode == kRsfc))
        x = add(add(x, guard), mul(s_max_acc[o], __ldg(P.growth + mi)));
      return x;
    }, none);
  }
}

// The wide builds of stages 1 and 2 (step_front_kernel's work at any O and
// OA): the slot tables in dynamic shared memory sized by O, the block's own
// selection by select_wide, and the LSC family's source rows staged a.chunk
// slots at a time, each chunk's reset and outputs done before the next is
// staged (row o of the chunk [o0, o1) at s_u + (o - o0) * MN3; slot O the
// agent's own). The same operations as step_front_kernel, element for
// element.
template <int NT, bool kSelect>
__global__ void __launch_bounds__(kBlockThreads, 4) step_front_wide_kernel(FrontArgs a) {
  const FrontPtrs& P = a.p;
  const int ag = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int O = a.O, OA = a.OA, M = a.M, N = NT ? NT : a.n + 1;
  const int N3 = 3 * N, MN3 = M * N3;
  const int per = a.A / a.S, s = ag / per;
  const bool substep = P.sub != nullptr, rows = a.mode == kLsc;
  extern __shared__ float4 smem4[];
  float* s_t = reinterpret_cast<float*>(smem4);
  const WideSmem L = front_wide_smem(M, N, O, OA, a.mode, kSelect, a.chunk, 0);
  float* s_sub = s_t + L.sub;
  float* s_u = s_t + L.u;
  long long* s_src = reinterpret_cast<long long*>(s_t + L.src);  // the agent slots' source rows
  bool* s_valid = reinterpret_cast<bool*>(s_t + L.valid);
  int* s_kind = reinterpret_cast<int*>(s_t + L.kind);  // Kind of slot o; [O] the agent's own
  float* s_p = s_t + L.p;  // [O + 1][3]
  float* s_v = s_t + L.v;
  float* s_radius = s_t + L.radius;
  float* s_max_acc = s_t + L.max_acc;
  bool* s_is_agent = reinterpret_cast<bool*>(s_t + L.is_agent);
  const int chunk = L.chunk;

  for (int e = tid; e < M * N; e += kBlockThreads) {
    const int m = e / N;
    s_t[e] = cv_time(m, e - m * N, a.n, a.dt);
  }
  if (substep)
    for (int e = tid; e < N * N; e += kBlockThreads) s_sub[e] = P.sub[e];

  // 1. the agent slots' sources: the block's own selection, or `order`
  if constexpr (kSelect) {
    const long long first = static_cast<long long>(s) * per;
    select_wide(P.src_pos + first * 3, per, ag - s * per, OA, a.range, a.use_range != 0, s_u);
    const u64* s_key = reinterpret_cast<const u64*>(s_u);
    for (int o = tid; o < OA; o += kBlockThreads) {
      const u64 key = s_key[o];
      const long long at = static_cast<long long>(ag) * OA + o;
      s_src[o] = P.order_out[at] = key_row(key, first);
      s_valid[o] = P.valid_out[at] = key_valid(key);
    }
  } else {
    for (int o = tid; o < OA; o += kBlockThreads) {
      const long long at = static_cast<long long>(ag) * OA + o;
      s_src[o] = P.order ? P.order[at] : at;
      s_valid[o] = P.slot_valid[at];
    }
  }
  __syncthreads();

  // the rows of slots [o0, o1) in flight, a warp a row
  auto stage_rows = [&](int o0, int o1) {
    for (int o = o0 + (tid >> 5); o < o1; o += kWarps) {
      if (o >= OA && o < O) continue;  // no row: a dynamic obstacle or the padding
      const float* g = o < OA ? P.src_prev + s_src[o] * MN3 : P.prev + static_cast<long long>(ag) * MN3;
      stage_floats(s_u + (o - o0) * MN3, g, MN3, lane, 32);
    }
  };
  // 2. the first chunk's rows in flight while the threads decide each
  // slot's kind and write the slots' attributes
  if (rows) stage_rows(0, chunk < O + 1 ? chunk : O + 1);
  for (int o = tid; o <= O; o += kBlockThreads) {
    int kind = kCv;
    float p[3] = {0.0f, 0.0f, 0.0f}, v[3] = {0.0f, 0.0f, 0.0f};
    if (o == O || o < OA) {  // the agent's own, or an agent slot
      const long long src = o == O ? ag : s_src[o];
      const float* p3 = (o == O ? P.pos : P.src_pos) + src * 3;
      const float* v3 = (o == O ? P.vel : P.src_vel) + src * 3;
      const bool hp = o == O ? P.has_prev[ag] : P.src_has_prev[src];
      for (int d = 0; d < 3; ++d) p[d] = p3[d];
      if ((o == O && P.disturbed[ag]) || a.mode == kBvc) {
        kind = kCv;  // const_vel_ctrl(pos, 0)
      } else if (a.mode == kRsfc || !hp) {
        for (int d = 0; d < 3; ++d) v[d] = v3[d];
      } else {
        kind = kRow;
      }
      if (o < O) {
        s_radius[o] = P.src_radius[src];
        s_max_acc[o] = 0.0f;
        s_is_agent[o] = true;
      }
    } else if (a.OD > 0) {  // a dynamic obstacle of the agent's scenario
      const long long di = static_cast<long long>(s) * a.OD + (o - OA);
      for (int d = 0; d < 3; ++d) {
        p[d] = P.dyn_pos[di * 3 + d];
        v[d] = P.dyn_vel[di * 3 + d];
      }
      s_radius[o] = P.dyn_radius[di];
      s_max_acc[o] = P.dyn_max_acc[di];
      s_is_agent[o] = false;
    } else {  // the single agent's padding slot
      kind = kPad;
      s_radius[o] = 0.1f;
      s_max_acc[o] = 0.0f;
      s_is_agent[o] = false;
    }
    s_kind[o] = kind;
    for (int d = 0; d < 3; ++d) {
      s_p[3 * o + d] = p[d];
      s_v[3 * o + d] = v[d];
    }
  }
  // the attributes, a (slot, field) a thread: valid, is_agent, radius,
  // downwash, max_acc, pos_now[3], goal[3]
  for (int e = tid; e < O * 7; e += kBlockThreads) {
    const int o = e / 7, f = e - o * 7;
    const long long so = static_cast<long long>(ag) * O + o;
    const bool agent = o < OA, dyn = !agent && a.OD > 0;
    const long long src = agent ? s_src[o] : dyn ? static_cast<long long>(s) * a.OD + (o - OA) : 0;
    switch (f) {
      case 0: P.obs_valid[so] = agent ? s_valid[o] : dyn && P.dyn_valid[src]; break;
      case 1: P.obs_is_agent[so] = agent; break;
      case 2: P.obs_radius[so] = agent ? P.src_radius[src] : dyn ? P.dyn_radius[src] : 0.1f; break;
      case 3:
        P.obs_downwash[so] = agent ? P.src_downwash[src] : dyn ? P.dyn_downwash[src] : 1.0f;
        break;
      case 4: P.obs_max_acc[so] = dyn ? P.dyn_max_acc[src] : 0.0f; break;
      default: {  // pos_now, goal: the source's, the obstacle's position (twice), or 0
        const float* g = agent ? (f == 5 ? P.src_pos : P.src_goal) + src * 3
                               : dyn ? P.dyn_pos + src * 3 : nullptr;
        float* out = (f == 5 ? P.obs_pos_now : P.obs_goal) + so * 3;
        const float x = g ? g[0] : 0.0f, y = g ? g[1] : 0.0f, z = g ? g[2] : 0.0f;
        out[0] = x;
        out[1] = y;
        out[2] = z;
      }
    }
  }

  // 3.-4. per chunk of slots [o0, o1): the disturbance reset, a slot whose
  // predicted first point is off its observed position by more than
  // `reset` holding the position; then the outputs, four floats a thread:
  // element r = 3*(m*N + i) + d of a slot's prediction
  for (int o0 = 0; o0 <= O; o0 += chunk) {
    const int o1 = o0 + chunk < O + 1 ? o0 + chunk : O + 1;
    if (o0 > 0) {
      __syncthreads();  // the last chunk's rows are read
      if (rows) stage_rows(o0, o1);
    }
    if (rows) cp_async_wait_all();
    __syncthreads();
    const int r1 = o1 < OA ? o1 : OA;
    for (int o = o0 + tid; o < r1; o += kBlockThreads) {
      if (s_kind[o] != kRow) continue;
      const float* row = s_u + (o - o0) * MN3;
      float e[3];
      for (int d = 0; d < 3; ++d)
        e[d] = sub(row_value<NT>(row, s_sub, substep, N, MN3, d, d), s_p[3 * o + d]);
      if (norm64(e, 3) > a.reset) {
        s_kind[o] = kCv;
        for (int d = 0; d < 3; ++d) s_v[3 * o + d] = 0.0f;
      }
    }
    __syncthreads();

    auto pred = [&](int o, int r) -> float {
      const int q = r / 3, d = r - 3 * q;
      switch (s_kind[o]) {
        case kRow:
          return row_value<NT>(s_u + (o - o0) * MN3, s_sub, substep, N, MN3, r, d);
        case kCv:
          return add(s_p[3 * o + d], mul(s_v[3 * o + d], s_t[q]));
        default:
          return 0.0f;
      }
    };
    // the shift's runs: four floats of a row, one segment on
    auto shifted = [&](int o, int r, float (&v)[4]) {
      if (substep || s_kind[o] != kRow || r + 4 > MN3 - N3) return false;
      const float* row = s_u + (o - o0) * MN3 + r + N3;
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = row[q];
      return true;
    };
    const int s1 = o1 < O ? o1 : O;  // the chunk's obstacle slots [o0, s1)
    if (s1 > o0)
      store_runs(P.obs_pred + (static_cast<long long>(ag) * O + o0) * MN3, (s1 - o0) * MN3, MN3,
                 [&](int row, int r) { return pred(o0 + row, r); },
                 [&](int row, int r, float (&v)[4]) { return shifted(o0 + row, r, v); });
    if (o1 == O + 1)
      store_runs(P.initial + static_cast<long long>(ag) * MN3, MN3, MN3,
                 [&](int, int r) { return pred(O, r); },
                 [&](int, int r, float (&v)[4]) { return shifted(O, r, v); });
  }

  // the size prediction (plain LSC and RSFC read it)
  if (P.sizes != nullptr) {
    float guard = 0.0f;
    if (a.use_guard) {
      const float* v3 = P.vel + ag * 3;
      guard = div(mul(a.guard, dotn(v3, v3, 3)), P.max_acc[ag * 3]);
    }
    const int MN = M * N;
    auto none = [](int, int, float (&)[4]) { return false; };
    store_runs(P.sizes + static_cast<long long>(ag) * O * MN, O * MN, MN, [&](int o, int mi) {
      float x = s_radius[o];
      if (a.size_growth && (!s_is_agent[o] || a.mode == kRsfc))
        x = add(add(x, guard), mul(s_max_acc[o], __ldg(P.growth + mi)));
      return x;
    }, none);
  }
}

// ---------------------------------------------------------------------------
// stage 5 and the QP-input assembly
// ---------------------------------------------------------------------------

struct GoalPtrs {
  const float* pos;  // [A, 3]
  const float* vel;
  const float* current_goal;
  const float* desired_goal;
  const float* next_waypoint;
  const bool* disturbed;  // [A]
  const bool* has_prev;
  const float* nominal_velocity;  // [A]
  const float* radius;
  const float* normals;  // [A, O, M, 3]
  const float* anchors;  // [A, O, M, N, 3]
  const float* margins;  // [A, O, M, N]
  const bool* obs_valid;  // [A, O]
  const float* sfc_lo;   // [A, M, 3] world boxes (null without the map)
  const float* sfc_hi;
  const float* world_lo;  // [3]
  const float* world_hi;
  const float* y0_in;    // [A, R] (null: no warm start)
  float* new_goal;       // [A, 3]
  float* terminal_mask;  // [A, M]
  float* rhs;            // [A, O, M, N]
  bool* active;          // [A, O, M, N]
  float* lb;             // [A, dim, M, N]
  float* ub;
  float* comm_half;      // [A]
  float* y0;             // [A, R]
};

struct GoalArgs {
  GoalPtrs p;
  int A, O, M, N, dim, phi, R, goal, use_sfc, use_comm, past_seq;
  float dt, Mdt, tiny, qp_margin, comm_box, comm_half, dl_vel;
};

// goal.goal_lp for agent ag, on warp 0 (every lane returns the goal)
__device__ void goal_lp(const GoalArgs& a, int ag, int lane, float (&goal)[3]) {
  const GoalPtrs& P = a.p;
  const int d = a.dim, O = a.O, M = a.M, N = a.N;
  float w[3], gw[3];
  for (int k = 0; k < 3; ++k) {
    w[k] = P.next_waypoint[ag * 3 + k];
    gw[k] = sub(P.current_goal[ag * 3 + k], w[k]);
  }
  float lower = -INFINITY, upper = INFINITY;
  bool infeas = false;
  for (int o = lane; o < O; o += 32) {
    const long long om = (static_cast<long long>(ag) * O + o) * M + (M - 1);
    const float* nrm = P.normals + om * 3;
    const float* anc = P.anchors + (om * N + N - 1) * 3;
    const float al = dotn(nrm, gw, d);
    float diff[3];
    for (int k = 0; k < 3; ++k) diff[k] = sub(anc[k], w[k]);
    const float bl = add(P.margins[om * N + N - 1], dotn(nrm, diff, d));
    const bool vl = P.obs_valid[static_cast<long long>(ag) * O + o] && norm64(nrm, d) > kEps;
    if (vl && al > kEps) lower = fmaxf(lower, div(bl, al));
    if (vl && al < -kEps) upper = fminf(upper, div(bl, al));
    if (vl && fabsf(al) <= kEps && bl > kEps) infeas = true;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    lower = fmaxf(lower, __shfl_xor_sync(kFull, lower, off));
    upper = fminf(upper, __shfl_xor_sync(kFull, upper, off));
  }
  infeas = __any_sync(kFull, infeas);
  if (a.use_sfc) {  // the last segment's SFC faces: w + t*gw in [lo, hi]
    const long long at = (static_cast<long long>(ag) * M + M - 1) * 3;
    for (int k = 0; k < d; ++k) {
      for (int side = 0; side < 2; ++side) {
        const float as = side ? -gw[k] : gw[k];
        const float bs = side ? -sub(P.sfc_hi[at + k], w[k]) : sub(P.sfc_lo[at + k], w[k]);
        if (as > kEps) lower = fmaxf(lower, div(bs, as));
        if (as < -kEps) upper = fminf(upper, div(bs, as));
      }
    }
  }
  float t = fminf(fmaxf(lower, 0.0f), 1.0f + kEps);
  if (t > add(upper, 1e-5f) || infeas) t = 1.0f;
  for (int k = 0; k < d; ++k) goal[k] = add(mul(gw[k], t), w[k]);
  if (d == 2) goal[2] = P.current_goal[ag * 3 + 2];
}

__global__ void __launch_bounds__(kBlockThreads) goal_qp_inputs_kernel(GoalArgs a) {
  const GoalPtrs& P = a.p;
  const int ag = blockIdx.x, tid = threadIdx.x;
  const int O = a.O, M = a.M, N = a.N, dim = a.dim;
  __shared__ int s_tseg;
  const float* p3 = P.pos + ag * 3;

  if (tid < 32) {
    float goal[3];
    if (a.goal == kGoalLp) {
      goal_lp(a, ag, tid, goal);
    } else if (a.goal == kGoalRightHand) {
      const float* g = P.desired_goal + ag * 3;
      float u[3], v[3];
      for (int k = 0; k < 3; ++k) {
        u[k] = sub(p3[k], g[k]);
        v[k] = P.vel[ag * 3 + k];
      }
      const bool dl = a.past_seq && norm64(v, 3) < a.dl_vel && norm64(u, 3) > 0.2f;
      for (int k = 0; k < 3; ++k) u[k] = sub(g[k], p3[k]);
      // position + (desired - position) x (0, 0, 1), geometry._cross
      const float c[3] = {fms(u[1], 1.0f, u[2], 0.0f), fms(u[2], 0.0f, u[0], 1.0f),
                          fms(u[0], 0.0f, u[1], 0.0f)};
      for (int k = 0; k < 3; ++k) goal[k] = dl ? add(p3[k], c[k]) : g[k];
    } else {
      const float* g = (a.goal == kGoalHost ? P.current_goal : P.desired_goal) + ag * 3;
      for (int k = 0; k < 3; ++k) goal[k] = g[k];
    }
    if (P.disturbed[ag])
      for (int k = 0; k < 3; ++k) goal[k] = p3[k];
    if (tid == 0) {
      float e[3];
      for (int k = 0; k < 3; ++k) {
        P.new_goal[ag * 3 + k] = goal[k];
        e[k] = sub(goal[k], p3[k]);
      }
      // the terminal segments from the nominal-velocity flight time
      const float ift = div(norm64(e, 3), P.nominal_velocity[ag]);
      const float x = floorf(div(add(sub(a.Mdt, ift), a.tiny), a.dt));
      s_tseg = max(static_cast<int>(x), 1);
    }
  }
  __syncthreads();

  const int tseg = s_tseg;
  for (int m = tid; m < M; m += kBlockThreads)
    P.terminal_mask[ag * M + m] = m >= M - tseg ? 1.0f : 0.0f;

  // the LSC rows and their activity
  const long long row0 = static_cast<long long>(ag) * O * M * N;
  for (int e = tid; e < O * M * N; e += kBlockThreads) {
    const int o = e / (M * N), mi = e - o * M * N, m = mi / N, i = mi - m * N;
    const long long om = static_cast<long long>(ag) * O * M + o * M + m;
    const float* nrm = P.normals + om * 3;
    const float* anc = P.anchors + (row0 + e) * 3;
    P.rhs[row0 + e] = add(add(dotn(nrm, anc, dim), P.margins[row0 + e]), a.qp_margin);
    P.active[row0 + e] = P.obs_valid[static_cast<long long>(ag) * O + o] &&
                         norm64(nrm, 3) > kEps && !(m == 0 && i < a.phi);
  }

  // the variable bounds
  const long long b0 = static_cast<long long>(ag) * dim * M * N;
  for (int e = tid; e < dim * M * N; e += kBlockThreads) {
    const int k = e / (M * N), mi = e - k * M * N, m = mi / N, i = mi - m * N;
    float lo = P.world_lo[k], hi = P.world_hi[k];
    if (a.use_sfc) {
      const long long at = (static_cast<long long>(ag) * M + m) * 3 + k;
      lo = fmaxf(lo, P.sfc_lo[at]);
      hi = fminf(hi, P.sfc_hi[at]);
    }
    if (a.use_comm && i == N - 1) {
      const float wp = P.next_waypoint[ag * 3 + k];
      lo = fmaxf(lo, sub(wp, a.comm_box));
      hi = fminf(hi, add(wp, a.comm_box));
    }
    P.lb[b0 + e] = lo;
    P.ub[b0 + e] = hi;
  }
  if (tid == 0) P.comm_half[ag] = a.use_comm ? sub(a.comm_half, P.radius[ag]) : 1e19f;

  // the warm start: last step's duals where the problem continues
  if (P.y0 != nullptr) {
    const float keep = P.has_prev[ag] && !P.disturbed[ag] ? 1.0f : 0.0f;
    const long long y = static_cast<long long>(ag) * a.R;
    for (int e = tid; e < a.R; e += kBlockThreads) P.y0[y + e] = mul(P.y0_in[y + e], keep);
  }
}


}  // namespace

namespace {

// opt in to more than the default 48 KB (static and dynamic together; the
// kernels' static tables take under 8 KB)
template <class T>
cudaError_t allow_smem(T* kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (bytes <= 40 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// the wide builds' share of kMaxSmem for their dynamic part (their static
// arrays take under 0.1 KB)
constexpr int kWideLimit = kMaxSmem - 1024;

template <int K>
int neighbor_go(const float* pos, int S, int A, int OA, float range, int use_range,
                long long* order, bool* valid, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * select_floats(K);
  const cudaError_t e = allow_smem(neighbor_slots_kernel<K>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  neighbor_slots_kernel<K><<<S * A, kBlockThreads, bytes, stream>>>(pos, A, OA, range, use_range,
                                                                     order, valid);
  return static_cast<int>(cudaGetLastError());
}

int neighbor_wide_go(const float* pos, int S, int A, int OA, float range, int use_range,
                     long long* order, bool* valid, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * select_wide_floats(OA);
  const cudaError_t e = allow_smem(neighbor_slots_wide_kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  neighbor_slots_wide_kernel<<<S * A, kBlockThreads, bytes, stream>>>(pos, A, OA, range,
                                                                      use_range, order, valid);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int K, bool kSelect>
int front_go(const FrontArgs& a, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * front_smem(a.M, a.n + 1, a.OA, a.mode, K, kSelect).floats;
  const cudaError_t e = allow_smem(step_front_kernel<NT, K, kSelect>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  step_front_kernel<NT, K, kSelect><<<a.A, kBlockThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, bool kSelect>
int front_wide_go(const FrontArgs& a, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) *
      front_wide_smem(a.M, a.n + 1, a.O, a.OA, a.mode, kSelect, a.chunk, kWideLimit).floats;
  const cudaError_t e = allow_smem(step_front_wide_kernel<NT, kSelect>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  step_front_wide_kernel<NT, kSelect><<<a.A, kBlockThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the narrow builds take O <= kMaxSlots, with their own selection OA <=
// kMaxAgentSlots, and every row staged at once within kMaxSmem; the wide
// builds every other shape
__host__ inline bool front_is_wide(int A, int S, int O, int OA, int M, int n, int mode,
                                   bool select) {
  if (O > kMaxSlots || (select && OA > kMaxAgentSlots)) return true;
  const int K = select && OA > 0 ? list_len(A / S, OA) : 8;
  return sizeof(float) * front_smem(M, n + 1, OA, mode, K, select && OA > 0).floats + 8 * 1024 >
         static_cast<size_t>(kMaxSmem);
}

template <int NT>
int front_by_list(const FrontArgs& a, cudaStream_t stream) {
  const bool select = a.select && a.OA > 0;
  if (front_is_wide(a.A, a.S, a.O, a.OA, a.M, a.n, a.mode, select))
    return select ? front_wide_go<NT, true>(a, stream) : front_wide_go<NT, false>(a, stream);
  if (!select) return front_go<NT, 8, false>(a, stream);
  switch (list_len(a.A / a.S, a.OA)) {
    case 8: return front_go<NT, 8, true>(a, stream);
    case 16: return front_go<NT, 16, true>(a, stream);
    default: return front_go<NT, 32, true>(a, stream);
  }
}

template <class T>
int occupancy(T* kernel, int dyn_smem, int* blocks_per_sm) {
  const cudaError_t e = allow_smem(kernel, dyn_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kBlockThreads, dyn_smem));
}

}  // namespace

// the build of a neighbor_slots_launch: its list K (select_nearest, OA <=
// kMaxAgentSlots), 0 for the wide build (select_wide)
extern "C" int neighbor_slots_build(int A, int OA) {
  return OA > kMaxAgentSlots ? 0 : list_len(A, OA);
}

// S*A blocks, one an agent, of the build neighbor_slots_build names
extern "C" int neighbor_slots_launch(const float* pos, int S, int A, int OA, float range,
                                     int use_range, long long* order, bool* valid,
                                     cudaStream_t stream) {
  if (S < 1 || A < 2 || OA < 1 || OA >= A || static_cast<long long>(S) * A > INT_MAX ||
      sizeof(float) * select_wide_floats(OA) > static_cast<size_t>(kWideLimit))
    return cudaErrorInvalidValue;
  switch (neighbor_slots_build(A, OA)) {
    case 0: return neighbor_wide_go(pos, S, A, OA, range, use_range, order, valid, stream);
    case 8: return neighbor_go<8>(pos, S, A, OA, range, use_range, order, valid, stream);
    case 16: return neighbor_go<16>(pos, S, A, OA, range, use_range, order, valid, stream);
    default: return neighbor_go<32>(pos, S, A, OA, range, use_range, order, valid, stream);
  }
}

// dynamic shared memory of a neighbor_slots_launch block, bytes
extern "C" int neighbor_slots_smem_bytes(int A, int OA) {
  const int K = neighbor_slots_build(A, OA);
  return static_cast<int>(sizeof(float)) * (K ? select_floats(K) : select_wide_floats(OA));
}

// the build of a step_front_launch: its list K (8 without a selection), 0
// for the wide builds; -1 for a shape no build takes (the wide builds'
// tables and one chunk's rows past shared memory)
extern "C" int step_front_build(int A, int S, int O, int OA, int M, int n, int mode, int select) {
  const bool sel = select && OA > 0;
  if (front_is_wide(A, S, O, OA, M, n, mode, sel)) {
    const WideSmem w = front_wide_smem(M, n + 1, O, OA, mode, sel, 0, kWideLimit);
    return sizeof(float) * w.floats <= static_cast<size_t>(kWideLimit) ? 0 : -1;
  }
  return sel ? list_len(A / S, OA) : 8;
}

// ptrs: FrontPtrs' fields in order; ints: A, S, O, OA, OD, M, n, mode,
// size_growth, use_guard, select, use_range; flts: dt, reset, guard, range
extern "C" int step_front_launch(void* const* ptrs, const int* ints, const float* flts,
                                 cudaStream_t stream) {
  FrontArgs a;
  static_assert(sizeof(FrontPtrs) == 35 * sizeof(void*), "FrontPtrs: 35 pointers");
  memcpy(&a.p, ptrs, sizeof(FrontPtrs));
  a.A = ints[0]; a.S = ints[1]; a.O = ints[2]; a.OA = ints[3]; a.OD = ints[4];
  a.M = ints[5]; a.n = ints[6]; a.mode = ints[7]; a.size_growth = ints[8]; a.use_guard = ints[9];
  a.select = ints[10]; a.use_range = ints[11];
  a.dt = flts[0]; a.reset = flts[1]; a.guard = flts[2]; a.range = flts[3];
  if (a.A < 1 || a.S < 1 || a.A % a.S || a.O < 1 || a.OA < 0 || a.OD < 0 ||
      a.OA + a.OD > a.O || a.M < 1 || a.n < 1 || (a.select && a.OA > 0 && a.OA >= a.A / a.S) ||
      step_front_build(a.A, a.S, a.O, a.OA, a.M, a.n, a.mode, a.select) < 0)
    return cudaErrorInvalidValue;
  a.chunk = front_wide_smem(a.M, a.n + 1, a.O, a.OA, a.mode, a.select && a.OA > 0, 0,
                            kWideLimit).chunk;
  return a.n + 1 == 6 ? front_by_list<6>(a, stream) : front_by_list<0>(a, stream);
}

// shared memory of a step_front_launch block, bytes: the dynamic part
extern "C" int step_front_smem_bytes(int A, int S, int O, int OA, int M, int n, int mode,
                                     int select) {
  const bool sel = select && OA > 0;
  if (front_is_wide(A, S, O, OA, M, n, mode, sel))
    return static_cast<int>(sizeof(float)) *
           front_wide_smem(M, n + 1, O, OA, mode, sel, 0, kWideLimit).floats;
  const int K = sel ? list_len(A / S, OA) : 8;
  return static_cast<int>(sizeof(float)) * front_smem(M, n + 1, OA, mode, K, sel).floats;
}

// the wide builds' slots staged at once (O + 1: every row at once)
extern "C" int step_front_chunk(int O, int OA, int M, int n, int mode, int select) {
  return front_wide_smem(M, n + 1, O, OA, mode, select && OA > 0, 0, kWideLimit).chunk;
}

// blocks an SM of a stage kernel at `dyn_smem` bytes of dynamic shared
// memory: kernel 0 the neighbour selection (list K), 1 the prediction with
// `order` given, 2 with its own selection (K), 3 the goal (n: the Bezier
// degree, the prediction kernel's template; K = 0: the wide builds)
extern "C" int step_stages_occupancy(int kernel, int n, int K, int dyn_smem, int* blocks_per_sm) {
  const bool six = n + 1 == 6;
  switch (kernel) {
    case 0:
      return K == 0 ? occupancy(neighbor_slots_wide_kernel, dyn_smem, blocks_per_sm)
             : K == 8 ? occupancy(neighbor_slots_kernel<8>, dyn_smem, blocks_per_sm)
             : K == 16 ? occupancy(neighbor_slots_kernel<16>, dyn_smem, blocks_per_sm)
                       : occupancy(neighbor_slots_kernel<32>, dyn_smem, blocks_per_sm);
    case 1:
      if (K == 0)
        return six ? occupancy(step_front_wide_kernel<6, false>, dyn_smem, blocks_per_sm)
                   : occupancy(step_front_wide_kernel<0, false>, dyn_smem, blocks_per_sm);
      return six ? occupancy(step_front_kernel<6, 8, false>, dyn_smem, blocks_per_sm)
                 : occupancy(step_front_kernel<0, 8, false>, dyn_smem, blocks_per_sm);
    case 2:
      if (six)
        return K == 0 ? occupancy(step_front_wide_kernel<6, true>, dyn_smem, blocks_per_sm)
               : K == 8 ? occupancy(step_front_kernel<6, 8, true>, dyn_smem, blocks_per_sm)
               : K == 16 ? occupancy(step_front_kernel<6, 16, true>, dyn_smem, blocks_per_sm)
                         : occupancy(step_front_kernel<6, 32, true>, dyn_smem, blocks_per_sm);
      return K == 0 ? occupancy(step_front_wide_kernel<0, true>, dyn_smem, blocks_per_sm)
             : K == 8 ? occupancy(step_front_kernel<0, 8, true>, dyn_smem, blocks_per_sm)
             : K == 16 ? occupancy(step_front_kernel<0, 16, true>, dyn_smem, blocks_per_sm)
                       : occupancy(step_front_kernel<0, 32, true>, dyn_smem, blocks_per_sm);
    case 3:
      return occupancy(goal_qp_inputs_kernel, dyn_smem, blocks_per_sm);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int goal_qp_inputs_launch(void* const* ptrs, const int* ints, const float* flts,
                                     cudaStream_t stream) {
  GoalArgs a;
  static_assert(sizeof(GoalPtrs) == 26 * sizeof(void*), "GoalPtrs: 26 pointers");
  memcpy(&a.p, ptrs, sizeof(GoalPtrs));
  a.A = ints[0]; a.O = ints[1]; a.M = ints[2]; a.N = ints[3]; a.dim = ints[4]; a.phi = ints[5];
  a.R = ints[6]; a.goal = ints[7]; a.use_sfc = ints[8]; a.use_comm = ints[9];
  a.past_seq = ints[10];
  a.dt = flts[0]; a.Mdt = flts[1]; a.tiny = flts[2]; a.qp_margin = flts[3]; a.comm_box = flts[4];
  a.comm_half = flts[5]; a.dl_vel = flts[6];
  if (a.A < 1 || a.O < 1 || a.M < 1 || a.N < 1 || (a.dim != 2 && a.dim != 3))
    return cudaErrorInvalidValue;
  goal_qp_inputs_kernel<<<a.A, kBlockThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
