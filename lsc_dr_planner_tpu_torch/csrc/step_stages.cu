// Three stages of the fleet planning step, for NVIDIA Hopper (sm_90a), each
// one launch that equals its plain torch body in
// lsc_dr_planner_tpu_torch/planner/stages.py bit for bit. None replaces a
// Pallas kernel: the JAX package ran these stages as XLA fusions inside its
// one jitted step; the port ran them as ~125 small torch kernels a step, each
// issued by the host (~25-30 us apiece on the card's host) while the device
// waited, whatever the fleet's size. Every kernel runs one agent a block of
// 128 threads (4 warps; the wide prediction of a fleet too small to fill the
// card, an agent over several blocks): at <= 64 registers 8 blocks fit an
// SM, so the main path's 1,024 agents are all resident at once on the H100's
// 132 SMs.
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
// - the wide builds (neighbor_slots_wide_kernel, step_front_wide_kernel), for
//   every shape past the narrow builds above (OA > 32 with a selection, O >
//   64, or rows past shared memory; the reference caps no neighbour set).
//   select_wide: every candidate's distance bits once into shared memory, then
//   a radix select of the OA-th smallest over them (8 bits a pass, stopped
//   where the chosen bin holds exactly the keys still needed or where the
//   prefix's candidates are one distance), the keys below it and the lowest
//   indices at it placed in index order by ballot counts, and a sort by rank
//   (or a bitonic sort past 256 keys): exact as select_nearest. The
//   prediction, a store stream: the slot tables in dynamic shared memory sized
//   by O; a thread a slot decides its kind and tests the reset from its row's
//   first point in global memory; every output goes out in 16-B stores, a
//   shifted row's four floats read straight from the source row (L2-resident),
//   two runs of four a thread in flight; a fleet too small to fill the card at
//   8 blocks an SM splits each agent's predictions over several blocks
//   (front_parts). Outputs bit for bit the plain bodies', as the narrow
//   builds'. Their limits are shared memory's: the tables ~62 B a slot and the
//   selection 4 B a candidate and 16 B an agent slot (O up to ~3,500 slots, A
//   up to ~55,000 agents). On an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md
//   section 6, chip_smoke.py's fronts_ab) at phase 8f's 1,024 agents, 80
//   slots, M = 12 (3-D): the prediction 0.048 ms against its 0.0228 ms bytes
//   bound (obs_pred's 71 MB written; the staged build took 0.080), the fused
//   launch 0.058 (0.112), the selection alone 0.011 (0.0185). clock64 marks
//   (chip_smoke.py::front_marks_main) put 83% of the prediction's block in the
//   stream (~1.8 TB/s written, as much read from L2) and ~20 k of the fused
//   block's ~94 k cycles in the selection.
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

__host__ __device__ inline int r4(int f) { return (f + 3) & ~3; }

// the sort's length for OA keys: the least power of two >= OA
__host__ __device__ inline int sort_len(int OA) {
  int P = 1;
  while (P < OA) P <<= 1;
  return P;
}

// select_wide sorts its keys by rank (each key's place its count of smaller
// keys, one barrier) up to this many, by a bitonic network above
constexpr int kRankSortMax = 256;

// select_wide's shared memory, in floats from a 16-B aligned start: the
// candidates' distance bits [A] at 0, the selected keys (u64) [OA] or, for
// the bitonic sort, [sort_len(OA)] at `key`, the rank sort's output [OA] at
// `out`, two digit histograms [2][256] at `hist`, then the warps' counts of
// two tiles [2][2][kWarps], the pass's digit, rank and bin count [4] and two
// (min, max) pairs of the candidates of the pass's prefix [2][2] at `cnt`
struct SelectWide {
  int key, out, hist, cnt, floats;
};

__host__ __device__ inline SelectWide select_wide_layout(int A, int OA) {
  SelectWide l;
  l.key = r4(A);
  l.out = l.key + 2 * (OA <= kRankSortMax ? OA : sort_len(OA));
  l.hist = r4(l.out + 2 * OA);
  l.cnt = l.hist + 2 * 256;
  l.floats = r4(l.cnt + 4 * kWarps + 8);
  return l;
}

// hist[digit] += 1 for every lane with `in`: one shared atomic for the warp
// where every such lane has one digit (the first pass, over distances of a
// few octaves, mostly), else one a lane; every lane of the warp calls it
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned digit, bool in, int lane) {
  const unsigned act = __ballot_sync(kFull, in);
  if (act == 0) return;
  const int lead = __ffs(act) - 1;
  const unsigned d0 = __shfl_sync(kFull, digit, lead);
  if (__all_sync(kFull, !in || digit == d0)) {
    if (lane == lead) atomicAdd(hist + d0, static_cast<unsigned>(__popc(act)));
  } else if (in) {
    atomicAdd(hist + digit, 1u);
  }
}

// The digit whose bins of `hist` hold the need-th key, by warp 0 (a lane 8
// bins): ctl[0] the digit, ctl[1] the key's rank among the digit's, ctl[2]
// the digit's count
__device__ __forceinline__ void hist_digit(const unsigned* hist, int need, int lane, int* ctl) {
  unsigned c[8], sum = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) sum += c[k] = hist[8 * lane + k];
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
    ctl[0] = 8 * lane + k;
    ctl[1] = need - static_cast<int>(below);
    ctl[2] = static_cast<int>(c[k]);
  }
}

// The OA nearest keys of agent i among the A positions p [A, 3] (its
// scenario's), ascending, by the whole block; returns where they are in s_u
// (select_wide_layout(A, OA).floats floats of 16-B aligned shared memory).
// Each candidate's distance bits computed once (distances are never negative,
// so their bits order as unsigned integers) into shared memory, kBitsUnroll
// candidates a thread in flight, with the first pass's histogram (hist_add);
// then a radix select of the OA-th smallest over them, 8 bits a pass (a
// histogram each, a shared atomic a lane after the first, the next pass's
// zeroed while warp 0 scans this one's): integer counts, so the result does
// not depend on the order of the atomics. A pass stops the select where the
// chosen digit's bin holds exactly the keys still needed, or where every
// candidate of its prefix has one distance (their least and largest bits,
// taken in the same loop, equal: a tie, as at the out-of-range 1e9), which is
// then the threshold. The keys below the threshold and the lowest indices at
// it are placed a tile of 128 candidates at a time in index order by ballot
// counts (a barrier a tile), stopped once all are placed; then sorted: by rank
// up to kRankSortMax keys (where the threshold is one distance, only the keys
// below it: its ties are in place), by a bitonic network above. Exact as
// select_nearest: the same keys, the same order. Needs 1 <= OA < A. Ends with
// a barrier.
__device__ const u64* select_wide(const float* __restrict__ p, int A, int i, int OA, float range,
                                  bool use_range, float* s_u) {
  constexpr int kBitsUnroll = 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const SelectWide L = select_wide_layout(A, OA);
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_u);
  u64* s_key = reinterpret_cast<u64*>(s_u + L.key);
  unsigned* s_hist = reinterpret_cast<unsigned*>(s_u + L.hist);  // [2][256]
  int* s_cnt = reinterpret_cast<int*>(s_u + L.cnt);              // [2][2][kWarps]
  int* s_ctl = s_cnt + 4 * kWarps;  // the pass's digit, rank in it, bin count
  unsigned* s_mm = reinterpret_cast<unsigned*>(s_ctl + 4);  // [2][min, max]
  const float px = __ldg(p + 3 * i), py = __ldg(p + 3 * i + 1), pz = __ldg(p + 3 * i + 2);
  // candidate j's distance bits from its position
  auto bits = [&](int j, float qx, float qy, float qz) {
    float d = fmaxf(fmaxf(fabsf(sub(px, qx)), fabsf(sub(py, qy))), fabsf(sub(pz, qz)));
    if (j == i) d = add(d, 1e9f);  // dist + eye * 1e9 (+0 elsewhere)
    if (use_range && !(d < range)) d = 1e9f;
    return __float_as_uint(d);
  };

  for (int b = tid; b < 2 * 256; b += kBlockThreads) s_hist[b] = 0;
  if (tid < 4) s_mm[tid] = tid & 1 ? 0u : ~0u;
  __syncthreads();
  // the distance bits, kBitsUnroll candidates' loads at once, with the
  // first pass's histogram of their top 8 bits and their least and largest
  unsigned lo = ~0u, hi = 0u;
  for (int j0 = tid; j0 - tid < A; j0 += kBlockThreads * kBitsUnroll) {
    float q[kBitsUnroll][3];
#pragma unroll
    for (int u = 0; u < kBitsUnroll; ++u) {
      const int j = j0 + kBlockThreads * u;
      if (j < A)
        for (int d = 0; d < 3; ++d) q[u][d] = __ldg(p + 3 * j + d);
    }
#pragma unroll
    for (int u = 0; u < kBitsUnroll; ++u) {
      const int j = j0 + kBlockThreads * u;
      unsigned b = 0;
      if (j < A) {
        b = bits(j, q[u][0], q[u][1], q[u][2]);
        s_bits[j] = b;
        lo = min(lo, b);
        hi = max(hi, b);
      }
      if (j - tid < A) hist_add(s_hist, b >> 24, j < A, lane);  // the warp alike
    }
  }

  // the distance bits of the OA-th smallest key: `prefix` its bits under
  // `mask`, `need` its rank among the keys of that prefix
  unsigned prefix = 0, mask = 0;
  int need = OA;
  for (int pass = 0, shift = 24; shift >= 0; ++pass, shift -= 8) {
    unsigned* hist = s_hist + 256 * (pass & 1);
    unsigned* mm = s_mm + 2 * (pass & 1);
    if (pass > 0) {
      lo = ~0u;
      hi = 0u;
      for (int j0 = 0; j0 < A; j0 += kBlockThreads) {
        const int j = j0 + tid;
        const unsigned b = j < A ? s_bits[j] : 0u;
        const bool in = j < A && (b & mask) == prefix;
        if (in) {
          lo = min(lo, b);
          hi = max(hi, b);
        }
        if (in) atomicAdd(hist + ((b >> shift) & 255), 1u);
      }
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 0) {
      atomicMin(mm, lo);
      atomicMax(mm + 1, hi);
    }
    __syncthreads();
    if (mm[0] == mm[1]) {  // one distance: the threshold; every thread alike
      prefix = mm[0];
      mask = ~0u;
      break;
    }
    if (warp == 0) {
      hist_digit(hist, need, lane, s_ctl);
    } else {  // the next pass's histogram and (min, max) reset meanwhile
      unsigned* next = s_hist + 256 * ((pass + 1) & 1);
      for (int b = tid - 32; b < 256; b += kBlockThreads - 32) next[b] = 0;
      if (tid < 34) s_mm[2 * ((pass + 1) & 1) + tid - 32] = tid == 32 ? ~0u : 0u;
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(s_ctl[0]) << shift;
    mask |= 255u << shift;
    need = s_ctl[1];
    if (s_ctl[2] == need) break;  // the bin's keys are all taken: every thread alike
  }
  // the keys below the threshold (OA - need of them) and the `need` lowest
  // indices at it, a tile of 128 candidates at a time in index order: a
  // key's place is its rank among the tile's by ballots, plus the counts of
  // the tiles before (s_cnt double-buffered: one barrier a tile)
  const unsigned lt = (1u << lane) - 1;
  int n_less = 0, n_tie = 0;
  for (int t0 = 0, buf = 0; t0 < A; t0 += kBlockThreads, buf ^= 1) {
    const int j = t0 + tid;
    const unsigned b = j < A ? s_bits[j] : 0u;
    const bool less = j < A && (b & mask) < prefix, tie = j < A && (b & mask) == prefix;
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
  __syncthreads();
  // ascending. Where the threshold is one distance (mask all ones), its
  // ties are its lowest indices in index order, after every key below it:
  // in place already, so only the OA - need keys below it are sorted
  const int n_sort = mask == ~0u ? OA - need : OA;
  if (n_sort <= kRankSortMax) {  // by rank (keys are unique), two keys a thread
    u64* s_out = reinterpret_cast<u64*>(s_u + L.out);
    for (int e = tid; e < n_sort; e += 2 * kBlockThreads) {
      const bool two = e + kBlockThreads < n_sort;
      const u64 k0 = s_key[e], k1 = two ? s_key[e + kBlockThreads] : 0ull;
      int r0 = 0, r1 = 0;
#pragma unroll 4
      for (int j = 0; j < n_sort; ++j) {
        const u64 x = s_key[j];
        r0 += x < k0;
        r1 += x < k1;
      }
      s_out[r0] = k0;
      if (two) s_out[r1] = k1;
    }
    for (int e = n_sort + tid; e < OA; e += kBlockThreads) s_out[e] = s_key[e];
    __syncthreads();
    return s_out;
  }
  const int P = sort_len(OA);
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
  return s_key;
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
  const u64* s_key = select_wide(pos + first * 3, A, i, OA, range, use_range != 0,
                                 reinterpret_cast<float*>(smem4));
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
  int parts;  // the wide prediction's blocks an agent (front_parts)
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

// the wide prediction's dynamic shared memory, in floats (each part 16-B
// aligned): the points' times [M*N] at 0, the sub-step matrix [N*N], the
// slot tables sized by O (the agent slots' source rows, each slot's kind,
// position and velocity with the agent's own at [O], goal, radius,
// downwash, max_acc, validity and is_agent), and at `u` the selection's
// (select_wide_layout over the scenario's A agents; 0 without it)
struct WideSmem {
  int sub, src, kind, p, v, goal, radius, downwash, max_acc, valid, is_agent, u, floats;
};

__host__ __device__ inline WideSmem front_wide_smem(int M, int N, int O, int OA, int A,
                                                    bool select) {
  WideSmem s;
  s.sub = r4(M * N);
  s.src = s.sub + r4(N * N);
  s.kind = s.src + r4(2 * OA);  // long long [OA]
  s.p = s.kind + r4(O + 1);
  s.v = s.p + r4(3 * (O + 1));
  s.goal = s.v + r4(3 * (O + 1));
  s.radius = s.goal + r4(3 * O);
  s.downwash = s.radius + r4(O);
  s.max_acc = s.downwash + r4(O);
  s.valid = s.max_acc + r4(O);
  s.is_agent = s.valid + r4((O + 3) / 4);  // bool [O]
  s.u = s.is_agent + r4((O + 3) / 4);
  s.floats = s.u + (select && OA > 0 ? select_wide_layout(A, OA).floats : 0);
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
// (kGlobal: the row in global memory, read by the non-coherent path; else
// in shared memory)
template <int NT, bool kGlobal = false>
__device__ __forceinline__ float row_value(const float* __restrict__ row,
                                           const float* __restrict__ s_sub, bool substep, int N,
                                           int MN3, int r, int d) {
  auto at = [row](int e) { return kGlobal ? __ldg(row + e) : row[e]; };
  if (!substep) return r < MN3 - 3 * N ? at(r + 3 * N) : at(MN3 - 3 + d);
  if (r >= 3 * N) return at(r);
  const int i = r / 3;
  float acc = mul(s_sub[i], at(d));
#pragma unroll
  for (int k = 1; k < (NT ? NT : N); ++k) acc = add(acc, mul(s_sub[k * N + i], at(3 * k + d)));
  return acc;
}

// v <- g[0, 4) from global memory by the non-coherent path: one 16-B load
// where g is 16-B aligned, two of 8 B where it is 8-B aligned, else four
__device__ __forceinline__ void load4(const float* __restrict__ g, float (&v)[4]) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(g) & 15;
  if (at == 0) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(g));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if (at == 8) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(g));
    const float2 y = __ldg(reinterpret_cast<const float2*>(g + 2));
    v[0] = x.x, v[1] = x.y, v[2] = y.x, v[3] = y.y;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = __ldg(g + q);
  }
}

// out[first, last) of this agent (first a multiple of 4), rows of `span`
// floats, as store_runs, with kUnroll runs of four a thread computed (their
// loads in flight together) before any is stored; a run's row and column
// advanced by additions
constexpr int kUnroll = 2;

template <class F, class G>
__device__ __forceinline__ void stream_runs(float* __restrict__ out, int first, int last, int span,
                                            F value, G run) {
  constexpr int kStep = 4 * kBlockThreads;  // floats between a thread's runs
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int step_rows = kStep / span, step_r = kStep - step_rows * span;
  int row0 = (first + 4 * threadIdx.x) / span, r0 = first + 4 * threadIdx.x - row0 * span;
  for (int f0 = first + 4 * threadIdx.x; f0 < last; f0 += kStep * kUnroll) {
    float v[kUnroll][4];
    int row = row0, r = r0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = f0 + kStep * u;
      if (f < last && !(f + 4 <= last && r + 4 <= span && run(row, r, v[u]))) {
        int ro = row, rr = r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[u][q] = f + q < last ? value(ro, rr) : 0.0f;
          if (++rr == span) {
            rr = 0;
            ++ro;
          }
        }
      }
      row += step_rows;
      r += step_r;
      if (r >= span) {
        r -= span;
        ++row;
      }
    }
    row0 = row;
    r0 = r;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = f0 + kStep * u;
      if (vec && f + 4 <= last) {
        *reinterpret_cast<float4*>(out + f) = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
      } else {
        for (int q = 0; q < 4 && f + q < last; ++q) out[f + q] = v[u][q];
      }
    }
  }
}

// A fleet too small to fill the card at kFillBlocks blocks an SM (the wide
// prediction's __launch_bounds__) takes that many blocks in all, up to
// kMaxParts an agent: each computes the agent's selection and slot tables
// and streams its part of the predictions (a block alone would leave its
// SM's memory pipes idle between its rounds)
constexpr int kFillBlocks = 8;
constexpr int kMaxParts = 16;

// [first, last) of part `part` of `parts` of n floats, a multiple of 4 apart
__device__ __forceinline__ void part_range(int n, int part, int parts, int& first, int& last) {
  const int chunk = ((n + parts - 1) / parts + 3) & ~3;
  first = min(n, part * chunk);
  last = min(n, first + chunk);
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
// OA), a store stream: the slot tables in dynamic shared memory sized by O,
// the block's own selection by select_wide; then one thread a slot decides
// its kind and fills the tables, the disturbance reset from its row's first
// point read from global memory; then every output written four floats a
// thread with 16-B stores, the attributes from the tables, a shifted row's
// four floats read straight from the source row in global memory (L2-
// resident: each row is read by its neighbours' blocks), kUnroll runs a
// thread in flight. An agent's blocks (a.parts of them, front_parts) each
// select and fill the tables, and stream their part of the predictions;
// the first writes the selection and the attributes, the last the initial
// trajectory. The same operations as step_front_kernel, element for
// element.
template <int NT, bool kSelect>
__global__ void __launch_bounds__(kBlockThreads, kFillBlocks) step_front_wide_kernel(FrontArgs a) {
  const FrontPtrs& P = a.p;
  const int ag = blockIdx.x / a.parts, part = blockIdx.x - ag * a.parts, tid = threadIdx.x;
  const int O = a.O, OA = a.OA, M = a.M, N = NT ? NT : a.n + 1;
  const int N3 = 3 * N, MN3 = M * N3;
  const int per = a.A / a.S, s = ag / per;
  const bool substep = P.sub != nullptr;
  extern __shared__ float4 smem4[];
  float* s_t = reinterpret_cast<float*>(smem4);
  const WideSmem L = front_wide_smem(M, N, O, OA, per, kSelect);
  float* s_sub = s_t + L.sub;
  long long* s_src = reinterpret_cast<long long*>(s_t + L.src);  // the agent slots' source rows
  int* s_kind = reinterpret_cast<int*>(s_t + L.kind);  // Kind of slot o; [O] the agent's own
  float* s_p = s_t + L.p;  // [O + 1][3]
  float* s_v = s_t + L.v;
  float* s_goal = s_t + L.goal;  // [O][3]
  float* s_radius = s_t + L.radius;
  float* s_downwash = s_t + L.downwash;
  float* s_max_acc = s_t + L.max_acc;
  bool* s_valid = reinterpret_cast<bool*>(s_t + L.valid);
  bool* s_is_agent = reinterpret_cast<bool*>(s_t + L.is_agent);

  for (int e = tid; e < M * N; e += kBlockThreads) {
    const int m = e / N;
    s_t[e] = cv_time(m, e - m * N, a.n, a.dt);
  }
  if (substep)
    for (int e = tid; e < N * N; e += kBlockThreads) s_sub[e] = P.sub[e];

  // 1. the agent slots' sources: the block's own selection, or `order`
  if constexpr (kSelect) {
    const long long first = static_cast<long long>(s) * per;
    const u64* s_key = select_wide(P.src_pos + first * 3, per, ag - s * per, OA, a.range,
                                   a.use_range != 0, s_t + L.u);
    for (int o = tid; o < OA; o += kBlockThreads) {
      const u64 key = s_key[o];
      const long long at = static_cast<long long>(ag) * OA + o;
      s_src[o] = key_row(key, first);
      s_valid[o] = key_valid(key);
      if (part == 0) {
        P.order_out[at] = s_src[o];
        P.valid_out[at] = s_valid[o];
      }
    }
  } else {
    for (int o = tid; o < OA; o += kBlockThreads) {
      const long long at = static_cast<long long>(ag) * OA + o;
      s_src[o] = P.order ? P.order[at] : at;
      s_valid[o] = P.slot_valid[at];
    }
  }
  __syncthreads();

  // the source row of a kRow slot (slot O: the agent's own)
  auto row_of = [&](int o) {
    return o == O ? P.prev + static_cast<long long>(ag) * MN3 : P.src_prev + s_src[o] * MN3;
  };

  // 2. one thread a slot: its kind, position and velocity, its attributes
  // into the tables, and the disturbance reset: an agent slot whose
  // predicted first point is off its observed position by more than
  // `reset` holds the position
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
        const float* g3 = P.src_goal + src * 3;
        for (int d = 0; d < 3; ++d) s_goal[3 * o + d] = g3[d];
        s_radius[o] = P.src_radius[src];
        s_downwash[o] = P.src_downwash[src];
        s_max_acc[o] = 0.0f;
        s_is_agent[o] = true;
      }
      if (kind == kRow && o < OA) {
        const float* row = row_of(o);
        float e[3];
        for (int d = 0; d < 3; ++d)
          e[d] = sub(row_value<NT, true>(row, s_sub, substep, N, MN3, d, d), p[d]);
        if (norm64(e, 3) > a.reset) {
          kind = kCv;
          for (int d = 0; d < 3; ++d) v[d] = 0.0f;
        }
      }
    } else if (a.OD > 0) {  // a dynamic obstacle of the agent's scenario
      const long long di = static_cast<long long>(s) * a.OD + (o - OA);
      for (int d = 0; d < 3; ++d) {
        p[d] = P.dyn_pos[di * 3 + d];
        v[d] = P.dyn_vel[di * 3 + d];
        s_goal[3 * o + d] = p[d];
      }
      s_radius[o] = P.dyn_radius[di];
      s_downwash[o] = P.dyn_downwash[di];
      s_max_acc[o] = P.dyn_max_acc[di];
      s_valid[o] = P.dyn_valid[di];
      s_is_agent[o] = false;
    } else {  // the single agent's padding slot
      kind = kPad;
      for (int d = 0; d < 3; ++d) s_goal[3 * o + d] = 0.0f;
      s_radius[o] = 0.1f;
      s_downwash[o] = 1.0f;
      s_max_acc[o] = 0.0f;
      s_valid[o] = false;
      s_is_agent[o] = false;
    }
    s_kind[o] = kind;
    for (int d = 0; d < 3; ++d) {
      s_p[3 * o + d] = p[d];
      s_v[3 * o + d] = v[d];
    }
  }
  __syncthreads();

  // 3. the attributes from the tables, unit-stride (the agent's first
  // part): pos_now is the slot's position (the source's, the obstacle's, or
  // 0)
  const long long so = static_cast<long long>(ag) * O;
  auto none = [](int, int, float (&)[4]) { return false; };
  if (part == 0) {
    auto flat = [&](float* out, int n, const float* table) {
      stream_runs(out, 0, n, n, [&](int, int e) { return table[e]; }, none);
    };
    flat(P.obs_radius + so, O, s_radius);
    flat(P.obs_downwash + so, O, s_downwash);
    flat(P.obs_max_acc + so, O, s_max_acc);
    flat(P.obs_pos_now + so * 3, 3 * O, s_p);
    flat(P.obs_goal + so * 3, 3 * O, s_goal);
    for (int o = tid; o < O; o += kBlockThreads) {
      P.obs_valid[so + o] = s_valid[o];
      P.obs_is_agent[so + o] = s_is_agent[o];
    }
  }

  // 4. the predictions: element r = 3*(m*N + i) + d of a slot's
  auto pred = [&](int o, int r) -> float {
    const int q = r / 3, d = r - 3 * q;
    switch (s_kind[o]) {
      case kRow:
        return row_value<NT, true>(row_of(o), s_sub, substep, N, MN3, r, d);
      case kCv:
        return add(s_p[3 * o + d], mul(s_v[3 * o + d], s_t[q]));
      default:
        return 0.0f;
    }
  };
  // a row's runs of four: the shift (one segment on) and the last point
  // held, or in the sub-step the segments past the first as they are
  auto copied = [&](int o, int r, float (&v)[4]) {
    if (s_kind[o] != kRow) return false;
    const float* row = row_of(o);
    if (substep || r + 4 <= MN3 - N3) {
      if (substep && r < N3) return false;
      load4(row + (substep ? r : r + N3), v);
      return true;
    }
    if (r < MN3 - N3) return false;  // the run straddles the last segment
    for (int q = 0, d = r % 3; q < 4; ++q, d = d == 2 ? 0 : d + 1) v[q] = __ldg(row + MN3 - 3 + d);
    return true;
  };
  int first, last;  // this part's floats of the agent's obs_pred
  part_range(O * MN3, part, a.parts, first, last);
  stream_runs(P.obs_pred + so * MN3, first, last, MN3, pred, copied);
  if (part == a.parts - 1)
    stream_runs(P.initial + static_cast<long long>(ag) * MN3, 0, MN3, MN3,
                [&](int, int r) { return pred(O, r); },
                [&](int, int r, float (&v)[4]) { return copied(O, r, v); });

  // the size prediction (plain LSC and RSFC read it)
  if (P.sizes != nullptr) {
    float guard = 0.0f;
    if (a.use_guard) {
      const float* v3 = P.vel + ag * 3;
      guard = div(mul(a.guard, dotn(v3, v3, 3)), P.max_acc[ag * 3]);
    }
    const int MN = M * N;
    part_range(O * MN, part, a.parts, first, last);
    stream_runs(P.sizes + so * MN, first, last, MN, [&](int o, int mi) {
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
  const size_t bytes = sizeof(float) * select_wide_layout(A, OA).floats;
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

// the card's SMs (cached: one card a process)
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 1;
  }
  return sms;
}

// the wide prediction's blocks an agent for A agents (kFillBlocks)
int front_parts(int A) {
  const long long fill = static_cast<long long>(kFillBlocks) * sm_count();
  return static_cast<int>(fill / A < 1 ? 1 : fill / A < kMaxParts ? fill / A : kMaxParts);
}

template <int NT, bool kSelect>
int front_wide_go(FrontArgs a, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * front_wide_smem(a.M, a.n + 1, a.O, a.OA, a.A / a.S, kSelect).floats;
  const cudaError_t e = allow_smem(step_front_wide_kernel<NT, kSelect>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.parts = front_parts(a.A);
  step_front_wide_kernel<NT, kSelect><<<a.A * a.parts, kBlockThreads, bytes, stream>>>(a);
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
      sizeof(float) * select_wide_layout(A, OA).floats > static_cast<size_t>(kWideLimit))
    return cudaErrorInvalidValue;
  switch (neighbor_slots_build(A, OA)) {
    case 0: return neighbor_wide_go(pos, S, A, OA, range, use_range, order, valid, stream);
    case 8: return neighbor_go<8>(pos, S, A, OA, range, use_range, order, valid, stream);
    case 16: return neighbor_go<16>(pos, S, A, OA, range, use_range, order, valid, stream);
    default: return neighbor_go<32>(pos, S, A, OA, range, use_range, order, valid, stream);
  }
}

// the wide prediction's blocks an agent at A agents in all (front_parts)
extern "C" int step_front_parts(int A) { return A < 1 ? 0 : front_parts(A); }

// dynamic shared memory of a neighbor_slots_launch block, bytes
extern "C" int neighbor_slots_smem_bytes(int A, int OA) {
  const int K = neighbor_slots_build(A, OA);
  return static_cast<int>(sizeof(float)) *
         (K ? select_floats(K) : select_wide_layout(A, OA).floats);
}

// the build of a step_front_launch: its list K (8 without a selection), 0
// for the wide builds; -1 for a shape no build takes (the wide builds'
// tables and selection past shared memory)
extern "C" int step_front_build(int A, int S, int O, int OA, int M, int n, int mode, int select) {
  const bool sel = select && OA > 0;
  if (front_is_wide(A, S, O, OA, M, n, mode, sel)) {
    const WideSmem w = front_wide_smem(M, n + 1, O, OA, A / S, sel);
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
  return a.n + 1 == 6 ? front_by_list<6>(a, stream) : front_by_list<0>(a, stream);
}

// shared memory of a step_front_launch block, bytes: the dynamic part
extern "C" int step_front_smem_bytes(int A, int S, int O, int OA, int M, int n, int mode,
                                     int select) {
  const bool sel = select && OA > 0;
  if (front_is_wide(A, S, O, OA, M, n, mode, sel))
    return static_cast<int>(sizeof(float)) * front_wide_smem(M, n + 1, O, OA, A / S, sel).floats;
  const int K = sel ? list_len(A / S, OA) : 8;
  return static_cast<int>(sizeof(float)) * front_smem(M, n + 1, OA, mode, K, sel).floats;
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
