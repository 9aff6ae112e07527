// Three stages of the fleet planning step, for NVIDIA Hopper (sm_90a), each
// one launch that equals its plain torch body in
// lsc_dr_planner_tpu_torch/planner/stages.py bit for bit. None replaces a
// Pallas kernel: the JAX package ran these stages as XLA fusions inside its
// one jitted step; the port ran them as ~125 small torch kernels a step, each
// issued by the host (~25-30 us apiece on the card's host) while the device
// waited, whatever the fleet's size.
//
// - neighbor_slots_launch (stages.neighbor_slots; the JAX package's
//   lsc_dr_planner_tpu/planner/pipeline.py:226-252, lax.top_k at :247). Each
//   agent's OA nearest other agents of its scenario by L-infinity distance,
//   out-of-range ones and the agent itself at 1e9, nearest first and the lower
//   index first among ties; valid where the distance is below 1e8. One warp
//   an agent: each lane scans every 32nd candidate and keeps a sorted list of
//   its K smallest keys (distance bits << 32 | index: the distances are never
//   negative, so the integer order is (distance, index) order) in registers,
//   an unrolled insertion so that no array is indexed at run time; then OA
//   rounds of a warp minimum over the lists' heads, the winner popping its
//   head. The arithmetic is a subtraction, abs, max and a compare, so the
//   result is exact, ties included. Bound: the plain body's [S, A, A] matrix
//   is gone; the kernel reads S*A*12 bytes and writes S*A*OA*9, and its
//   least work is S*A*A candidate tests of 9 operations (0.14 us at the main
//   path's A = 1,024). Latency sets its time: a lane's 32 serial insertions
//   and the warp's OA rounds of shuffles.
// - step_front_launch (stages.step_front; pipeline.py:292-445 of the JAX
//   package, ops/trajectory.py:22, 83, 99). Stage 1, the obstacle prediction,
//   and stage 2, the initial trajectory: each slot's source read through
//   `order` from the fleet's own arrays (or from a gathered NeighborData), the
//   previous solution shifted by a segment or re-parameterised by the DLSC
//   sub-step, constant velocity where there is none (RSFC always), the
//   position (BVC), the disturbance reset, the dynamic obstacles of the
//   agent's scenario after the agent slots, the single-agent padding slot, the
//   size prediction where the mode reads it; the agent's own prediction, held
//   where it is disturbed. One block of 128 threads an agent: first a thread a
//   slot decides the slot's source and reset and writes its attributes, then
//   the threads run over (slot, segment, point, axis) so that every store of
//   obs_pred [A, O, M, N, 3] and initial_ctrl [A, M, N, 3] is unit-stride.
//   Bound: bytes. At A = 1,024, O = 16, M = 10, N = 6 it moves 14.1 MB
//   (obs_pred 11.8 MB written), 4.2 us at 3.35 TB/s; the sources it gathers
//   are each agent's 720 B of points, 0.7 MB read once, L2-resident.
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
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (nvidia-smi
// --query-gpu=name,power.limit; chip_smoke.py's stage_timing, PERF.md section
// 6) at the main path's call: 0.016, 0.030 and 0.017-0.018 ms queued back to
// back, where the torch ops they replace kept the device waiting on the host
// for ~3.8 ms a step; each takes 0.03-0.17 ms of the host's time to issue.
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
#include <cstring>

namespace {

constexpr int kWarpThreads = 256;  // neighbour selection: 8 agents (warps) a block
constexpr int kBlockThreads = 128;  // prediction and goal kernels: one agent a block
constexpr int kMaxSlots = 64;      // O, the obstacle slots an agent
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-6f;      // goal.py's _EPS, the rows' activity threshold

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
// neighbour slots
// ---------------------------------------------------------------------------

// key into the ascending list b of the K smallest, unrolled: b[k] takes b[k-1]
// where key < b[k-1], key where it falls between, else stays
template <int K>
__device__ __forceinline__ void insert(unsigned long long (&b)[K], unsigned long long key) {
  if (key >= b[K - 1]) return;
#pragma unroll
  for (int k = K - 1; k > 0; --k) {
    const unsigned long long prev = b[k - 1];
    b[k] = key < prev ? prev : (key < b[k] ? key : b[k]);
  }
  b[0] = key < b[0] ? key : b[0];
}

template <int K>
__device__ __forceinline__ void pop(unsigned long long (&b)[K]) {
#pragma unroll
  for (int k = 0; k < K - 1; ++k) b[k] = b[k + 1];
  b[K - 1] = ~0ull;
}

template <int K>
__global__ void __launch_bounds__(kWarpThreads)
neighbor_slots_kernel(const float* __restrict__ pos, int S, int A, int OA, float range,
                      int use_range, long long* __restrict__ order, bool* __restrict__ valid) {
  const long long agent = (static_cast<long long>(blockIdx.x) * kWarpThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (agent >= static_cast<long long>(S) * A) return;  // the whole warp leaves together
  const int s = static_cast<int>(agent / A), i = static_cast<int>(agent - static_cast<long long>(s) * A);
  const float* p = pos + static_cast<long long>(s) * A * 3;
  const float px = __ldg(p + 3 * i), py = __ldg(p + 3 * i + 1), pz = __ldg(p + 3 * i + 2);
  unsigned long long best[K];
#pragma unroll
  for (int k = 0; k < K; ++k) best[k] = ~0ull;
  for (int j = lane; j < A; j += 32) {
    const float* q = p + 3 * j;
    float d = fmaxf(fmaxf(fabsf(sub(px, __ldg(q))), fabsf(sub(py, __ldg(q + 1)))),
                    fabsf(sub(pz, __ldg(q + 2))));
    if (j == i) d = add(d, 1e9f);  // dist + eye * 1e9 (+0 elsewhere)
    if (use_range && !(d < range)) d = 1e9f;
    insert<K>(best, (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
                        static_cast<unsigned>(j));
  }
  unsigned long long mine = ~0ull;  // lane r keeps round r's key
  for (int r = 0; r < OA; ++r) {
    unsigned long long m = best[0];
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, m, off);
      m = o < m ? o : m;
    }
    if (best[0] == m) pop<K>(best);  // keys are unique: one lane pops
    if (lane == (r & 31)) mine = m;
    if ((r & 31) == 31 || r == OA - 1) {
      const int r0 = r & ~31;
      if (lane <= r - r0) {
        const long long at = agent * OA + r0 + lane;
        order[at] = static_cast<long long>(mine & 0xffffffffull) + static_cast<long long>(s) * A;
        valid[at] = __uint_as_float(static_cast<unsigned>(mine >> 32)) < 1e8f;
      }
    }
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
  const float* src_pos;    // [rows, 3]
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
};

struct FrontArgs {
  FrontPtrs p;
  int A, S, O, OA, OD, M, n, mode, size_growth, use_guard;
  float dt, reset, guard;
};

// trajectory.const_vel_ctrl's time of point (m, i): (m + i/n)*dt
__device__ __forceinline__ float cv_time(int m, int i, int n, float dt) {
  return mul(add(static_cast<float>(m), div(static_cast<float>(i), static_cast<float>(n))), dt);
}

// stages.predict at (m, i, d): `prev` the source's [M, N, 3] points
__device__ float predict_at(const FrontArgs& a, const float* __restrict__ prev, bool has_prev,
                            const float* __restrict__ p3, const float* __restrict__ v3, int m,
                            int i, int d) {
  const int N = a.n + 1;
  const float t = cv_time(m, i, a.n, a.dt);
  if (a.mode == kBvc) return add(p3[d], mul(0.0f, t));
  if (a.mode == kRsfc || !has_prev) return add(p3[d], mul(v3[d], t));
  if (a.p.sub == nullptr) {  // shift one segment, the last point held
    return m < a.M - 1 ? prev[((m + 1) * N + i) * 3 + d] : prev[((a.M - 1) * N + N - 1) * 3 + d];
  }
  if (m > 0) return prev[(m * N + i) * 3 + d];
  float acc = mul(a.p.sub[i], prev[d]);  // sum_k S[k, i] * c_k, left to right
  for (int k = 1; k < N; ++k) acc = add(acc, mul(a.p.sub[k * N + i], prev[k * 3 + d]));
  return acc;
}

enum Slot { kPred = 0, kHold = 1, kDyn = 2, kPad = 3 };

__global__ void __launch_bounds__(kBlockThreads) step_front_kernel(FrontArgs a) {
  const FrontPtrs& P = a.p;
  const int ag = blockIdx.x, tid = threadIdx.x;
  const int O = a.O, OA = a.OA, M = a.M, N = a.n + 1;
  const int MN3 = M * N * 3;
  __shared__ long long s_src[kMaxSlots];  // the slot's source row (agent slots), dynamic index
  __shared__ int s_kind[kMaxSlots];
  __shared__ bool s_has_prev[kMaxSlots];
  __shared__ bool s_is_agent[kMaxSlots];
  __shared__ float s_radius[kMaxSlots];
  __shared__ float s_max_acc[kMaxSlots];

  for (int o = tid; o < O; o += kBlockThreads) {
    const long long so = static_cast<long long>(ag) * O + o;
    float r, dw, macc = 0.0f, pnow[3], goal[3];
    bool v, is_agent;
    if (o < OA) {
      const long long at = static_cast<long long>(ag) * OA + o;
      const long long src = P.order ? P.order[at] : at;
      const float* prev = P.src_prev + src * MN3;
      const float* p3 = P.src_pos + src * 3;
      const float* v3 = P.src_vel + src * 3;
      const bool hp = P.src_has_prev[src];
      float e[3];
      for (int d = 0; d < 3; ++d) e[d] = sub(predict_at(a, prev, hp, p3, v3, 0, 0, d), p3[d]);
      s_src[o] = src;
      s_has_prev[o] = hp;
      s_kind[o] = norm64(e, 3) > a.reset ? kHold : kPred;  // the disturbance reset
      v = P.slot_valid[at];
      is_agent = true;
      r = P.src_radius[src];
      dw = P.src_downwash[src];
      for (int d = 0; d < 3; ++d) {
        pnow[d] = p3[d];
        goal[d] = P.src_goal[src * 3 + d];
      }
    } else if (a.OD > 0) {  // a dynamic obstacle of the agent's scenario
      const long long di = static_cast<long long>(ag / (a.A / a.S)) * a.OD + (o - OA);
      s_src[o] = di;
      s_kind[o] = kDyn;
      v = P.dyn_valid[di];
      is_agent = false;
      r = P.dyn_radius[di];
      dw = P.dyn_downwash[di];
      macc = P.dyn_max_acc[di];
      for (int d = 0; d < 3; ++d) pnow[d] = goal[d] = P.dyn_pos[di * 3 + d];
    } else {  // the single agent's padding slot
      s_kind[o] = kPad;
      v = false;
      is_agent = false;
      r = 0.1f;
      dw = 1.0f;
      for (int d = 0; d < 3; ++d) pnow[d] = goal[d] = 0.0f;
    }
    s_is_agent[o] = is_agent;
    s_radius[o] = r;
    s_max_acc[o] = macc;
    P.obs_valid[so] = v;
    P.obs_is_agent[so] = is_agent;
    P.obs_radius[so] = r;
    P.obs_downwash[so] = dw;
    P.obs_max_acc[so] = macc;
    for (int d = 0; d < 3; ++d) {
      P.obs_pos_now[so * 3 + d] = pnow[d];
      P.obs_goal[so * 3 + d] = goal[d];
    }
  }
  __syncthreads();

  // obs_pred, unit-stride over (slot, m, i, d)
  float* out = P.obs_pred + static_cast<long long>(ag) * O * MN3;
  for (int e = tid; e < O * MN3; e += kBlockThreads) {
    const int o = e / MN3, r = e - o * MN3;
    const int m = r / (N * 3), r2 = r - m * N * 3, i = r2 / 3, d = r2 - i * 3;
    const long long src = s_src[o];
    float x;
    switch (s_kind[o]) {
      case kPred:
        x = predict_at(a, P.src_prev + src * MN3, s_has_prev[o], P.src_pos + src * 3,
                       P.src_vel + src * 3, m, i, d);
        break;
      case kHold:  // const_vel_ctrl(pos, 0)
        x = add(P.src_pos[src * 3 + d], mul(0.0f, cv_time(m, i, a.n, a.dt)));
        break;
      case kDyn:
        x = add(P.dyn_pos[src * 3 + d], mul(P.dyn_vel[src * 3 + d], cv_time(m, i, a.n, a.dt)));
        break;
      default:
        x = 0.0f;
    }
    out[e] = x;
  }

  // the initial trajectory, held where the agent is disturbed
  const float* p3 = P.pos + ag * 3;
  const bool held = P.disturbed[ag];
  float* init = P.initial + static_cast<long long>(ag) * MN3;
  for (int e = tid; e < MN3; e += kBlockThreads) {
    const int m = e / (N * 3), r2 = e - m * N * 3, i = r2 / 3, d = r2 - i * 3;
    init[e] = held ? add(p3[d], mul(0.0f, cv_time(m, i, a.n, a.dt)))
                   : predict_at(a, P.prev + static_cast<long long>(ag) * MN3, P.has_prev[ag], p3,
                                P.vel + ag * 3, m, i, d);
  }

  // the size prediction (plain LSC and RSFC read it)
  if (P.sizes != nullptr) {
    float guard = 0.0f;
    if (a.use_guard) {
      const float* v3 = P.vel + ag * 3;
      guard = div(mul(a.guard, dotn(v3, v3, 3)), P.max_acc[ag * 3]);
    }
    float* sz = P.sizes + static_cast<long long>(ag) * O * M * N;
    for (int e = tid; e < O * M * N; e += kBlockThreads) {
      const int o = e / (M * N), mi = e - o * M * N;
      float x = s_radius[o];
      if (a.size_growth && (!s_is_agent[o] || a.mode == kRsfc))
        x = add(add(x, guard), mul(s_max_acc[o], P.growth[mi]));
      sz[e] = x;
    }
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

extern "C" int neighbor_slots_launch(const float* pos, int S, int A, int OA, float range,
                                     int use_range, long long* order, bool* valid,
                                     cudaStream_t stream) {
  if (S < 1 || A < 2 || OA < 1 || OA > 32 || OA >= A) return cudaErrorInvalidValue;
  const long long warps = static_cast<long long>(S) * A;
  const long long blocks = (warps * 32 + kWarpThreads - 1) / kWarpThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (OA <= 16)
    neighbor_slots_kernel<16><<<static_cast<int>(blocks), kWarpThreads, 0, stream>>>(
        pos, S, A, OA, range, use_range, order, valid);
  else
    neighbor_slots_kernel<32><<<static_cast<int>(blocks), kWarpThreads, 0, stream>>>(
        pos, S, A, OA, range, use_range, order, valid);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: FrontPtrs' fields in order; ints: A, S, O, OA, OD, M, n, mode,
// size_growth, use_guard; flts: dt, reset, guard
extern "C" int step_front_launch(void* const* ptrs, const int* ints, const float* flts,
                                 cudaStream_t stream) {
  FrontArgs a;
  static_assert(sizeof(FrontPtrs) == 33 * sizeof(void*), "FrontPtrs: 33 pointers");
  memcpy(&a.p, ptrs, sizeof(FrontPtrs));
  a.A = ints[0]; a.S = ints[1]; a.O = ints[2]; a.OA = ints[3]; a.OD = ints[4];
  a.M = ints[5]; a.n = ints[6]; a.mode = ints[7]; a.size_growth = ints[8]; a.use_guard = ints[9];
  a.dt = flts[0]; a.reset = flts[1]; a.guard = flts[2];
  if (a.A < 1 || a.S < 1 || a.A % a.S || a.O < 1 || a.O > kMaxSlots || a.OA < 0 || a.OD < 0 ||
      a.OA + a.OD > a.O || a.M < 1 || a.n < 1)
    return cudaErrorInvalidValue;
  step_front_kernel<<<a.A, kBlockThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: GoalPtrs' fields in order; ints: A, O, M, N, dim, phi, R, goal,
// use_sfc, use_comm, past_seq; flts: dt, Mdt, tiny, qp_margin, comm_box,
// comm_half, dl_vel
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
