// The CLSC construction and the closest point of a convex hull to the origin,
// for NVIDIA Hopper (sm_90a). Two entries share one device function for the
// hull enumeration (`hull_query`):
//
// - clsc_build_launch: the whole of lsc_dr_planner_tpu_torch/ops/lsc.py::
//   build_clsc (the JAX package's lsc_dr_planner_tpu/ops/lsc.py:129, jnp that
//   XLA fused on the TPU; no Pallas original) in one launch, one thread per
//   (agent, neighbour, segment) hull: the pairwise downwash, the z-scaling of
//   both control-point sets and their difference, the hull query and
//   normal_poly / margins_poly; the thread of segment M−1 also computes the
//   segment-to-segment construction (closest_between_segments, normal_last,
//   margin_last), the feasibility guard clsc_ok and the selects of segment
//   M−1; every thread then scales its normal back to world coordinates, masks
//   it and writes normals [A,O,M,3], anchors [A,O,M,N,3] and margins
//   [A,O,M,N]. Where the plain body issues ~106 host-issued ops around the
//   query, this is one launch and no host read.
// - hull_closest_launch: the query alone, one thread per hull (build_lsc's;
//   the JAX package's lsc_dr_planner_tpu/ops/geometry.py:192
//   closest_point_origin_to_hull, no Pallas original).
//
// Both equal their plain versions (ops/lsc.py::build_clsc's torch body and
// ops/geometry.py::closest_point_origin_to_hull_plain) bit for bit. The query:
// the K vertices, then the C(K,2) edges and C(K,3) triangles in
// itertools.combinations order as candidates, the first candidate of least
// squared norm (strict <, as torch.argmin and jnp.argmin take the first
// minimum; a NaN norm counts as the least), its norm; then the C(K,4)
// origin-in-tetrahedron tests, each stopped at its first failing sign test
// (the test is "any tetrahedron passes", so stopping early changes no
// result), and +0 for the point and the distance where one passes. Every float
// operation is the plain version's, in its order, each rounded on its own:
// __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn keep nvcc from
// contracting a*b + c into a fused multiply-add (torch runs each op as its own
// kernel, so the plain version never fuses); 3-term sums associate as
// (x0*y0 + x1*y1) + x2*y2 (geometry.py::_dot3, which the plain body also uses
// for the projections and the segment construction); cross products round as
// geometry.py::_cross (the fused multiply-add of torch.linalg.cross and XLA on
// the CPU, through float64); norms are correctly rounded square roots (the
// plain versions', through float64). The triangle's Voronoi query keeps the
// plain version's precedence (vertex a, b, c, edge ab, ac, bc, the interior)
// and computes only the point it selects. IEEE operations are odd under
// points -> -points, so the query keeps the plain version's exact oddness.
//
// The layout. Two kinds of build: a template build for each K from 1 to 8,
// one thread per hull, the hull's K points in registers (no register array is
// indexed at run time; K = 8 already takes 202 and 222 registers), and one
// run-time build for any K, the points read from the block's shared stage, a
// row of 3K floats padded to an odd count, so a warp's 32 rows fall in 32
// banks (CLSC's relative points get rows of their own there and its margins a
// row of K), one thread per hull too (hull_query_rt: the same loops at run
// time). The run-time builds test no tetrahedron of a flat hull (every
// relative z = ±0): each would fail at its first volume (flat_hull). The
// query's build makes that test per hull, so a batch of 2-D and 3-D hulls
// takes both; CLSC's makes it for the launch, in 2-D. The template takes K
// <= 8 (CLSC: where its stage also fits in 48 KB), the run-time build every
// other K, its shared memory sized at launch (opted in past 48 KB; a stage
// past the card's 227 KB a block is refused). A block of 128 hulls first
// stages its hulls' points (for CLSC the neighbours' [hulls, K, 3] floats and
// the [M, K, 3] initial control points of the agents the block spans, each
// agent's once) in shared memory with unit-stride, coalesced loads, where a
// hull's own loads would stride 12·K bytes from thread to thread; CLSC's
// outputs go back through shared memory too (the anchors are the
// neighbours' points, overwritten for segment M−1 where the guard holds), so
// every global store is unit-stride. A thread per hull, not a warp per
// (agent, neighbour) pair: a pair has M = 10 hulls, so a warp per pair leaves
// 22 of 32 lanes idle through the enumeration; measured and dropped, it ran
// 2.0x slower (0.112 against 0.055 ms at the main path's call, PERF.md
// section 6).
//
// What bounds it, measured on an NVIDIA H100 80GB HBM3 at 700.00 W (nvidia-smi
// --query-gpu=name,power.limit; chip_smoke.py's clsc_timing, hull_timing and
// fronts_ab; PERF.md section 6). CLSC at the main path's call (A = 1024, O =
// 16, M = 10, N = 6): each of 16,384 pairs reads 720 B of neighbour points
// and writes 1,080 B of anchors, normals and margins, each of 1,024 agents
// reads 720 B once: ~30.6 MB, 0.0091 ms at 3.35 TB/s; its least operations
// (670 a hull, chip_smoke.py::clsc_bound) take 0.0016 ms. The kernel takes
// 0.055 ms (16.5% of the bound; 0.071 ms in 3-D), where the earlier
// construction (the query's launch among ~106 torch ops) took ~2 ms, most of
// it the host issuing ops for 0.41 ms of device work. The query alone takes
// 0.032 ms on the same 2-D hulls (0.0043 ms bound: 88 bytes a hull) and
// 0.044 ms in 3-D. Both do more than the least work by design: the
// operations rounded on their own take one instruction each where the peak
// counts a fused multiply-add as two, each IEEE division is a
// multi-instruction sequence, 128 registers (K = 6) leave 16 warps an SM, and
// a warp runs a tetrahedron's volumes as far as its slowest hull's test goes.
// The run-time builds at N = 9 (phase 8h, 163,840 2-D hulls: 36 edges, 84
// triangles and 126 tetrahedra each, every tetrahedron a cross product
// through float64 that fails at its first volume in 2-D): CLSC 0.121 ms with
// them left out (0.176 with them; 80 registers and 196 B of spills); the
// query 0.078 ms with them left out (0.138 with them), its registers capped
// at 64 by 8 blocks of 128 an SM, where 1,280 blocks then run in 1.2 rounds
// (48 registers and 10 blocks, one round: 0.082 ms with 460 B of spills; 64
// hulls a block, 16 an SM: 0.078; chip_smoke.py::hull_rt_variants_main). A
// group of 4 lanes a hull took 0.142 ms in CLSC's build, and 11% more than
// the thread a hull on the 3-D fleet's hulls at N = 9 (a group's lanes share
// a warp instruction's 32 slots among 8 hulls, so a hull's own work costs 4
// of them), so the run-time builds keep a thread a hull (PERF.md section 6).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;     // hulls per block (thread per hull)
// the query's run-time build: hulls a block, and the blocks an SM its
// registers are capped for (__launch_bounds__: 64 registers, no spill)
constexpr int kRtHulls = 128;
constexpr int kRtMinBlocks = 8;
constexpr float kEps = 1e-12f;    // geometry.py's _EPS, as torch casts it to float32
constexpr float kVolEps = 1e-10f; // _origin_in_tetra's volume test
constexpr float kEpsF = 1e-6f;    // lsc.py's _EPS_F
constexpr float kGuard = 1e-4f;   // build_clsc's feasibility slack

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)}; }
__device__ __forceinline__ V3 neg3(V3 a) { return {-a.x, -a.y, -a.z}; }
// a + t·d, the product rounded first
__device__ __forceinline__ V3 axpy(V3 a, float t, V3 d) {
  return {add(a.x, mul(t, d.x)), add(a.y, mul(t, d.y)), add(a.z, mul(t, d.z))};
}
// (a0·b0 + a1·b1) + a2·b2, as geometry.py::_dot3
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
// a·b − c·d with c·d rounded and a·b not, then rounded once, through float64
// (a float32 product is exact there), as geometry.py::_cross
__device__ __forceinline__ float fms(float a, float b, float c, float d) {
  const double ab = __dmul_rn(static_cast<double>(a), static_cast<double>(b));
  return __double2float_rn(__dsub_rn(ab, static_cast<double>(mul(c, d))));
}
// u × v, as geometry.py::_cross
__device__ __forceinline__ V3 cross3(V3 u, V3 v) {
  return {fms(u.y, v.z, u.z, v.y), fms(u.z, v.x, u.x, v.z), fms(u.x, v.y, u.y, v.x)};
}
// torch.clamp(x, min=lo), torch.clamp(x, 0, 1): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp01(float x) { return x != x ? x : fminf(fmaxf(x, 0.f), 1.f); }
// t / clamp(den, min=_EPS), clamped to [0, 1]
__device__ __forceinline__ float ratio01(float t, float den) { return clamp01(div(t, clamp_min(den, kEps))); }
// v / clamp(n, min=_EPS_F), per component
__device__ __forceinline__ V3 unit(V3 v, float n) {
  const float d = clamp_min(n, kEpsF);
  return {div(v.x, d), div(v.y, d), div(v.z, d)};
}

// geometry.py::closest_point_on_segment(0, a, b)
__device__ __forceinline__ V3 segment_closest(V3 a, V3 b) {
  const V3 ab = sub3(b, a);
  const float denom = dot3(ab, ab);
  const V3 pa = {sub(0.f, a.x), sub(0.f, a.y), sub(0.f, a.z)};  // p - a with p = 0
  const float t = denom <= kEps ? 0.f : ratio01(dot3(pa, ab), denom);
  return axpy(a, t, ab);
}

// geometry.py::_closest_on_triangle_to_origin
__device__ __forceinline__ V3 triangle_closest(V3 a, V3 b, V3 c) {
  const V3 ab = sub3(b, a), ac = sub3(c, a);
  const V3 ap = neg3(a), bp = neg3(b), cp = neg3(c);
  const float d1 = dot3(ab, ap), d2 = dot3(ac, ap);
  const float d3 = dot3(ab, bp), d4 = dot3(ac, bp);
  const float d5 = dot3(ab, cp), d6 = dot3(ac, cp);
  const float vc = sub(mul(d1, d4), mul(d3, d2));
  const float vb = sub(mul(d5, d2), mul(d1, d6));
  const float va = sub(mul(d3, d6), mul(d5, d4));
  const float d43 = sub(d4, d3), d56 = sub(d5, d6);
  if (d1 <= 0.f && d2 <= 0.f) return a;                           // in_a
  if (d3 >= 0.f && d4 <= d3) return b;                            // in_b
  if (d6 >= 0.f && d5 <= d6) return c;                            // in_c
  if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) return axpy(a, ratio01(d1, sub(d1, d3)), ab);  // on_ab
  if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) return axpy(a, ratio01(d2, sub(d2, d6)), ac);  // on_ac
  if (va <= 0.f && d43 >= 0.f && d56 >= 0.f)                      // on_bc
    return axpy(b, ratio01(d43, add(d43, d56)), sub3(c, b));
  const float denom = clamp_min(add(add(va, vb), vc), kEps);      // the interior
  return axpy(axpy(a, div(vb, denom), ab), div(vc, denom), ac);
}

// geometry.py::_origin_in_tetra's signed_vol(p0, p1, p2, p3)
__device__ __forceinline__ float signed_vol(V3 p0, V3 p1, V3 p2, V3 p3) {
  return dot3(sub3(p1, p0), cross3(sub3(p2, p0), sub3(p3, p0)));
}

// geometry.py::_origin_in_tetra, each volume computed only if every test
// before it passed
__device__ __forceinline__ bool origin_in_tetra(V3 a, V3 b, V3 c, V3 d) {
  const V3 o = {0.f, 0.f, 0.f};
  const float v0 = signed_vol(a, b, c, d);
  if (!(fabsf(v0) > kVolEps)) return false;
  const bool pos = v0 > 0.f;
  auto same = [pos](float v) { return pos ? v >= -kVolEps : v <= kVolEps; };
  return same(signed_vol(o, b, c, d)) && same(signed_vol(a, o, c, d)) &&
         same(signed_vol(a, b, o, d)) && same(signed_vol(a, b, c, o));
}

// The running first minimum of the squared norm over the candidates, with
// torch.argmin's rule for NaN: a NaN is less than any number, and the first
// NaN stays.
struct Best {
  V3 p;
  float d2;
  __device__ __forceinline__ void consider(V3 q) {
    const float d = dot3(q, q);
    if (d < d2 || (d != d && d2 == d2)) {
      d2 = d;
      p = q;
    }
  }
};

// The closest point of conv(p[0..K-1]) to the origin and its distance.
template <int K>
__device__ __forceinline__ void hull_query(const V3 (&p)[K], V3& closest, float& dist) {
  Best best{p[0], dot3(p[0], p[0])};
#pragma unroll
  for (int i = 1; i < K; ++i) best.consider(p[i]);
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = i + 1; j < K; ++j) best.consider(segment_closest(p[i], p[j]));
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = i + 1; j < K; ++j)
#pragma unroll
      for (int k = j + 1; k < K; ++k) best.consider(triangle_closest(p[i], p[j], p[k]));

  bool inside = false;
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = i + 1; j < K; ++j)
#pragma unroll
      for (int k = j + 1; k < K; ++k)
#pragma unroll
        for (int l = k + 1; l < K; ++l) inside = inside || origin_in_tetra(p[i], p[j], p[k], p[l]);

  if (inside) best = {{0.f, 0.f, 0.f}, 0.f};
  closest = best.p;
  dist = __fsqrt_rn(best.d2);
}

// geometry.py::closest_between_segments(p1, p2, q1, q2): the closest points
// cp on [p1, p2] and cq on [q1, q2], and |cq − cp|
__device__ __forceinline__ void segments_closest(V3 p1, V3 p2, V3 q1, V3 q2, V3& cp, V3& cq,
                                                 float& dist) {
  const V3 d1 = sub3(p2, p1), d2 = sub3(q2, q1), r = sub3(p1, q1);
  const float a = dot3(d1, d1), e = dot3(d2, d2), f = dot3(d2, r), c = dot3(d1, r),
              b = dot3(d1, d2);
  const float denom = sub(mul(a, e), mul(b, b));
  const float s_gen = clamp01(div(sub(mul(b, f), mul(c, e)), clamp_min(denom, kEps)));
  float s = denom > mul(kEps, clamp_min(mul(a, e), 1.f)) ? s_gen : 0.f;
  s = a <= kEps ? 0.f : s;
  const float t = div(add(mul(b, s), f), clamp_min(e, kEps));
  const float tc = clamp01(t);
  const float s2 = clamp01(div(sub(mul(b, tc), c), clamp_min(a, kEps)));
  s = a <= kEps ? 0.f : (t == tc ? s : s2);
  cp = axpy(p1, s, d1);
  cq = axpy(q1, e <= kEps ? 0.f : tc, d2);
  const V3 dd = sub3(cq, cp);
  dist = __fsqrt_rn(dot3(dd, dd));
}

// ---- hull_closest: the query alone --------------------------------------------
template <int K>
__global__ void __launch_bounds__(kThreads)
    hull_closest_kernel(const float* __restrict__ pts, long long H, float* __restrict__ closest,
                        float* __restrict__ dist) {
  __shared__ float tile[kThreads * 3 * K];
  const long long h0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int n = static_cast<int>(min(static_cast<long long>(kThreads), H - h0));
  const float* src = pts + h0 * (3 * K);
  for (int i = threadIdx.x; i < n * 3 * K; i += kThreads) tile[i] = __ldg(src + i);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= n) return;
  const float* q = tile + threadIdx.x * (3 * K);
  V3 p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) p[k] = {q[3 * k], q[3 * k + 1], q[3 * k + 2]};
  V3 c;
  float d;
  hull_query<K>(p, c, d);
  const long long h = h0 + threadIdx.x;
  closest[3 * h] = c.x;
  closest[3 * h + 1] = c.y;
  closest[3 * h + 2] = c.z;
  dist[h] = d;
}

// ---- clsc_build: the whole CLSC construction ----------------------------------
struct ClscArgs {
  const float* init;            // [A, M, K, 3] initial control points
  const float* obs;             // [A, O, M, K, 3] neighbours' control points
  const float* obs_goal;        // [A, O, 3]
  const float* agent_radius;    // [A]
  const float* agent_downwash;  // [A]
  const float* obs_radius;      // [A, O]
  const float* obs_downwash;    // [A, O]
  const unsigned char* obs_is_agent;  // [A, O] bool
  const float* current_goal;    // [A, 3]
  const unsigned char* obs_mask;      // [A, O] bool
  long long A;
  int O, M;
  int dim3;                     // world_dimension == 3 (else no downwash transform)
  float* normals;               // [A, O, M, 3]
  float* anchors;               // [A, O, M, K, 3]
  float* margins;               // [A, O, M, K]
};

__device__ __forceinline__ V3 load3(const float* p) { return {__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }
// _z_scale: z / dw, which leaves z as it is in 2-D (dw = 1: x / 1 is x in IEEE
// arithmetic, so the division is skipped there)
__device__ __forceinline__ V3 zscale(V3 v, float dw, bool dim3) {
  return {v.x, v.y, dim3 ? div(v.z, dw) : v.z};
}

template <int K>
__global__ void __launch_bounds__(kThreads) clsc_build_kernel(ClscArgs g) {
  __shared__ float obs_tile[kThreads * 3 * K];  // the block's hulls, then their anchors
  __shared__ float margin_tile[kThreads * K];
  __shared__ float normal_tile[kThreads * 3];
  extern __shared__ float init_tile[];          // [agents the block spans, M, K, 3]

  const long long OM = static_cast<long long>(g.O) * g.M;
  const long long H = g.A * OM;
  // the block's first hull and count; this thread's hull in the block (-1: none)
  const long long h0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int nh = static_cast<int>(min(static_cast<long long>(kThreads), H - h0));
  const int my = static_cast<int>(threadIdx.x) < nh ? static_cast<int>(threadIdx.x) : -1;
  const long long a0 = h0 / OM;
  const int na = static_cast<int>((h0 + nh - 1) / OM - a0 + 1);
  const int MK3 = g.M * K * 3;
  {
    const float* src = g.obs + h0 * (3 * K);
    for (int i = threadIdx.x; i < nh * 3 * K; i += blockDim.x) obs_tile[i] = __ldg(src + i);
    const float* isrc = g.init + a0 * MK3;
    for (int i = threadIdx.x; i < na * MK3; i += blockDim.x) init_tile[i] = __ldg(isrc + i);
  }
  __syncthreads();

  if (my >= 0) {
    const long long h = h0 + my, pair = h / g.M, a = pair / g.O;
    const int m = static_cast<int>(h - pair * g.M);
    const float ar = __ldg(g.agent_radius + a), ad = __ldg(g.agent_downwash + a);
    const float orad = __ldg(g.obs_radius + pair), od = __ldg(g.obs_downwash + pair);
    const float den = add(ar, orad);
    // downwash_between
    const float dw = g.obs_is_agent[pair] ? div(add(mul(ad, ar), mul(od, orad)), den)
                                          : div(add(ar, mul(od, orad)), den);
    const bool d3 = g.dim3;
    const float* ob = obs_tile + my * (3 * K);
    const float* in = init_tile + ((a - a0) * g.M + m) * (3 * K);
    V3 rel[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const V3 it = zscale({in[3 * k], in[3 * k + 1], in[3 * k + 2]}, dw, d3);
      const V3 ot = zscale({ob[3 * k], ob[3 * k + 1], ob[3 * k + 2]}, dw, d3);
      rel[k] = sub3(it, ot);
    }
    V3 closest;
    float dist;
    hull_query<K>(rel, closest, dist);
    V3 normal = unit(closest, dist);
    float marg[K];
#pragma unroll
    for (int k = 0; k < K; ++k) marg[k] = mul(0.5f, add(den, dot3(rel[k], normal)));

    if (m == g.M - 1) {
      // the last segment: (obs end → obs goal) against (agent end → agent goal)
      const V3 obs_last = zscale({ob[3 * K - 3], ob[3 * K - 2], ob[3 * K - 1]}, dw, d3);
      const V3 agent_last = zscale({in[3 * K - 3], in[3 * K - 2], in[3 * K - 1]}, dw, d3);
      const V3 og = zscale(load3(g.obs_goal + 3 * pair), dw, d3);
      const V3 cg = zscale(load3(g.current_goal + 3 * a), dw, d3);
      V3 cp, cq;
      float seg;
      segments_closest(obs_last, og, agent_last, cg, cp, cq, seg);
      const V3 nl = unit(sub3(cq, cp), seg);
      const float ml = mul(0.5f, add(den, seg));
      const float floor_ = sub(ml, kGuard);
      bool ok = true;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const V3 it = zscale({in[3 * k], in[3 * k + 1], in[3 * k + 2]}, dw, d3);
        ok = ok && dot3(sub3(it, cp), nl) >= floor_;
      }
      if (ok) {  // clsc_ok: the segment plane, anchored at the obstacle-side point
        normal = nl;
        float* an = obs_tile + my * (3 * K);  // this thread's own slot only
#pragma unroll
        for (int k = 0; k < K; ++k) {
          marg[k] = ml;
          an[3 * k] = cp.x;
          an[3 * k + 1] = cp.y;
          an[3 * k + 2] = cp.z;
        }
      }
    }
    // _to_world_normal (the pair's own downwash), then the mask
    const bool keep = g.obs_mask[pair];
    normal_tile[3 * my] = keep ? normal.x : 0.f;
    normal_tile[3 * my + 1] = keep ? normal.y : 0.f;
    normal_tile[3 * my + 2] = keep ? div(normal.z, dw) : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) margin_tile[my * K + k] = marg[k];
  }
  __syncthreads();
  float* an = g.anchors + h0 * (3 * K);
  for (int i = threadIdx.x; i < nh * 3 * K; i += blockDim.x) an[i] = obs_tile[i];
  float* mg = g.margins + h0 * K;
  for (int i = threadIdx.x; i < nh * K; i += blockDim.x) mg[i] = margin_tile[i];
  float* nm = g.normals + h0 * 3;
  for (int i = threadIdx.x; i < nh * 3; i += blockDim.x) nm[i] = normal_tile[i];
}

// ---- the run-time builds: any N, the points read from shared memory -----------
// A hull's points stay in the block's stage and each is read from there where
// the enumeration needs it (three shared loads a point; a register array of N
// points is what caps the template builds). A hull's stage row is 3N floats,
// padded to an odd count: the 32 threads of a warp then read 32 distinct banks.
__host__ __device__ __forceinline__ int odd_floats(int f) { return f | 1; }

__device__ __forceinline__ V3 point(const float* q, int i) {
  return {q[3 * i], q[3 * i + 1], q[3 * i + 2]};
}

// Whether every one of the K points at q has z = ±0 (2-D). Then every tetrahedron's volume is ±0 or NaN (the x and y
// parts of the cross product are ±0·y or NaN), so every origin_in_tetra
// fails at its first volume, and leaving the tests out changes no result.
__device__ __forceinline__ bool flat_hull(const float* q, int K) {
  bool flat = true;
  for (int i = 0; i < K; ++i) flat = flat && q[3 * i + 2] == 0.f;
  return flat;
}

// hull_query over the K points at q, the loops at run time in the same
// itertools.combinations order, the same device functions, the same first
// minimum and the same early stop of the tetrahedra. SkipFlat (the query's
// run-time build, and CLSC's in 2-D): where every point has z = ±0, no
// tetrahedron is tested (every test would fail at its first volume: see
// flat_hull).
template <bool SkipFlat = false>
__device__ __forceinline__ void hull_query_rt(const float* q, int K, V3& closest, float& dist) {
  const V3 p0 = point(q, 0);
  Best best{p0, dot3(p0, p0)};
  for (int i = 1; i < K; ++i) best.consider(point(q, i));
  for (int i = 0; i < K; ++i) {
    const V3 a = point(q, i);
    for (int j = i + 1; j < K; ++j) best.consider(segment_closest(a, point(q, j)));
  }
  for (int i = 0; i < K; ++i) {
    const V3 a = point(q, i);
    for (int j = i + 1; j < K; ++j) {
      const V3 b = point(q, j);
      for (int k = j + 1; k < K; ++k) best.consider(triangle_closest(a, b, point(q, k)));
    }
  }
  bool inside = false;
  const bool skip = SkipFlat && flat_hull(q, K);
  for (int i = 0; i < K && !inside && !skip; ++i) {
    const V3 a = point(q, i);
    for (int j = i + 1; j < K && !inside; ++j) {
      const V3 b = point(q, j);
      for (int k = j + 1; k < K && !inside; ++k) {
        const V3 c = point(q, k);
        for (int l = k + 1; l < K && !inside; ++l) inside = origin_in_tetra(a, b, c, point(q, l));
      }
    }
  }
  if (inside) best = {{0.f, 0.f, 0.f}, 0.f};
  closest = best.p;
  dist = __fsqrt_rn(best.d2);
}

// rows of `cols` floats from src (contiguous) into dst at a stride of `stride`
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int rows,
                                           int cols, int stride) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    dst[r * stride + i - r * cols] = __ldg(src + i);
  }
}

// the query's run-time build: a thread a hull, each hull's tetrahedra left
// out where it is flat (flat_hull: a test per hull, so a batch of 2-D and
// 3-D hulls takes both)
__global__ void __launch_bounds__(kRtHulls, kRtMinBlocks)
    hull_closest_rt_kernel(const float* __restrict__ pts, long long H, int K,
                           float* __restrict__ closest, float* __restrict__ dist) {
  extern __shared__ float hull_tile[];  // [kRtHulls, S]
  const int K3 = 3 * K, S = odd_floats(K3);
  const long long h0 = static_cast<long long>(blockIdx.x) * kRtHulls;
  const int n = static_cast<int>(min(static_cast<long long>(kRtHulls), H - h0));
  stage_rows(hull_tile, pts + h0 * K3, n, K3, S);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= n) return;
  V3 c;
  float d;
  hull_query_rt<true>(hull_tile + threadIdx.x * S, K, c, d);
  const long long h = h0 + threadIdx.x;
  closest[3 * h] = c.x;
  closest[3 * h + 1] = c.y;
  closest[3 * h + 2] = c.z;
  dist[h] = d;
}

// the run-time CLSC build's shared memory, in floats: the hulls' points (then
// their anchors) and their relative points, a row of S each; the margins, a
// row of odd_floats(K) each; the normals; the initial points of the agents
// the block spans, a row of S a segment
struct ClscRtLayout {
  int S, KS;
  long long rel, margin, normal, init, floats;
};

__host__ __device__ inline ClscRtLayout clsc_rt_layout(int K, int M, long long na) {
  ClscRtLayout l;
  l.S = odd_floats(3 * K);
  l.KS = odd_floats(K);
  l.rel = static_cast<long long>(kThreads) * l.S;
  l.margin = l.rel + static_cast<long long>(kThreads) * l.S;
  l.normal = l.margin + static_cast<long long>(kThreads) * l.KS;
  l.init = l.normal + kThreads * 3;
  l.floats = l.init + na * M * l.S;
  return l;
}

// clsc_build_kernel with the points read from shared memory, a thread a hull:
// the same operations in the same order (the relative points to the rel
// rows; each margin to the margin rows where the template keeps it in a
// register); in 2-D the flat hulls' tetrahedra left out (flat_hull)
__global__ void __launch_bounds__(kThreads) clsc_build_rt_kernel(ClscArgs g, int K, int na_max) {
  extern __shared__ float clsc_smem[];
  const ClscRtLayout L = clsc_rt_layout(K, g.M, na_max);
  const int S = L.S, KS = L.KS, K3 = 3 * K;
  float* obs_tile = clsc_smem;  // the block's hulls, then their anchors
  float* rel_tile = clsc_smem + L.rel;
  float* margin_tile = clsc_smem + L.margin;
  float* normal_tile = clsc_smem + L.normal;
  float* init_tile = clsc_smem + L.init;

  const long long OM = static_cast<long long>(g.O) * g.M;
  const long long H = g.A * OM;
  const long long h0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int nh = static_cast<int>(min(static_cast<long long>(kThreads), H - h0));
  const int my = static_cast<int>(threadIdx.x) < nh ? static_cast<int>(threadIdx.x) : -1;
  const long long a0 = h0 / OM;
  const int na = static_cast<int>((h0 + nh - 1) / OM - a0 + 1);
  stage_rows(obs_tile, g.obs + h0 * K3, nh, K3, S);
  stage_rows(init_tile, g.init + a0 * g.M * K3, na * g.M, K3, S);
  __syncthreads();

  if (my >= 0) {
    const long long h = h0 + my, pair = h / g.M, a = pair / g.O;
    const int m = static_cast<int>(h - pair * g.M);
    const float ar = __ldg(g.agent_radius + a), ad = __ldg(g.agent_downwash + a);
    const float orad = __ldg(g.obs_radius + pair), od = __ldg(g.obs_downwash + pair);
    const float den = add(ar, orad);
    // downwash_between
    const float dw = g.obs_is_agent[pair] ? div(add(mul(ad, ar), mul(od, orad)), den)
                                          : div(add(ar, mul(od, orad)), den);
    const bool d3 = g.dim3;
    const float* ob = obs_tile + my * S;
    const float* in = init_tile + ((a - a0) * g.M + m) * S;
    float* rel = rel_tile + my * S;
    float* marg = margin_tile + my * KS;
    for (int k = 0; k < K; ++k) {
      const V3 r = sub3(zscale(point(in, k), dw, d3), zscale(point(ob, k), dw, d3));
      rel[3 * k] = r.x;
      rel[3 * k + 1] = r.y;
      rel[3 * k + 2] = r.z;
    }
    V3 closest;
    float dist;
    if (d3)
      hull_query_rt(rel, K, closest, dist);
    else
      hull_query_rt<true>(rel, K, closest, dist);
    V3 normal = unit(closest, dist);
    for (int k = 0; k < K; ++k) marg[k] = mul(0.5f, add(den, dot3(point(rel, k), normal)));

    if (m == g.M - 1) {
      // the last segment: (obs end → obs goal) against (agent end → agent goal)
      const V3 obs_last = zscale(point(ob, K - 1), dw, d3);
      const V3 agent_last = zscale(point(in, K - 1), dw, d3);
      const V3 og = zscale(load3(g.obs_goal + 3 * pair), dw, d3);
      const V3 cg = zscale(load3(g.current_goal + 3 * a), dw, d3);
      V3 cp, cq;
      float seg;
      segments_closest(obs_last, og, agent_last, cg, cp, cq, seg);
      const V3 nl = unit(sub3(cq, cp), seg);
      const float ml = mul(0.5f, add(den, seg));
      const float floor_ = sub(ml, kGuard);
      bool ok = true;
      for (int k = 0; k < K && ok; ++k)
        ok = dot3(sub3(zscale(point(in, k), dw, d3), cp), nl) >= floor_;
      if (ok) {  // clsc_ok: the segment plane, anchored at the obstacle-side point
        normal = nl;
        float* an = obs_tile + my * S;  // this thread's own row only
        for (int k = 0; k < K; ++k) {
          marg[k] = ml;
          an[3 * k] = cp.x;
          an[3 * k + 1] = cp.y;
          an[3 * k + 2] = cp.z;
        }
      }
    }
    // _to_world_normal (the pair's own downwash), then the mask
    const bool keep = g.obs_mask[pair];
    normal_tile[3 * my] = keep ? normal.x : 0.f;
    normal_tile[3 * my + 1] = keep ? normal.y : 0.f;
    normal_tile[3 * my + 2] = keep ? div(normal.z, dw) : 0.f;
  }
  __syncthreads();
  float* an = g.anchors + h0 * K3;
  for (int i = threadIdx.x; i < nh * K3; i += blockDim.x) {
    const int r = i / K3;
    an[i] = obs_tile[r * S + i - r * K3];
  }
  float* mg = g.margins + h0 * K;
  for (int i = threadIdx.x; i < nh * K; i += blockDim.x) {
    const int r = i / K;
    mg[i] = margin_tile[r * KS + i - r * K];
  }
  float* nm = g.normals + h0 * 3;
  for (int i = threadIdx.x; i < nh * 3; i += blockDim.x) nm[i] = normal_tile[i];
}

// ---- launches ------------------------------------------------------------------
constexpr size_t kStaticSmem = 48 * 1024;  // shared memory a block takes without opting in
constexpr size_t kMaxSmem = 232448;        // and at most, opted in (227 KB on sm_90)
constexpr int kTemplateMaxK = 8;           // the template builds: K = 1..8
constexpr int kErrSmem = -1;  // the launch's return where the stage passes kMaxSmem

// bytes of the run-time builds' dynamic shared memory, opted in past 48 KB
int rt_smem(const void* kernel, size_t bytes) {
  if (bytes > kMaxSmem) return kErrSmem;
  if (bytes <= kStaticSmem) return cudaSuccess;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

size_t hull_rt_bytes(int K) {
  return static_cast<size_t>(kRtHulls) * odd_floats(3 * K) * sizeof(float);
}

// agents a CLSC block spans at most: its hulls start anywhere in an agent's O·M
long long clsc_span(const ClscArgs& g) {
  const long long OM = static_cast<long long>(g.O) * g.M;
  const long long span = (kThreads - 1) / OM + 2;
  return span < g.A ? span : g.A;
}

// the template build's shared memory: its static tiles and the initial points
size_t clsc_template_bytes(const ClscArgs& g, int K) {
  const size_t smem = static_cast<size_t>(clsc_span(g)) * g.M * K * 3 * sizeof(float);
  return smem + (kThreads * 3 * K + kThreads * K + kThreads * 3) * sizeof(float);
}

size_t clsc_rt_bytes(const ClscArgs& g, int K) {
  return static_cast<size_t>(clsc_rt_layout(K, g.M, clsc_span(g)).floats) * sizeof(float);
}

// the template serves K <= 8 where its stage fits in 48 KB; the run-time
// build every other shape
bool clsc_is_rt(const ClscArgs& g, int K) {
  return K > kTemplateMaxK || clsc_template_bytes(g, K) > kStaticSmem;
}

template <int K>
void hull_launch(const float* pts, long long H, float* closest, float* dist, unsigned blocks,
                 cudaStream_t stream) {
  hull_closest_kernel<K><<<blocks, kThreads, 0, stream>>>(pts, H, closest, dist);
}

// blocks an SM of `kernel` at `threads` a block and `dyn` bytes of dynamic
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <class T>
int blocks_an_sm(T* kernel, size_t dyn, int* blocks_per_sm, int threads = kThreads) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, dyn));
}

template <int K>
void clsc_launch(const ClscArgs& g, unsigned blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(clsc_span(g)) * g.M * K * 3 * sizeof(float);
  clsc_build_kernel<K><<<blocks, kThreads, smem, stream>>>(g);
}

}  // namespace

// Shared memory bytes a block of the hull query of K-point hulls takes, and
// (*rt) whether the run-time build takes them (K > 8).
extern "C" long long hull_closest_smem(int K, int* rt) {
  *rt = K > kTemplateMaxK;
  return static_cast<long long>(*rt ? hull_rt_bytes(K) : kThreads * 3 * K * sizeof(float));
}

// Shared memory bytes a block of build_clsc takes at (A, O, M, N), and (*rt)
// whether the run-time build takes the shape.
extern "C" long long clsc_build_smem(long long A, int O, int M, int N, int* rt) {
  ClscArgs g{};
  g.A = A;
  g.O = O;
  g.M = M;
  *rt = clsc_is_rt(g, N);
  return static_cast<long long>(*rt ? clsc_rt_bytes(g, N) : clsc_template_bytes(g, N));
}

// The most shared memory a block may take (bytes): past it a launch returns -1.
extern "C" long long hull_max_smem() { return static_cast<long long>(kMaxSmem); }

// Blocks an SM of the query's build for K-point hulls (*hulls: the hulls a
// block), as cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them.
extern "C" int hull_closest_occupancy(int K, int* hulls, int* blocks_per_sm) {
  if (K < 1) return cudaErrorInvalidValue;
  *hulls = K > kTemplateMaxK ? kRtHulls : kThreads;
  switch (K) {
    case 1: return blocks_an_sm(hull_closest_kernel<1>, 0, blocks_per_sm);
    case 2: return blocks_an_sm(hull_closest_kernel<2>, 0, blocks_per_sm);
    case 3: return blocks_an_sm(hull_closest_kernel<3>, 0, blocks_per_sm);
    case 4: return blocks_an_sm(hull_closest_kernel<4>, 0, blocks_per_sm);
    case 5: return blocks_an_sm(hull_closest_kernel<5>, 0, blocks_per_sm);
    case 6: return blocks_an_sm(hull_closest_kernel<6>, 0, blocks_per_sm);
    case 7: return blocks_an_sm(hull_closest_kernel<7>, 0, blocks_per_sm);
    case 8: return blocks_an_sm(hull_closest_kernel<8>, 0, blocks_per_sm);
    default: {
      const size_t bytes = hull_rt_bytes(K);
      const int rc = rt_smem(reinterpret_cast<const void*>(hull_closest_rt_kernel), bytes);
      if (rc != cudaSuccess) return rc;
      return blocks_an_sm(hull_closest_rt_kernel, bytes, blocks_per_sm, kRtHulls);
    }
  }
}

// Blocks an SM of build_clsc's build at (A, O, M, N), as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them.
extern "C" int clsc_build_occupancy(long long A, int O, int M, int N, int* blocks_per_sm) {
  if (A < 1 || O < 1 || M < 1 || N < 1) return cudaErrorInvalidValue;
  ClscArgs g{};
  g.A = A;
  g.O = O;
  g.M = M;
  if (clsc_is_rt(g, N)) {
    const size_t bytes = clsc_rt_bytes(g, N);
    const int rc = rt_smem(reinterpret_cast<const void*>(clsc_build_rt_kernel), bytes);
    if (rc != cudaSuccess) return rc;
    return blocks_an_sm(clsc_build_rt_kernel, bytes, blocks_per_sm);
  }
  const size_t dyn = static_cast<size_t>(clsc_span(g)) * M * N * 3 * sizeof(float);
  switch (N) {
    case 1: return blocks_an_sm(clsc_build_kernel<1>, dyn, blocks_per_sm);
    case 2: return blocks_an_sm(clsc_build_kernel<2>, dyn, blocks_per_sm);
    case 3: return blocks_an_sm(clsc_build_kernel<3>, dyn, blocks_per_sm);
    case 4: return blocks_an_sm(clsc_build_kernel<4>, dyn, blocks_per_sm);
    case 5: return blocks_an_sm(clsc_build_kernel<5>, dyn, blocks_per_sm);
    case 6: return blocks_an_sm(clsc_build_kernel<6>, dyn, blocks_per_sm);
    case 7: return blocks_an_sm(clsc_build_kernel<7>, dyn, blocks_per_sm);
    default: return blocks_an_sm(clsc_build_kernel<8>, dyn, blocks_per_sm);
  }
}

// Queues the query of H hulls of K points (pts: [H, K, 3] float32, contiguous;
// closest: [H, 3]; dist: [H]) on `stream`: one launch, no synchronisation.
// K <= 8 takes the template build of K, K > 8 the run-time build (*rt = 1).
// Returns the CUDA error code (0 on success), or -1 where the run-time
// build's stage passes the card's shared memory (hull_closest_smem).
extern "C" int hull_closest_launch(const float* pts, long long H, int K, float* closest,
                                   float* dist, int* rt, void* stream) {
  if (H < 1 || K < 1 || (H + kThreads - 1) / kThreads > INT_MAX) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((H + kThreads - 1) / kThreads);
  const unsigned rt_blocks = static_cast<unsigned>((H + kRtHulls - 1) / kRtHulls);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  *rt = K > kTemplateMaxK;
  switch (K) {
    case 1: hull_launch<1>(pts, H, closest, dist, blocks, s); break;
    case 2: hull_launch<2>(pts, H, closest, dist, blocks, s); break;
    case 3: hull_launch<3>(pts, H, closest, dist, blocks, s); break;
    case 4: hull_launch<4>(pts, H, closest, dist, blocks, s); break;
    case 5: hull_launch<5>(pts, H, closest, dist, blocks, s); break;
    case 6: hull_launch<6>(pts, H, closest, dist, blocks, s); break;
    case 7: hull_launch<7>(pts, H, closest, dist, blocks, s); break;
    case 8: hull_launch<8>(pts, H, closest, dist, blocks, s); break;
    default: {
      const size_t bytes = hull_rt_bytes(K);
      const int rc = rt_smem(reinterpret_cast<const void*>(hull_closest_rt_kernel), bytes);
      if (rc != cudaSuccess) return rc;
      hull_closest_rt_kernel<<<rt_blocks, kRtHulls, bytes, s>>>(pts, H, K, closest, dist);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Queues build_clsc of A agents, O neighbour slots, M segments of N control
// points (every array float32 or bool, contiguous, in build_clsc's shapes) on
// `stream`: one launch, no synchronisation. The template build of N serves N
// <= 8 where its stage fits in 48 KB, the run-time build every other shape
// (*rt = 1). Returns the CUDA error code (0 on success), or -1 where the
// run-time build's stage passes the card's shared memory (clsc_build_smem).
extern "C" int clsc_build_launch(const float* init, const float* obs, const float* obs_goal,
                                 const float* agent_radius, const float* agent_downwash,
                                 const float* obs_radius, const float* obs_downwash,
                                 const unsigned char* obs_is_agent, const float* current_goal,
                                 const unsigned char* obs_mask, long long A, int O, int M, int N,
                                 int world_dimension, float* normals, float* anchors,
                                 float* margins, int* rt, void* stream) {
  if (A < 1 || O < 1 || M < 1 || N < 1) return cudaErrorInvalidValue;
  ClscArgs g{init, obs, obs_goal, agent_radius, agent_downwash, obs_radius, obs_downwash,
             obs_is_agent, current_goal, obs_mask, A, O, M, world_dimension == 3,
             normals, anchors, margins};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (A * O * M + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const unsigned b = static_cast<unsigned>(blocks);
  *rt = clsc_is_rt(g, N);
  if (*rt) {
    const size_t bytes = clsc_rt_bytes(g, N);
    const int rc = rt_smem(reinterpret_cast<const void*>(clsc_build_rt_kernel), bytes);
    if (rc != cudaSuccess) return rc;
    clsc_build_rt_kernel<<<b, kThreads, bytes, s>>>(g, N, static_cast<int>(clsc_span(g)));
    return static_cast<int>(cudaGetLastError());
  }
  switch (N) {
    case 1: clsc_launch<1>(g, b, s); break;
    case 2: clsc_launch<2>(g, b, s); break;
    case 3: clsc_launch<3>(g, b, s); break;
    case 4: clsc_launch<4>(g, b, s); break;
    case 5: clsc_launch<5>(g, b, s); break;
    case 6: clsc_launch<6>(g, b, s); break;
    case 7: clsc_launch<7>(g, b, s); break;
    case 8: clsc_launch<8>(g, b, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
