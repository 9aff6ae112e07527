// Closest point of the convex hull of K points to the origin, one thread per
// hull, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's lsc_dr_planner_tpu/ops/geometry.py::
// closest_point_origin_to_hull (:192-237), a jnp enumeration that XLA fused on
// the TPU (it has no Pallas original). It computes what the plain version
// lsc_dr_planner_tpu_torch/ops/geometry.py::closest_point_origin_to_hull_plain
// computes, bit for bit: the K vertices, then the C(K,2) edges and the C(K,3)
// triangles in itertools.combinations order as candidates, each edge's and
// triangle's closest point to the origin by the plain version's formulas, the
// first candidate of least squared norm (strict <, as torch.argmin and
// jnp.argmin take the first minimum; a NaN norm counts as the least, as in
// torch.argmin), its norm; then the C(K,4)
// origin-in-tetrahedron tests, and +0 for the point and the distance where
// any passes. Every float operation is the plain version's, in its order, each
// rounded on its own: __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn keep
// nvcc from contracting a*b + c into a fused multiply-add (torch runs each op as
// its own kernel, so the plain version never fuses); the 3-term sums associate
// as (x0*y0 + x1*y1) + x2*y2 (geometry.py::_dot3); the cross products round as
// geometry.py::_cross does (the fused multiply-add of torch.linalg.cross and XLA
// on the CPU, through float64); the norm is a correctly rounded square root (the
// plain version's, through float64). The triangle's Voronoi query keeps the
// plain version's precedence (the last torch.where wins: vertex a, b, c, edge
// ab, ac, bc, then the interior) and computes only the point it selects; the
// clamps are the plain version's float32 _EPS = 1e-12 and the volume test's
// 1e-10. IEEE operations are odd under points -> -points, so the kernel keeps
// the plain version's exact oddness (a reciprocal pair gets mirrored normals).
//
// The layout. One thread per hull with its K points in registers (K is a
// template parameter, 1..8, so every loop unrolls and no register array is
// indexed at run time), the candidates and the running minimum in registers:
// one launch for the whole [A, O, M] batch and nothing materialised, where the
// plain version builds every candidate as its own [A, O, M, k, 3] tensor in
// about a hundred launches.
//
// What bounds it on the H100. A hull of 6 points is 88 bytes read and written,
// and its least work depends on its points (which Voronoi region each
// triangle's tests pick, which tetrahedra are degenerate): chip_smoke.py::hull_bound counts both
// on each run's hulls, and PERF.md section 6 gives the bound beside the
// kernel's time. The kernel does more than that least work by design: it
// computes every tetrahedron's five volumes in full, the rounded-on-their-own
// operations take one instruction each where the peak counts a fused
// multiply-add as two, each IEEE division is a multi-instruction sequence, and
// the point loads stride 12·K bytes a thread. A point layout with unit stride,
// a warp per hull and fusing the rest of build_clsc are later work.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;     // hulls per block
constexpr float kEps = 1e-12f;    // geometry.py's _EPS, as torch casts it to float32
constexpr float kVolEps = 1e-10f; // _origin_in_tetra's volume test

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

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
__device__ __forceinline__ float ratio01(float t, float den) {
  return clamp01(__fdiv_rn(t, clamp_min(den, kEps)));
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
  return axpy(axpy(a, __fdiv_rn(vb, denom), ab), __fdiv_rn(vc, denom), ac);
}

// geometry.py::_origin_in_tetra's signed_vol(p0, p1, p2, p3)
__device__ __forceinline__ float signed_vol(V3 p0, V3 p1, V3 p2, V3 p3) {
  return dot3(sub3(p1, p0), cross3(sub3(p2, p0), sub3(p3, p0)));
}

// geometry.py::_origin_in_tetra
__device__ __forceinline__ bool origin_in_tetra(V3 a, V3 b, V3 c, V3 d) {
  const V3 o = {0.f, 0.f, 0.f};
  const float v0 = signed_vol(a, b, c, d);
  if (!(fabsf(v0) > kVolEps)) return false;
  const float v1 = signed_vol(o, b, c, d), v2 = signed_vol(a, o, c, d);
  const float v3 = signed_vol(a, b, o, d), v4 = signed_vol(a, b, c, o);
  if (v0 > 0.f) return v1 >= -kVolEps && v2 >= -kVolEps && v3 >= -kVolEps && v4 >= -kVolEps;
  return v1 <= kVolEps && v2 <= kVolEps && v3 <= kVolEps && v4 <= kVolEps;
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

template <int K>
__global__ void __launch_bounds__(kThreads)
    hull_closest_kernel(const float* __restrict__ pts, long long H, float* __restrict__ closest,
                        float* __restrict__ dist) {
  const long long h = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (h >= H) return;
  const float* q = pts + h * (3 * K);
  V3 p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) p[k] = {__ldg(q + 3 * k), __ldg(q + 3 * k + 1), __ldg(q + 3 * k + 2)};

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
  closest[3 * h] = best.p.x;
  closest[3 * h + 1] = best.p.y;
  closest[3 * h + 2] = best.p.z;
  dist[h] = __fsqrt_rn(best.d2);
}

template <int K>
void launch(const float* pts, long long H, float* closest, float* dist, unsigned blocks,
            cudaStream_t stream) {
  hull_closest_kernel<K><<<blocks, kThreads, 0, stream>>>(pts, H, closest, dist);
}

}  // namespace

// Queues the query of H hulls of K points (pts: [H, K, 3] float32, contiguous;
// closest: [H, 3]; dist: [H]) on `stream`: one launch, no synchronisation.
// Returns the CUDA error code (0 on success).
extern "C" int hull_closest_launch(const float* pts, long long H, int K, float* closest,
                                   float* dist, void* stream) {
  if (H < 1 || (H + kThreads - 1) / kThreads > INT_MAX) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((H + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: launch<1>(pts, H, closest, dist, blocks, s); break;
    case 2: launch<2>(pts, H, closest, dist, blocks, s); break;
    case 3: launch<3>(pts, H, closest, dist, blocks, s); break;
    case 4: launch<4>(pts, H, closest, dist, blocks, s); break;
    case 5: launch<5>(pts, H, closest, dist, blocks, s); break;
    case 6: launch<6>(pts, H, closest, dist, blocks, s); break;
    case 7: launch<7>(pts, H, closest, dist, blocks, s); break;
    case 8: launch<8>(pts, H, closest, dist, blocks, s); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
