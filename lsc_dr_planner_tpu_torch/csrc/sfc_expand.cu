// Greedy Safe Flight Corridor box expansion, and the whole 'hull'-mode SFC
// update, for NVIDIA Hopper (sm_90a). Two entries share one device function
// for a lane's expansion (`expand`):
//
// - sfc_expand_launch: the expansion of L lanes in one launch (the 'point' and
//   'substep' modes, whose seeding and selection stay in torch). Replaces the
//   JAX package's lsc_dr_planner_tpu/ops/sfc.py::expand_box (:37-104), a
//   lax.while_loop vmapped over lanes that XLA kept on the TPU (no Pallas
//   original), and equals lsc_dr_planner_tpu_torch/ops/sfc.py::
//   expand_box_plain bit for bit (the results are integers).
// - sfc_update_hull_launch: ops/sfc.py::update_sfc(mode='hull') (the JAX
//   package's update_sfc_fused, lsc_dr_planner_tpu/ops/sfc.py:313, then
//   sfc_to_world) in one launch, one block of three warps per agent: the
//   three seeds (point_to_lattice_floor/ceil of the position; the
//   round-half-even seed of
//   {trajectory end, current goal, next waypoint}; the floor/ceil seed of
//   {trajectory end, current goal} intersected with the previous last box
//   unless that box holds it, `within_prev`), the three lanes' expansions in
//   the default direction order, one warp per lane, the `_superset_of` tests,
//   the choice of lane 1, else lane 2, else the previous last box, the shift
//   by one segment and the init_done select; it writes the lattice boxes, the
//   world boxes and the lanes (seeds, results, seed-free flags, for
//   sfc.last_lanes), and adds the call's longest lane's trips to the device
//   counter that sfc.read_lane_trips() reads (the last block to finish adds
//   the call's maximum; no host read). It equals the torch body of
//   update_sfc (_update_sfc_plain, then sfc_to_world) bit for bit: the seeds and world
//   boxes repeat every float operation of the plain version with _rn
//   intrinsics in its order (p / res, a true division on both devices as
//   world/grid.py pins it, then ± 1e-6; (idx + origin) · res; the margin
//   delta, computed on the host in float64 and rounded to float32 as torch
//   rounds a Python scalar), the integer parts wrap as int32 does.
//
// The expansion, per lane: the seed box's free test (the box count and the
// world bounds), then the round-robin greedy loop: take the next active
// direction of the lane's order from `ptr`, test one more cell along it (the
// world bounds and the radius clamp, then the 8-corner integral-image query),
// grow the box or retire the direction; the lane ends when no direction is
// active or after max_trips trips (min(4096, 6r + 6), 4096 when r = 0).
//
// The layout: a warp per lane that speculates on a chain of growths
// (`expand_lane_chain`, the path's design). With the lane's active directions
// fixed, its next trips take the active slots round-robin from ptr, so thread
// j of the warp computes, from its rank arithmetic alone, the state after j
// more trips that all grow the box, and issues the query of the trip after
// them; one __ballot_sync finds the first trip that fails or ends the lane,
// the round resolves it and the growths before it (up to 32 trips), and the
// thread that owns it broadcasts its state with __shfl_sync. A lane retires
// at most 6 directions, so a lane of T trips takes at most 6 + T / 32 rounds.
// The result is the sequential loop's by construction: each thread's query is
// the one the loop issues if every trip before it grew the box. The
// integral image (int32 [X+2, Y+2, Z+2], or [A, X+2, Y+2, Z+2] with each
// lane's agent choosing its image) is read through the read-only path; a
// query's 8 corners are independent loads. Box counts are summed in unsigned arithmetic, which
// wraps as torch's int32 sum does.
//
// What bounds it, measured on an NVIDIA H100 80GB HBM3 at 700.00 W (nvidia-smi
// --query-gpu=name,power.limit; chip_smoke.py::sfc_probe on the main path's
// 3,072 lanes, 376,372 lane-trips, the longest 193; PERF.md section 6): not
// bytes (each lane's seed query and at most 4 new corners a trip: ~6 MB, 0.002
// ms at 3.35 TB/s) but the chain of dependent trips and the loads the
// speculation issues. One L2 round trip takes 144 ns, one dependent 8-corner
// query 183 ns (1.27 round trips). A sequential trip takes 3.4 round trips for
// a lane alone (its dependent instructions around the query) and 5.0 with all
// lanes in flight (their uncoalesced gathers share the load units): 0.139 ms a
// call, as the earlier layout of one thread per lane. A binary tree of the
// next D trips' outcomes (a thread per node, 2^D - 1 queries a round, one
// ballot resolving D trips; measured and dropped, PERF.md section 6) took
// 0.093 ms at D = 2 down to 0.071 ms at D = 5: its loads bind. The chain
// issues 32 queries for up to 32 trips: 0.0165 ms, 0.0097 ms for the
// longest lane alone (about 12 rounds; the fused update 0.0206 ms).
// `l2_chase_kernel` and `query_chase_kernel` (measurement only, on no path)
// time the round trip and the query.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;   // lanes per block of the standalone expansion
constexpr unsigned kDefaultOrder = 0u | 1u << 3 | 2u << 6 | 3u << 9 | 4u << 12 | 5u << 15;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// One integral image: S[(x * SY + y) * SZ + z] (fewer than 2^31 entries)
struct Image {
  const int* S;
  int SX, SY, SZ;
};

// Blocked lattice points in the box b = (lo x, y, z, hi x, y, z) (inclusive),
// with the gather clamps of world/grid.py::box_blocked_count; 0: the box is free.
__device__ __forceinline__ unsigned box_count(const Image& im, const int (&b)[6]) {
  const int x0 = clampi(b[0], 0, im.SX - 2), y0 = clampi(b[1], 0, im.SY - 2),
            z0 = clampi(b[2], 0, im.SZ - 2);
  const int x1 = clampi(b[3] + 1, 0, im.SX - 1), y1 = clampi(b[4] + 1, 0, im.SY - 1),
            z1 = clampi(b[5] + 1, 0, im.SZ - 1);
  auto at = [&](int x, int y, int z) {
    return static_cast<unsigned>(__ldg(im.S + (x * im.SY + y) * im.SZ + z));
  };
  return at(x1, y1, z1) - at(x0, y1, z1) - at(x1, y0, z1) - at(x1, y1, z0) + at(x0, y0, z1) +
         at(x0, y1, z0) + at(x1, y0, z0) - at(x0, y0, z0);
}

// A lane's state: its box (lo x, y, z, hi x, y, z), its active directions (a
// bit per slot of its order), the slot to try next, the trips run
struct Lane {
  int b[6];
  unsigned active;
  int ptr, trips;
};

// v[d] without indexing a register array at run time
__device__ __forceinline__ int pick(const int (&v)[6], int d) {
  int r = v[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) r = d == i ? v[i] : r;
  return r;
}

// The first active slot in cyclic order from ptr (active != 0)
__device__ __forceinline__ int next_slot(unsigned active, int ptr) {
  const unsigned rot = ((active >> ptr) | (active << (6 - ptr))) & 0x3fu;
  const int s = ptr + __ffs(rot) - 1;
  return s >= 6 ? s - 6 : s;
}

__device__ __forceinline__ bool live(const Lane& s, int max_trips) {
  return s.active != 0u && s.trips < max_trips;
}

// One trip with a known outcome: grow the box along the slot's direction, or
// retire the slot
__device__ __forceinline__ void step(Lane& s, unsigned order, bool grow) {
  const int slot = next_slot(s.active, s.ptr);
  if (grow) {
    const int d = (order >> (3 * slot)) & 7u;
#pragma unroll
    for (int i = 0; i < 6; ++i) s.b[i] += d == i ? (i < 3 ? -1 : 1) : 0;
    s.ptr = slot == 5 ? 0 : slot + 1;
  } else {
    s.active &= ~(1u << slot);
    s.ptr = slot;
  }
  ++s.trips;
}

// The lane's expansion by the calling warp, speculating on a chain of growths:
// thread j takes the state after j more trips that all grow the box (with the
// active directions fixed, the k-th of them takes the active slot of rank k
// mod n in cyclic order from ptr, so the state follows from j in a few
// operations, without replaying the trips) and issues the next trip's query;
// one ballot finds the first trip that fails or ends the lane, and the round
// resolves it and every growth before it, up to 32 trips. A lane retires at
// most 6 directions, so most rounds end in a run of growths.
__device__ __forceinline__ void expand_lane_chain(Lane& s, unsigned order, const int (&lim)[6],
                                                  const Image& im, int max_trips) {
  const int j = threadIdx.x & 31;
  while (live(s, max_trips)) {
    const int n = __popc(s.active);
    const unsigned rot = ((s.active >> s.ptr) | (s.active << (6 - s.ptr))) & 0x3fu;
    const int q = j / n, rem = j % n, prev = (j + n - 1) % n;
    Lane t = s;
    int next = 0, last = 0, rank = 0;  // the slots of ranks rem and prev
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      if ((rot >> p) & 1u) {
        const int slot = s.ptr + p >= 6 ? s.ptr + p - 6 : s.ptr + p;
        const int d = (order >> (3 * slot)) & 7u;
        const int c = q + (rank < rem ? 1 : 0);  // this slot's growths in the first j trips
#pragma unroll
        for (int i = 0; i < 6; ++i) t.b[i] += d == i ? (i < 3 ? -c : c) : 0;
        next = rank == rem ? slot : next;
        last = rank == prev ? slot : last;
        ++rank;
      }
    }
    if (j > 0) t.ptr = last == 5 ? 0 : last + 1;
    t.trips += j;
    const bool on = live(t, max_trips);
    bool ok = false;
    if (on) {  // the next trip's query: one more cell along slot `next`'s direction
      const int d = (order >> (3 * next)) & 7u;
      const int cur = pick(t.b, d), lm = pick(lim, d);
      if (d < 3 ? cur > lm : cur < lm) {
        int nb[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) nb[i] = t.b[i] + (d == i ? (i < 3 ? -1 : 1) : 0);
        ok = box_count(im, nb) == 0u;
      }
    }
    const unsigned ok_m = __ballot_sync(kFull, on && ok);
    if (on) step(t, order, ok);  // the state after this node's own trip
    // the first trip that fails or ends the lane, else the 32nd growth
    const int src = ok_m == kFull ? 31 : __ffs(~ok_m) - 1;
#pragma unroll
    for (int i = 0; i < 6; ++i) s.b[i] = __shfl_sync(kFull, t.b[i], src);
    s.active = __shfl_sync(kFull, t.active, src);
    s.ptr = __shfl_sync(kFull, t.ptr, src);
    s.trips = __shfl_sync(kFull, t.trips, src);
  }
}

// A lane's start: its seed box, every direction active if the seed box is free
// and inside the world, and the direction limits. Returns seed_free.
__device__ __forceinline__ bool seed_lane(Lane& s, int (&lim)[6], const Image& im,
                                          const int (&lo)[3], const int (&hi)[3],
                                          const int (&dims)[3], int r) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.b[c] = lo[c];
    s.b[c + 3] = hi[c];
    lim[c] = r > 0 ? max(0, lo[c] - r) : 0;
    lim[c + 3] = r > 0 ? min(dims[c], hi[c] + r) : dims[c];
  }
  const bool ok = box_count(im, s.b) == 0u && lo[0] >= 0 && lo[1] >= 0 && lo[2] >= 0 &&
                  hi[0] <= dims[0] && hi[1] <= dims[1] && hi[2] <= dims[2];
  s.active = ok ? 0x3fu : 0u;
  s.ptr = 0;
  s.trips = 0;
  return ok;
}

// ---- sfc_expand: L lanes, a warp each ----------------------------------------
struct Args {
  const int* lo0;           // [L, 3] seed boxes (inclusive lattice ranges)
  const int* hi0;
  const long long* order;   // [L, 6] direction order per lane (0..2: -x,-y,-z; 3..5: +x,+y,+z)
  const long long* agent;   // [L] image of each lane, or null for one shared image
  const int* S;             // integral image(s)
  long long n_images;       // images in S (1 when shared)
  int L, X, Y, Z;           // lanes; the world's lattice dims (in-bounds: 0 <= lo, hi <= dims)
  int SX, SY, SZ;           // one image's shape (X+2, Y+2, Z+2)
  int r;                    // radius clamp in cells (0: none)
  int max_trips;
  int* lo;                  // [L, 3] results
  int* hi;
  unsigned char* seed_free; // [L] bool
};

__global__ void __launch_bounds__(kWarps * 32) sfc_expand_kernel(Args a) {
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= a.L) return;  // the whole warp
  Image im{a.S, a.SX, a.SY, a.SZ};
  if (a.agent) {
    const long long g = a.agent[i];
    if (g < 0 || g >= a.n_images) __trap();  // no image for this lane
    im.S += g * a.SX * a.SY * a.SZ;
  }
  unsigned order = 0;  // direction of slot k in bits 3k..3k+2
#pragma unroll
  for (int k = 0; k < 6; ++k) order |= static_cast<unsigned>(a.order[6 * i + k]) << (3 * k);
  const int lo[3] = {a.lo0[3 * i], a.lo0[3 * i + 1], a.lo0[3 * i + 2]};
  const int hi[3] = {a.hi0[3 * i], a.hi0[3 * i + 1], a.hi0[3 * i + 2]};
  const int dims[3] = {a.X, a.Y, a.Z};
  Lane s;
  int lim[6];
  const bool seed_ok = seed_lane(s, lim, im, lo, hi, dims, a.r);
  expand_lane_chain(s, order, lim, im, a.max_trips);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.lo[3 * i + c] = s.b[c];
      a.hi[3 * i + c] = s.b[c + 3];
    }
    a.seed_free[i] = seed_ok ? 1 : 0;
  }
}

// ---- sfc_update_hull: the 'hull'-mode update, a block per agent ----------------
struct HullArgs {
  const int* S;              // integral image [SX, SY, SZ], or one per agent
  long long image_stride;    // entries from one agent's image to the next (0: shared)
  int SX, SY, SZ;
  const int* sfc_lo;         // [A, M, 3] the boxes so far
  const int* sfc_hi;
  const unsigned char* init_done;  // [A] bool
  const float* last_pt;      // [A, 3] trajectory end
  const float* cgoal;        // [A, 3] current goal
  const float* wpt;          // [A, 3] next waypoint
  const float* pos;          // [A, 3] position
  long long stride[4];       // floats from one agent's row to the next: last_pt, cgoal, wpt, pos
  int M;
  int dims[3];               // lattice dims (X, Y, Z)
  int origin[3];             // lattice index 0 is at origin · res
  float res;
  float delta_sup;           // sfc_to_world's delta for the world's radius (_superset_of)
  float delta_world;         // ... for `margin` (the world boxes)
  int r, max_trips;
  int* lo;                   // [A, M, 3] new boxes
  int* hi;
  float* lo_w;               // [A, M, 3] their world boxes
  float* hi_w;
  int* seed_lo;              // [A, 3, 3] the lanes: seeds, results, seed-free flags
  int* seed_hi;
  int* lane_lo;
  int* lane_hi;
  unsigned char* lane_ok;    // [A, 3]
  long long* trips_total;    // [1] sum over calls of each call's longest lane's trips
  unsigned* scratch;         // [2] the call's longest lane so far, blocks done (0 between calls)
};

__device__ __forceinline__ float nan_min(float a, float b) { return a != a ? a : (b != b ? b : fminf(a, b)); }
__device__ __forceinline__ float nan_max(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }

// GridWorld.lattice_to_point of index v on axis c, then sfc_to_world's face shift
__device__ __forceinline__ float world_lo(const HullArgs& g, int v, int c, float delta) {
  const float p = __fmul_rn(__fadd_rn(static_cast<float>(v), static_cast<float>(g.origin[c])), g.res);
  return v > 0 ? __fsub_rn(p, delta) : p;
}
__device__ __forceinline__ float world_hi(const HullArgs& g, int v, int c, float delta) {
  const float p = __fmul_rn(__fadd_rn(static_cast<float>(v), static_cast<float>(g.origin[c])), g.res);
  return v < g.dims[c] ? __fadd_rn(p, delta) : p;
}

// _superset_of: every point inside the box's world box (delta_sup) to 1e-6
template <int N>
__device__ __forceinline__ bool superset(const HullArgs& g, const int* lo, const int* hi,
                                         const float (*pts)[3]) {
  bool in = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float l = __fsub_rn(world_lo(g, lo[c], c, g.delta_sup), 1e-6f);
    const float h = __fadd_rn(world_hi(g, hi[c], c, g.delta_sup), 1e-6f);
#pragma unroll
    for (int j = 0; j < N; ++j) in = in && pts[j][c] >= l && pts[j][c] <= h;
  }
  return in;
}

__global__ void __launch_bounds__(96) sfc_update_hull_kernel(HullArgs g) {
  __shared__ int e_lo[3][3], e_hi[3][3], e_ok[3], e_trips[3];
  const int a = blockIdx.x, w = threadIdx.x >> 5;
  const Image im{g.S + a * g.image_stride, g.SX, g.SY, g.SZ};
  // the agent's points: position, trajectory end, current goal, next waypoint
  float pts[4][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pts[0][c] = g.pos[g.stride[3] * a + c];
    pts[1][c] = g.last_pt[g.stride[0] * a + c];
    pts[2][c] = g.cgoal[g.stride[1] * a + c];
    pts[3][c] = g.wpt[g.stride[2] * a + c];
  }
  const int* prev_lo = g.sfc_lo + (3LL * g.M) * a + 3 * (g.M - 1);
  const int* prev_hi = g.sfc_hi + (3LL * g.M) * a + 3 * (g.M - 1);
  // this warp's seed: p / res, ± 1e-6, floor, ceil or round half to even
  int lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float l, h;
    if (w == 0) {
      l = h = pts[0][c];
    } else if (w == 1) {
      l = nan_min(nan_min(pts[1][c], pts[2][c]), pts[3][c]);
      h = nan_max(nan_max(pts[1][c], pts[2][c]), pts[3][c]);
    } else {
      l = nan_min(pts[1][c], pts[2][c]);
      h = nan_max(pts[1][c], pts[2][c]);
    }
    const float ql = __fdiv_rn(l, g.res), qh = __fdiv_rn(h, g.res);
    if (w == 1) {
      lo[c] = static_cast<int>(rintf(ql)) - g.origin[c];
      hi[c] = static_cast<int>(rintf(qh)) - g.origin[c];
    } else {
      lo[c] = static_cast<int>(floorf(__fadd_rn(ql, 1e-6f))) - g.origin[c];
      hi[c] = static_cast<int>(ceilf(__fsub_rn(qh, 1e-6f))) - g.origin[c];
    }
  }
  if (w == 2) {  // within_prev
    const bool held = lo[0] >= prev_lo[0] && lo[1] >= prev_lo[1] && lo[2] >= prev_lo[2] &&
                      hi[0] <= prev_hi[0] && hi[1] <= prev_hi[1] && hi[2] <= prev_hi[2];
    if (!held) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = max(lo[c], prev_lo[c]);
        hi[c] = min(hi[c], prev_hi[c]);
      }
    }
  }
  Lane s;
  int lim[6];
  const bool seed_ok = seed_lane(s, lim, im, lo, hi, g.dims, g.r);
  expand_lane_chain(s, kDefaultOrder, lim, im, g.max_trips);
  if ((threadIdx.x & 31) == 0) {
    const long long li = 3LL * a + w;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      e_lo[w][c] = s.b[c];
      e_hi[w][c] = s.b[c + 3];
      g.seed_lo[3 * li + c] = lo[c];
      g.seed_hi[3 * li + c] = hi[c];
      g.lane_lo[3 * li + c] = s.b[c];
      g.lane_hi[3 * li + c] = s.b[c + 3];
    }
    e_ok[w] = seed_ok;
    e_trips[w] = s.trips;
    g.lane_ok[li] = seed_ok ? 1 : 0;
  }
  __syncthreads();

  // the boxes: shifted by one segment with the new last box, or the
  // initialization box everywhere before init_done
  const bool done = g.init_done[a];
  for (int m = threadIdx.x; m < g.M; m += blockDim.x) {
    const int *blo, *bhi;
    if (!done) {
      blo = e_lo[0];
      bhi = e_hi[0];
    } else if (m < g.M - 1) {
      blo = g.sfc_lo + (3LL * g.M) * a + 3 * (m + 1);
      bhi = g.sfc_hi + (3LL * g.M) * a + 3 * (m + 1);
    } else if (e_ok[1] && superset<3>(g, e_lo[1], e_hi[1], pts + 1)) {
      blo = e_lo[1];
      bhi = e_hi[1];
    } else if (e_ok[2] && superset<2>(g, e_lo[2], e_hi[2], pts + 1)) {
      blo = e_lo[2];
      bhi = e_hi[2];
    } else {
      blo = prev_lo;
      bhi = prev_hi;
    }
    const long long o = (3LL * g.M) * a + 3 * m;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int l = blo[c], h = bhi[c];
      g.lo[o + c] = l;
      g.hi[o + c] = h;
      g.lo_w[o + c] = world_lo(g, l, c, g.delta_world);
      g.hi_w[o + c] = world_hi(g, h, c, g.delta_world);
    }
  }

  // the call's longest lane into the trip counter, by the last block to finish
  if (threadIdx.x == 0) {
    atomicMax(g.scratch, static_cast<unsigned>(max(max(e_trips[0], e_trips[1]), e_trips[2])));
    __threadfence();
    if (atomicAdd(g.scratch + 1, 1u) == gridDim.x - 1) {
      *g.trips_total += atomicExch(g.scratch, 0u);
      atomicExch(g.scratch + 1, 0u);
    }
  }
}

// ---- measurement only ------------------------------------------------------------
// One thread follows `hops` links of `next` through L2 (ld.global.cg: cached in
// L2, not in L1), so that the launch's time over `hops` is one L2 round trip
// plus a few instructions.
__global__ void l2_chase_kernel(const int* __restrict__ next, int hops, int* out) {
  int j = 0;
  for (int h = 0; h < hops; ++h) j = __ldcg(next + j);
  *out = j;
}

// One thread runs `hops` 8-corner queries of the image, each box placed by the
// previous query's count, so that the launch's time over `hops` is one
// dependent query (the expansion's unit of latency).
__global__ void query_chase_kernel(Image im, int hops, unsigned* out) {
  unsigned acc = 0;
  int x = 0, y = 0;
  const int nx = im.SX - 3, ny = im.SY - 3;
  for (int h = 0; h < hops; ++h) {
    const int b[6] = {x, y, 0, x + 1, y + 1, im.SZ - 3};
    const unsigned c = box_count(im, b);
    acc += c;
    x += 7 + static_cast<int>(c & 1u);
    x = x >= nx ? x - nx : x;
    y += 13 + static_cast<int>((c >> 1) & 1u);
    y = y >= ny ? y - ny : y;
  }
  *out = acc;
}

}  // namespace

// Queues the expansion of L lanes on `stream` (one launch, no synchronisation).
// `agent` null: every lane reads the one image S; else lane i reads image
// agent[i] of n_images. Returns the CUDA error code (0 on success).
extern "C" int sfc_expand_launch(const int* lo0, const int* hi0, const long long* order,
                                 const long long* agent, const int* S, long long n_images,
                                 int L, int X, int Y, int Z, int SX, int SY, int SZ, int r,
                                 int max_trips, int* lo, int* hi, unsigned char* seed_free, void* stream) {
  if (L < 1) return cudaErrorInvalidValue;
  Args a;
  a.lo0 = lo0; a.hi0 = hi0; a.order = order; a.agent = agent; a.S = S; a.n_images = n_images;
  a.L = L; a.X = X; a.Y = Y; a.Z = Z; a.SX = SX; a.SY = SY; a.SZ = SZ;
  a.r = r; a.max_trips = max_trips;
  a.lo = lo; a.hi = hi; a.seed_free = seed_free;
  sfc_expand_kernel<<<(L + kWarps - 1) / kWarps, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Queues the 'hull'-mode SFC update of A agents with M boxes each on `stream`
// (one launch, no synchronisation); `per_agent`: S holds A images, agent a
// reads image a; the [A, 3] points may be rows of a larger array (their
// strides). Returns the CUDA error code (0 on success).
extern "C" int sfc_update_hull_launch(
    const int* S, int per_agent, int SX, int SY, int SZ, const int* sfc_lo, const int* sfc_hi,
    const unsigned char* init_done, const float* last_pt, const float* cgoal, const float* wpt,
    const float* pos, long long last_stride, long long cgoal_stride, long long wpt_stride,
    long long pos_stride, int A, int M, int X, int Y, int Z, int ox, int oy, int oz, float res,
    float delta_sup, float delta_world, int r, int max_trips, int* lo, int* hi,
    float* lo_w, float* hi_w, int* seed_lo, int* seed_hi, int* lane_lo, int* lane_hi,
    unsigned char* lane_ok, long long* trips_total, unsigned* scratch, void* stream) {
  if (A < 1 || M < 1) return cudaErrorInvalidValue;
  HullArgs g;
  g.S = S; g.image_stride = per_agent ? static_cast<long long>(SX) * SY * SZ : 0;
  g.SX = SX; g.SY = SY; g.SZ = SZ;
  g.sfc_lo = sfc_lo; g.sfc_hi = sfc_hi; g.init_done = init_done;
  g.last_pt = last_pt; g.cgoal = cgoal; g.wpt = wpt; g.pos = pos;
  g.stride[0] = last_stride; g.stride[1] = cgoal_stride; g.stride[2] = wpt_stride;
  g.stride[3] = pos_stride;
  g.M = M; g.dims[0] = X; g.dims[1] = Y; g.dims[2] = Z;
  g.origin[0] = ox; g.origin[1] = oy; g.origin[2] = oz;
  g.res = res; g.delta_sup = delta_sup; g.delta_world = delta_world;
  g.r = r; g.max_trips = max_trips;
  g.lo = lo; g.hi = hi; g.lo_w = lo_w; g.hi_w = hi_w;
  g.seed_lo = seed_lo; g.seed_hi = seed_hi; g.lane_lo = lane_lo; g.lane_hi = lane_hi;
  g.lane_ok = lane_ok; g.trips_total = trips_total; g.scratch = scratch;
  sfc_update_hull_kernel<<<A, 96, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// Blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of kernel 0,
// the expansion, or 1, the 'hull'-mode SFC update.
extern "C" int sfc_occupancy(int kernel, int* blocks_per_sm) {
  if (kernel == 0)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, sfc_expand_kernel,
                                                         kWarps * 32, 0);
  if (kernel == 1)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, sfc_update_hull_kernel,
                                                         96, 0);
  return cudaErrorInvalidValue;
}

// Queues the measurement chase: `hops` dependent L2 reads from next[0].
extern "C" int sfc_l2_chase_launch(const int* next, int hops, int* out, void* stream) {
  l2_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, hops, out);
  return static_cast<int>(cudaGetLastError());
}

// Queues the measurement chase: `hops` dependent 8-corner queries of image S.
extern "C" int sfc_query_chase_launch(const int* S, int SX, int SY, int SZ, int hops,
                                      unsigned* out, void* stream) {
  if (SX < 4 || SY < 4 || SZ < 4) return cudaErrorInvalidValue;
  query_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(Image{S, SX, SY, SZ},
                                                                      hops, out);
  return static_cast<int>(cudaGetLastError());
}
