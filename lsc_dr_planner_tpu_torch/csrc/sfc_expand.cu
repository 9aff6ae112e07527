// Greedy Safe Flight Corridor box expansion of every lane in one launch, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's lsc_dr_planner_tpu/ops/sfc.py::expand_box
// (:37-104), a lax.while_loop vmapped over lanes inside the jitted step, which
// XLA kept on the TPU as one loop with no host round trip (it has no Pallas
// original). It computes what the plain loop
// lsc_dr_planner_tpu_torch/ops/sfc.py::expand_box_plain computes, bit for bit
// (the results are integers): for each lane, the seed box's free test (the box
// count and the world bounds), then the round-robin greedy loop: take the next
// active direction of the lane's order from `ptr`, test one more cell along it
// (the world bounds, the radius clamp, the 8-corner integral-image query), grow
// the box or retire the direction; the lane ends when no direction is active or
// after max_trips trips (min(4096, 6r + 6), 4096 when r = 0).
//
// The layout. One thread per lane, its whole state in registers (the box, a
// 6-bit mask of active directions, the pointer, the order packed 3 bits a
// direction so no register array is indexed at run time), each lane's loop
// independent of the others: one launch for the whole fleet and no host read,
// where the plain loop issues ~112 small kernels a trip and reads "is any lane
// live?" back every 8 trips. The integral image (int32 [X+2, Y+2, Z+2], or
// [A, X+2, Y+2, Z+2] with each lane's agent choosing its image) is read through
// the read-only path; a box query is 8 independent gathers. Box counts are
// summed in unsigned arithmetic, which wraps as torch's int32 sum does.
//
// What bounds it on the H100: not bytes (a lane reads its seed's 8 int32
// corners and, each trip, at most the 4 corners of the face it moves, the
// others being the current box's: 2.3-6.4 MB per call of 3,072 lanes, 0.7-1.9
// us at 3.35 TB/s; the lanes of one agent overlap, so fewer must come from
// memory) but the latency of the longest lane's chain of dependent trips: each
// trip's query waits for the previous trip's answer, so a call takes at least
// its longest lane's trips times one round trip to the cache that holds the
// image (L2 for the bench world's image, ~19 MB). Warps whose lanes run short
// idle while their longest lane finishes. `l2_chase_kernel` (measurement only,
// on no path) times one L2 round trip for that floor. Measured on an H100 80GB
// HBM3 at 700 W: 0.13-0.15 ms a call at A=1024 (190-195 trips in the longest
// lane), 0.69-0.76 us a trip, about five L2 round trips (PERF.md section 6). A
// persistent or warp-per-lane layout and a shared-memory tile of the image
// are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // lanes per block

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

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Blocked lattice points in [lo, hi] (inclusive), with the gather clamps of
// world/grid.py::box_blocked_count; 0 means the box is free.
__device__ __forceinline__ unsigned box_count(const int* __restrict__ S, int SX, int SY, int SZ,
                                              int lx, int ly, int lz, int hx, int hy, int hz) {
  const long long x0 = clampi(lx, 0, SX - 2), y0 = clampi(ly, 0, SY - 2),
                  z0 = clampi(lz, 0, SZ - 2);
  const long long x1 = clampi(hx + 1, 0, SX - 1), y1 = clampi(hy + 1, 0, SY - 1),
                  z1 = clampi(hz + 1, 0, SZ - 1);
  auto at = [&](long long x, long long y, long long z) {
    return static_cast<unsigned>(__ldg(S + (x * SY + y) * SZ + z));
  };
  return at(x1, y1, z1) - at(x0, y1, z1) - at(x1, y0, z1) - at(x1, y1, z0) + at(x0, y0, z1) +
         at(x0, y1, z0) + at(x1, y0, z0) - at(x0, y0, z0);
}

__global__ void __launch_bounds__(kThreads) sfc_expand_kernel(Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.L) return;
  int lx = a.lo0[3 * i], ly = a.lo0[3 * i + 1], lz = a.lo0[3 * i + 2];
  int hx = a.hi0[3 * i], hy = a.hi0[3 * i + 1], hz = a.hi0[3 * i + 2];
  const int* S = a.S;
  if (a.agent) {
    const long long g = a.agent[i];
    if (g < 0 || g >= a.n_images) __trap();  // no image for this lane
    S += g * a.SX * a.SY * a.SZ;
  }
  unsigned order = 0;  // direction of slot k in bits 3k..3k+2
  for (int k = 0; k < 6; ++k) order |= static_cast<unsigned>(a.order[6 * i + k]) << (3 * k);
  const bool seed_ok = box_count(S, a.SX, a.SY, a.SZ, lx, ly, lz, hx, hy, hz) == 0u &&
                       lx >= 0 && ly >= 0 && lz >= 0 && hx <= a.X && hy <= a.Y && hz <= a.Z;
  const int big = 1 << 30;
  const int mlx = a.r > 0 ? lx - a.r : -big, mly = a.r > 0 ? ly - a.r : -big,
            mlz = a.r > 0 ? lz - a.r : -big;
  const int mhx = a.r > 0 ? hx + a.r : big, mhy = a.r > 0 ? hy + a.r : big,
            mhz = a.r > 0 ? hz + a.r : big;
  unsigned active = seed_ok ? 0x3fu : 0u;
  int ptr = 0, trips = 0;
  while (active && trips < a.max_trips) {
    ++trips;
    int slot = ptr;  // the next active slot in cyclic order from ptr
    while (!((active >> slot) & 1u)) slot = slot == 5 ? 0 : slot + 1;
    const unsigned d = (order >> (3 * slot)) & 7u;
    int nlx = lx, nly = ly, nlz = lz, nhx = hx, nhy = hy, nhz = hz;
    switch (d) {
      case 0: --nlx; break;
      case 1: --nly; break;
      case 2: --nlz; break;
      case 3: ++nhx; break;
      case 4: ++nhy; break;
      default: ++nhz; break;
    }
    const bool ok = nlx >= 0 && nly >= 0 && nlz >= 0 && nhx <= a.X && nhy <= a.Y &&
                    nhz <= a.Z && nlx >= mlx && nly >= mly && nlz >= mlz && nhx <= mhx &&
                    nhy <= mhy && nhz <= mhz &&
                    box_count(S, a.SX, a.SY, a.SZ, nlx, nly, nlz, nhx, nhy, nhz) == 0u;
    if (ok) {
      lx = nlx; ly = nly; lz = nlz; hx = nhx; hy = nhy; hz = nhz;
      ptr = slot == 5 ? 0 : slot + 1;
    } else {
      active &= ~(1u << slot);
      ptr = slot;
    }
  }
  a.lo[3 * i] = lx; a.lo[3 * i + 1] = ly; a.lo[3 * i + 2] = lz;
  a.hi[3 * i] = hx; a.hi[3 * i + 1] = hy; a.hi[3 * i + 2] = hz;
  a.seed_free[i] = seed_ok ? 1 : 0;
}

// Measurement only (on no path): one thread follows `hops` links of `next`
// through L2 (ld.global.cg: cached in L2, not in L1), so that the launch's time
// over `hops` is one L2 round trip plus a few instructions.
__global__ void l2_chase_kernel(const int* __restrict__ next, int hops, int* out) {
  int j = 0;
  for (int h = 0; h < hops; ++h) j = __ldcg(next + j);
  *out = j;
}

}  // namespace

// Queues the expansion of L lanes on `stream` (one launch, no synchronisation).
// `agent` null: every lane reads the one image S; else lane i reads image
// agent[i] of n_images. Returns the CUDA error code (0 on success).
extern "C" int sfc_expand_launch(const int* lo0, const int* hi0, const long long* order,
                                 const long long* agent, const int* S, long long n_images,
                                 int L, int X, int Y, int Z, int SX, int SY, int SZ, int r,
                                 int max_trips, int* lo, int* hi, unsigned char* seed_free,
                                 void* stream) {
  if (L < 1) return cudaErrorInvalidValue;
  Args a;
  a.lo0 = lo0; a.hi0 = hi0; a.order = order; a.agent = agent; a.S = S; a.n_images = n_images;
  a.L = L; a.X = X; a.Y = Y; a.Z = Z; a.SX = SX; a.SY = SY; a.SZ = SZ;
  a.r = r; a.max_trips = max_trips;
  a.lo = lo; a.hi = hi; a.seed_free = seed_free;
  const int blocks = (L + kThreads - 1) / kThreads;
  sfc_expand_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Queues the measurement chase: `hops` dependent L2 reads from next[0].
extern "C" int sfc_l2_chase_launch(const int* next, int hops, int* out, void* stream) {
  l2_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, hops, out);
  return static_cast<int>(cudaGetLastError());
}
