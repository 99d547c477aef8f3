// Runs of equal keys among the 32 lanes of a warp, for the backward kernels
// that scatter-add into small tables: K3's (lotd_grid.cu), the CP lines' of
// K1 (lotd_cp_stacked.cu) and K2 (lotd_cp_level.cu), and the permutohedral
// lattice's (K9, permuto.cu).
//
// The renderer flattens [rays, samples], so the lanes of a warp hold
// neighbouring samples of one ray, and at coarse resolutions many of them add
// to the same entries: on an H100 their device atomics serialise in L2, and a
// shared float atomic is a compare-and-swap loop (ATOMS.CAST.SPIN on sm_90a)
// that retries on every collision. So before any add, the lanes that hold a
// run of equal keys sum their values by shuffles (a segmented scan) and only
// the run's first lane adds: sum_over_run in one pass for a key used once;
// warp_runs finds the runs once and run_sum applies them to any number of
// values where one key serves many.
#pragma once

#include <cuda_runtime.h>

constexpr unsigned kFullWarp = 0xffffffffu;

// Sum v over each run of equal keys in neighbouring lanes; the run's first
// lane gets the sum and returns true. For a key whose runs serve one set of
// values (K3's corner rows): the scan stops at the longest run. Every lane of
// the warp takes part.
__device__ __forceinline__ bool sum_over_run(int key, int lane, float (&v)[4]) {
  const int prev = __shfl_up_sync(kFullWarp, key, 1);
  const bool head = lane == 0 || prev != key;
  const unsigned heads = __ballot_sync(kFullWarp, head);
  for (int off = 1; off < 32; off <<= 1) {
    // lane + off is in this lane's run iff no run starts in (lane, lane + off]
    const bool same = lane + off < 32 && ((heads >> (lane + 1)) & ((1u << off) - 1u)) == 0u;
    if (!__any_sync(kFullWarp, same)) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float t = __shfl_down_sync(kFullWarp, v[k], off);
      if (same) v[k] += t;
    }
  }
  return head;
}

// For a key whose runs serve many values (the CP lines: one cell a point and
// axis, four features at a time), the structure is found once. A point may
// span S neighbouring lanes (S divides 32), each with other values of the
// same key: the runs are over points, and a lane sums only with the lanes of
// its slot (lane % S) in its run.
struct Runs {
  bool head;       // this lane's point starts a run
  unsigned heads;  // the warp's run starts: the first lane of each such point
  int steps;       // the scan steps the warp needs: S 2^steps >= S x its longest run
  unsigned same;   // bit s: lane + S 2^s lies in this lane's run
};

// Every lane of the warp takes part; the S lanes of a point hold one key.
template <int S>
__device__ __forceinline__ Runs warp_runs(int key, int lane) {
  const int first = lane - lane % S;  // the point's first lane
  const int prev = __shfl_up_sync(kFullWarp, key, S);
  Runs r;
  r.head = first == 0 || prev != key;
  r.heads = __ballot_sync(kFullWarp, r.head && lane == first);
  r.steps = 0;
  r.same = 0u;
#pragma unroll
  for (int s = 0; S << s < 32; ++s) {
    const int off = S << s;
    // lane + off is in this lane's run iff no run starts in (first, first + off]
    const bool same =
        lane + off < 32 && ((r.heads >> (first + 1)) & ((1u << off) - 1u)) == 0u;
    if (!__any_sync(kFullWarp, same)) break;
    r.same |= (unsigned)same << s;
    r.steps = s + 1;
  }
  return r;
}

// Sum each v[k] over this lane's slot of its run; the run's first point gets
// the sums. Every lane of the warp takes part.
template <int S, int K>
__device__ __forceinline__ void run_sum(const Runs& r, float (&v)[K]) {
#pragma unroll
  for (int s = 0; S << s < 32; ++s) {  // unrolled: each shuffle's offset is a constant
    if (s >= r.steps) break;           // the same in every lane
    const bool same = (r.same >> s) & 1u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float t = __shfl_down_sync(kFullWarp, v[k], S << s);
      if (same) v[k] += t;
    }
  }
}

// A point of a two-tap line adds to entries key and key + 1. Where the next
// run starts at key + 1, the two runs share an entry: the next run's first
// point adds this run's upper tap with its own lower one, so the shared entry
// takes one add. A key < -1 marks a lane with no point (past N): it is never
// next to a real key (>= 0).
struct TapRuns {
  Runs r;
  bool give_next;  // head: the next run starts at key + 1 and adds our upper tap
  bool take_prev;  // head: the previous run ends at key - 1; add its upper tap
  int prev_head;   // head: the lane of this slot that holds the previous run's sums
  bool any_take;   // some lane of the warp takes
};

// Every lane of the warp takes part; the S lanes of a point hold one key.
template <int S>
__device__ __forceinline__ TapRuns tap_runs(int key, int lane) {
  TapRuns t;
  t.r = warp_runs<S>(key, lane);
  const int slot = lane % S, first = lane - slot;
  const int prev = __shfl_up_sync(kFullWarp, key, S);
  const unsigned after = first + S < 32 ? t.r.heads >> (first + S) : 0u;
  const int next_first = after ? first + S + __ffs((int)after) - 1 : 32;
  const int next_key = __shfl_sync(kFullWarp, key, next_first & 31);
  const unsigned before = t.r.heads & ((1u << first) - 1u);
  t.prev_head = (before ? 31 - __clz((int)before) : 0) + slot;
  t.give_next = t.r.head && next_first < 32 && next_key == key + 1;
  t.take_prev = t.r.head && first > 0 && prev == key - 1;
  t.any_take = __any_sync(kFullWarp, t.take_prev);
  return t;
}

// v holds a lane's K lower-tap values, then its K upper-tap values. Sums
// both over the run; then a head that takes adds the previous run's upper
// sums to its lower ones. The head adds v[k] at key and, unless give_next,
// v[K + k] at key + 1. Every lane of the warp takes part.
template <int S, int K>
__device__ __forceinline__ void tap_sum(const TapRuns& t, float (&v)[2 * K]) {
  run_sum<S>(t.r, v);
  if (!t.any_take) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float up = __shfl_sync(kFullWarp, v[K + k], t.prev_head);
    if (t.take_prev) v[k] += up;
  }
}

// Adds v[O + k], k < nf <= 4, at p[k] with device atomics: one float4 add
// (sm_90) where the four are whole and p is 16-byte aligned (vec), else one a
// value. Zeros are skipped.
template <int O, int K>
__device__ __forceinline__ void add4_global(float* p, const float (&v)[K], int nf, bool vec) {
  if (vec && nf == 4) {
    if (v[O] != 0.f || v[O + 1] != 0.f || v[O + 2] != 0.f || v[O + 3] != 0.f)
      atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[O], v[O + 1], v[O + 2], v[O + 3]));
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < nf && v[O + k] != 0.f) atomicAdd(p + k, v[O + k]);
}

// A lane's point on a level of two-tap lines (K1, K2): its cells, tent
// weights and slopes along each axis, and the runs of equal cells.
struct WarpPoints {
  int lo[3];
  float w0[3], w1[3], s0[3], s1[3];
  TapRuns t[3];
};

// After the caller's point_taps: the slopes times (R-1), and the runs of each
// axis (a point past N keys -2) for points of S lanes. Every lane of the warp
// takes part.
template <int S>
__device__ __forceinline__ void find_tap_runs(WarpPoints& p, bool valid, float rm1, int lane) {
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    p.s0[ax] *= rm1;
    p.s1[ax] *= rm1;
    p.t[ax] = tap_runs<S>(valid ? p.lo[ax] : -2, lane);
  }
}
