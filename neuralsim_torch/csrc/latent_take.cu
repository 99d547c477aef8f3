// K13 latent_take: the per-point lookup of the instance latents of a shared
// categorical model, and its backward (a segmented sum into the latents).
//
// Replaces: neuralsim_tpu/fields/conditional.py
//   ConditionalLoTDNeuSField._cond_feats (lines 273-294; the take at 281) and
//   ConditionalPermutoNeuSField._lattice_input (lines 125-140; the take at 134):
//   jnp.take(latents, bidx, axis=0, mode="clip"), and its autodiff.
//
//   out[p, c] = latents[k(p), c],  k(p) = clamp(idx[p / per], 0, n - 1)
//   d_latents[k, c] = sum over the points p with k(p) = k of d_out[p, c]
//
// idx is int32 or int64, one index a point (per = 1) or a ray's index at each
// of its per samples, or absent (instance 0 everywhere). The clamp is
// mode="clip"'s. d_out is read with its row stride ld (a column slice of the
// decoder input's gradient, as autograd's cat backward leaves it).
//
// What bounds it on an H100: bytes. The forward writes P z floats (the
// latents, [n, z], are a few hundred bytes); the backward reads the
// cotangent's z columns once, P z floats (196,608 x 8 on the main path:
// 6.3 MB, ~2 us at 3.35 TB/s). The library's sort-based index_put walks each
// run of equal indices with one warp; the main path hands it 3 runs of 65,536
// rows.
//
// Both kernels read a row as float4s where z % 4 == 0 and the rows are
// 16-byte aligned (z 8 on every path: two lanes a row), else a float a lane;
// p / per is a multiply and a shift (FastDiv), no divide.
//
// The forward: one pass, a thread a vector of the output, its index loaded
// by the row's lanes together (one request a warp where they share it), the
// latents (a few hundred bytes) read through L1. Staging them in shared
// memory and several vectors a thread were slower (a barrier a block; fewer
// blocks in flight: scripts/torch_kernel_ab.py). A copy: the bits of
// latents[idx].
//
// The backward, one launch a call, deterministic and free of device atomics
// where kBwdWarps x n x z floats fit kBwdSharedBudget (n z <= 3,072: n 384 at
// z 8; past 48 KB as opt-in shared memory):
//  * a block takes a contiguous chunk of rows and each warp a contiguous
//    part of it; a warp step covers 32 / S rows (S lanes a row, S the power
//    of two >= the row's vectors, at most 32; wider rows in column chunks),
//    kBwdUnroll steps of loads in flight;
//  * a step whose rows are all of one instance joins the warp's open run:
//    each lane adds its row to a register sum, and where the instance
//    changes the run is summed over the rows by a fixed shuffle tree and
//    added to the warp's own [n, z] sums in shared memory (the main path's
//    three runs: a few flushes a warp). A step of several runs is summed by
//    shuffles (warp_runs.cuh) and each run's head row adds its sum, runs in
//    row order (two runs of one instance in a step meet in one slot one
//    after the other);
//  * the block sums its warps in order into its row of `partial` [blocks,
//    n z]; the last block to finish (a __threadfence, then a ticket taken
//    with atomicInc, which wraps the counter back to 0 for the next call)
//    adds the blocks' rows: warp w the blocks w, w + 8, ... in order, a lane
//    an entry (loads coalesced, several blocks at once), then the warps in
//    order. A launch of one block writes d_latents itself. Every sum runs in
//    an order fixed by the shapes and the card's SM count, so two calls give
//    the same bits.
//  * Past the budget (no path today): the same runs, each head adding its
//    sum to the zeroed d_latents with a device atomic (a memset and the
//    kernel; order not fixed).
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_runs.cuh"

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdUnroll = 8;       // a warp's steps of loads in flight
constexpr int kBwdMinRows = 1024;   // a block's rows at least (a launch of <= 1,024: one block)
constexpr int kSumLoads = 4;        // blocks whose sums a lane of the last block loads at once
constexpr int kSumEntries = 2;      // ... of this many entries each
constexpr size_t kBwdSharedBudget = 96 * 1024;

// n / d for n < 2^31 by a multiply and a shift (the round-up method; d < 2^31).
struct FastDiv {
  unsigned d, m, s;
};

FastDiv make_fastdiv(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long one = 1;
  return {d, (unsigned)(((one << 32) * ((one << s) - d)) / d + 1), s};
}

__device__ __forceinline__ unsigned fastdiv(unsigned n, FastDiv f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

template <typename I>
__device__ __forceinline__ int instance_of(const I* __restrict__ idx, unsigned p, FastDiv per,
                                           int n) {
  if (idx == nullptr) return 0;
  const long long k = (long long)__ldg(idx + (per.d == 1 ? p : fastdiv(p, per)));
  return k < 0 ? 0 : (k >= n ? n - 1 : (int)k);
}

template <int V>
struct Vec {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

// A thread copies vector v of the output: row v / cols, column v % cols.
template <typename I, int V>
__global__ void __launch_bounds__(kFwdThreads)
latent_take_kernel(const float* __restrict__ latents, const I* __restrict__ idx,
                   float* __restrict__ out, int P, int n, FastDiv per, FastDiv cols) {
  using T = typename Vec<V>::T;
  const unsigned v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= (unsigned)P * cols.d) return;
  const unsigned row = fastdiv(v, cols);
  reinterpret_cast<T*>(out)[v] = __ldg(reinterpret_cast<const T*>(latents) +
                                       instance_of(idx, row, per, n) * cols.d + (v - row * cols.d));
}

template <int V>
__device__ __forceinline__ void load_row(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = p ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0, 0, 0, 0);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = p ? __ldg(p) : 0.f;
  }
}

template <int V>
__device__ __forceinline__ void add_row(float* dst, const float (&v)[V], bool atomics) {
  if constexpr (V == 4) {
    if (atomics) {
      atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    } else {
      float4 a = *reinterpret_cast<float4*>(dst);
      a.x += v[0], a.y += v[1], a.z += v[2], a.w += v[3];
      *reinterpret_cast<float4*>(dst) = a;
    }
  } else if (atomics) {
    atomicAdd(dst, v[0]);
  } else {
    *dst += v[0];
  }
}

// The warp's open run: each lane's column sums of its rows, summed over the
// rows by a fixed shuffle tree into the first row's lanes (head), which add
// them to instance cur's sums at at + cur z; then closed.
template <int S, int V>
__device__ __forceinline__ void flush_run(float (&acc)[V], int& cur, float* at, int z,
                                          bool head, bool atomics) {
  if (cur < 0) return;  // the same in every lane
#pragma unroll
  for (int off = S; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] += __shfl_down_sync(kFullWarp, acc[j], off);
  if (head) add_row<V>(at + cur * z, acc, atomics);
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  cur = -1;
  __syncwarp();
}

// S lanes a row, V floats a lane; chunk: a multiple of kBwdWarps x 32 / S.
template <typename I, int S, int V>
__global__ void __launch_bounds__(kBwdThreads, 1)
latent_take_bwd_kernel(const float* __restrict__ d_out, const I* __restrict__ idx,
                       float* __restrict__ d_lat, float* __restrict__ partial,
                       unsigned* __restrict__ ticket, int P, int ld, int z, int n, FastDiv per,
                       int chunk, int atomics) {
  constexpr int R = 32 / S;  // rows a warp step
  extern __shared__ float4 slots4[];
  float* slots = reinterpret_cast<float*>(slots4);  // [kBwdWarps][n][z]
  __shared__ bool last;
  const int nz = n * z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!atomics) {
    for (int i = threadIdx.x; i < kBwdWarps * nz; i += kBwdThreads) slots[i] = 0.f;
    __syncthreads();
  }
  const int r = lane / S, c = lane - r * S;
  const int cols = z / V;
  const int wchunk = chunk / kBwdWarps;
  const int wbeg = min(P, (int)blockIdx.x * chunk + warp * wchunk);
  const int wend = min(P, wbeg + wchunk);
  float* mine = atomics ? d_lat : slots + warp * nz;
  for (int c0 = 0; c0 < cols; c0 += S) {
    const int col = c0 + c;
    const bool live = col < cols;
    float* at = mine + col * V;  // + instance x z
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    int cur = -1;  // the warp's open run's instance (the same in every lane)
    for (int base = wbeg; base < wend; base += kBwdUnroll * R) {
      float v[kBwdUnroll][V];
      int k[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {  // every load first
        const int row = base + u * R + r;
        const bool ok = row < wend;
        k[u] = ok ? instance_of(idx, row, per, n) : -1;
        load_row<V>(v[u], ok && live ? d_out + (size_t)row * ld + col * V : nullptr);
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        if (base + u * R >= wend) break;  // the same in every lane
        // a step of one instance (rows past the chunk aside) joins the open run
        const int k0 = __shfl_sync(kFullWarp, k[u], 0);
        if (__all_sync(kFullWarp, k[u] == k0 || k[u] < 0)) {
          if (k0 != cur) {
            flush_run<S, V>(acc, cur, at, z, r == 0 && live, atomics);
            cur = k0;
          }
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] += v[u][j];
          continue;
        }
        // else the step's runs are summed by shuffles, and each run's head
        // row adds its sum, runs in row order (two runs of one instance in a
        // step meet in one slot one after the other)
        flush_run<S, V>(acc, cur, at, z, r == 0 && live, atomics);
        const Runs runs = warp_runs<S>(k[u], lane);
        run_sum<S, V>(runs, v[u]);
        unsigned heads = runs.heads;  // the first lane of each run's head row
        while (heads) {
          const int first = __ffs((int)heads) - 1;
          heads &= heads - 1;
          if (lane - c == first && k[u] >= 0 && live) add_row<V>(at + k[u] * z, v[u], atomics);
          __syncwarp();
        }
      }
    }
    flush_run<S, V>(acc, cur, at, z, r == 0 && live, atomics);
  }
  if (atomics) return;
  __syncthreads();
  // the block's sums, its warps in order
  for (int o = threadIdx.x; o < nz; o += kBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) s += slots[w * nz + o];
    if (gridDim.x == 1)
      d_lat[o] = s;
    else
      partial[(size_t)blockIdx.x * nz + o] = s;
  }
  if (gridDim.x == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: warp w sums the blocks w, w + kBwdWarps, ... in order
  // for entries lane, lane + 32, ... (kSumEntries a lane and kSumLoads
  // blocks at once, coalesced), into its own slots; then each entry's warps
  // in order
  for (int o0 = 0; o0 < nz; o0 += 32 * kSumEntries) {
    float s[kSumEntries];
#pragma unroll
    for (int e = 0; e < kSumEntries; ++e) s[e] = 0.f;
    for (int b0 = warp; b0 < (int)gridDim.x; b0 += kBwdWarps * kSumLoads) {
      float part[kSumLoads][kSumEntries];
#pragma unroll
      for (int j = 0; j < kSumLoads; ++j)
#pragma unroll
        for (int e = 0; e < kSumEntries; ++e) {
          const int b = b0 + j * kBwdWarps, o = o0 + lane + 32 * e;
          part[j][e] = b < (int)gridDim.x && o < nz ? __ldcg(partial + (size_t)b * nz + o) : 0.f;
        }
#pragma unroll
      for (int j = 0; j < kSumLoads; ++j)
#pragma unroll
        for (int e = 0; e < kSumEntries; ++e) s[e] += part[j][e];
    }
#pragma unroll
    for (int e = 0; e < kSumEntries; ++e)
      if (o0 + lane + 32 * e < nz) slots[warp * nz + o0 + lane + 32 * e] = s[e];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < nz; o += kBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) s += slots[w * nz + o];
    d_lat[o] = s;
  }
}

template <typename I>
cudaError_t launch_fwd(const float* latents, const I* idx, float* out, int P, int z, int n,
                       FastDiv per, cudaStream_t stream) {
  const bool vec = z % 4 == 0 && ((uintptr_t)latents & 15) == 0 && ((uintptr_t)out & 15) == 0;
  const int cols = vec ? z / 4 : z;
  const int blocks = (int)(((long long)P * cols + kFwdThreads - 1) / kFwdThreads);
  const FastDiv c = make_fastdiv((unsigned)cols);
  if (vec)
    latent_take_kernel<I, 4><<<blocks, kFwdThreads, 0, stream>>>(latents, idx, out, P, n, per,
                                                                 c);
  else
    latent_take_kernel<I, 1><<<blocks, kFwdThreads, 0, stream>>>(latents, idx, out, P, n, per,
                                                                 c);
  return cudaGetLastError();
}

template <typename I, int S, int V>
cudaError_t launch_bwd_sv(const float* d_out, const I* idx, float* d_lat, float* partial,
                          unsigned* ticket, int rows_cap, int P, int ld, int z, int n,
                          FastDiv per, cudaStream_t stream) {
  constexpr int step = kBwdWarps * (32 / S);  // a block's rows a warp step
  const bool atomics = (size_t)kBwdWarps * n * z * sizeof(float) > kBwdSharedBudget;
  int blocks = (P + kBwdMinRows - 1) / kBwdMinRows;
  blocks = blocks < 1 ? 1 : (blocks > rows_cap ? rows_cap : blocks);
  int chunk = (P + blocks - 1) / blocks;
  chunk = chunk < 1 ? step : (chunk + step - 1) / step * step;
  blocks = P > 0 ? (P + chunk - 1) / chunk : 1;
  const size_t smem = atomics ? 0 : (size_t)kBwdWarps * n * z * sizeof(float);
  cudaError_t e;
  if (atomics &&
      (e = cudaMemsetAsync(d_lat, 0, (size_t)n * z * sizeof(float), stream)) != cudaSuccess)
    return e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(latent_take_bwd_kernel<I, S, V>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return e;
  latent_take_bwd_kernel<I, S, V><<<blocks, kBwdThreads, smem, stream>>>(
      d_out, idx, d_lat, partial, ticket, P, ld, z, n, per, chunk, (int)atomics);
  return cudaGetLastError();
}

template <typename I, int V>
cudaError_t launch_bwd_v(const float* d_out, const I* idx, float* d_lat, float* partial,
                         unsigned* ticket, int rows_cap, int P, int ld, int z, int n, FastDiv per,
                         cudaStream_t stream) {
  const int cols = z / V;
  const int S = cols <= 1 ? 1 : cols <= 2 ? 2 : cols <= 4 ? 4 : cols <= 8 ? 8 : cols <= 16 ? 16
                                                                                         : 32;
#define NS_BWD_S(s)                                                                       \
  case s:                                                                                 \
    return launch_bwd_sv<I, s, V>(d_out, idx, d_lat, partial, ticket, rows_cap, P, ld, z, \
                                  n, per, stream);
  switch (S) {
    NS_BWD_S(1)
    NS_BWD_S(2)
    NS_BWD_S(4)
    NS_BWD_S(8)
    NS_BWD_S(16)
    NS_BWD_S(32)
  }
#undef NS_BWD_S
  return cudaErrorInvalidValue;
}

template <typename I>
cudaError_t launch_bwd(const float* d_out, const I* idx, float* d_lat, float* partial,
                       unsigned* ticket, int rows_cap, int P, int ld, int z, int n, FastDiv per,
                       cudaStream_t stream) {
  if (z % 4 == 0 && ld % 4 == 0 && ((uintptr_t)d_out & 15) == 0 && ((uintptr_t)d_lat & 15) == 0)
    return launch_bwd_v<I, 4>(d_out, idx, d_lat, partial, ticket, rows_cap, P, ld, z, n, per,
                              stream);
  return launch_bwd_v<I, 1>(d_out, idx, d_lat, partial, ticket, rows_cap, P, ld, z, n, per,
                            stream);
}

}  // namespace

// latents [n, z] f32; idx [P / per] int32 (idx64 0) or int64 (idx64 1), or
// null; out [P, z] f32. 1 <= z <= 256, per >= 1, P < 2^31.
extern "C" int latent_take_fwd(const void* latents, const void* idx, void* out, int P, int z,
                               int n, int per, int idx64, void* stream) {
  if (z < 1 || z > 256 || n < 1 || per < 1 || P < 0 || (long long)P * z >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  const FastDiv d = make_fastdiv((unsigned)per);
  const cudaStream_t s = (cudaStream_t)stream;
  return idx64 ? (int)launch_fwd((const float*)latents, (const long long*)idx, (float*)out, P,
                                 z, n, d, s)
               : (int)launch_fwd((const float*)latents, (const int*)idx, (float*)out, P, z, n,
                                 d, s);
}

// d_out: P rows of z f32, row stride ld >= z; d_latents [n, z] f32 (every
// entry written); partial [rows_cap, n z] f32, rows_cap >= 1: the blocks'
// sums (so at most rows_cap blocks); ticket: one unsigned int, 0 before the
// first call, left 0 by every call (one counter a stream: calls on one
// stream run in turn).
extern "C" int latent_take_bwd(const void* d_out, const void* idx, void* d_latents,
                               void* partial, void* ticket, int rows_cap, int P, int ld, int z,
                               int n, int per, int idx64, void* stream) {
  if (z < 1 || z > 256 || n < 1 || per < 1 || ld < z || rows_cap < 1 || P < 0)
    return (int)cudaErrorInvalidValue;
  const FastDiv d = make_fastdiv((unsigned)per);
  const cudaStream_t s = (cudaStream_t)stream;
  return idx64 ? (int)launch_bwd((const float*)d_out, (const long long*)idx, (float*)d_latents,
                                 (float*)partial, (unsigned*)ticket, rows_cap, P, ld, z, n, d, s)
               : (int)launch_bwd((const float*)d_out, (const int*)idx, (float*)d_latents,
                                 (float*)partial, (unsigned*)ticket, rows_cap, P, ld, z, n, d,
                                 s);
}
