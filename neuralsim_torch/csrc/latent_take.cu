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
// What bounds it on an H100: bytes. The forward writes N z floats (the
// latents, [n, z], stay in L1); the backward reads the cotangent once,
// N z floats (196,608 x 8 on the main path: 6.3 MB, ~2 us at 3.35 TB/s). The
// library's sort-based index_put walks each run of equal indices with one
// warp; the main path hands it 3 runs of 65,536 rows.
//
// The backward's design, deterministic and free of device atomics:
//  * a block takes a contiguous chunk of points; its threads are (row lane r,
//    column c), z columns by 256 / z lanes, and lane r walks the rows r,
//    r + lanes, ... of the chunk, four loads in flight (sixteen were slower
//    on the main path's launch and no faster on 512 points);
//  * a thread sums its run of rows of one instance in a register and adds the
//    run to its own slot of a shared [n, threads] array when the instance
//    changes (once on the main path's long runs, every row on the crowd's
//    round-robin rows): no two threads share a slot, so no atomics;
//  * the block then sums its lanes in lane order into a row of the scratch
//    [blocks, n z], and a second kernel (one warp an entry, a fixed shuffle
//    tree) adds the blocks' rows; a launch of one block writes d_latents
//    itself. Every sum runs in an order fixed by the shapes alone, so two
//    calls give the same bits.
//  * n x 256 floats past 48 KB (n > 48, no path today): the same runs, each
//    added to the zeroed d_latents with a device atomic (order not fixed).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;  // a block's chunk: lanes x this many rows at least
constexpr int kUnroll = 4;          // a thread's loads in flight
constexpr size_t kSharedBudget = 48 * 1024;

template <typename I>
__device__ __forceinline__ int instance_of(const I* __restrict__ idx, int row, int per, int n) {
  if (idx == nullptr) return 0;
  const long long k = (long long)idx[per == 1 ? row : row / per];
  return k < 0 ? 0 : (k >= n ? n - 1 : (int)k);
}

template <typename I>
__global__ void latent_take_kernel(const float* __restrict__ latents, const I* __restrict__ idx,
                                   float* __restrict__ out, long long total, int z, int per,
                                   int n) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long p = e / z;
    out[e] = latents[instance_of(idx, (int)p, per, n) * z + (int)(e - p * z)];
  }
}

// One thread's rows of the block's chunk [begin, end), summed run by run; each
// finished run goes to emit(instance, sum).
template <typename I, typename Emit>
__device__ __forceinline__ void walk_runs(const float* __restrict__ d_out,
                                          const I* __restrict__ idx, int begin, int end,
                                          int lanes, int r, int c, int ld, int per, int n,
                                          Emit emit) {
  int cur = -1;
  float run = 0.f;
  for (int p0 = begin + r; p0 < end; p0 += kUnroll * lanes) {
    float v[kUnroll];
    int k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * lanes;
      k[u] = p < end ? instance_of(idx, p, per, n) : -1;
      v[u] = p < end ? d_out[(long long)p * ld + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k[u] < 0) continue;
      if (k[u] != cur) {
        if (cur >= 0) emit(cur, run);
        cur = k[u];
        run = 0.f;
      }
      run += v[u];
    }
  }
  if (cur >= 0) emit(cur, run);
}

template <typename I>
__global__ void latent_take_bwd_kernel(const float* __restrict__ d_out,
                                       const I* __restrict__ idx, float* __restrict__ dst,
                                       int P, int ld, int z, int n, int per, int chunk) {
  extern __shared__ float slots[];  // [n][blockDim.x]: thread t's sum for instance k
  const int T = blockDim.x, t = threadIdx.x;
  const int lanes = T / z, r = t / z, c = t - r * z;
  for (int k = 0; k < n; ++k) slots[k * T + t] = 0.f;
  const int begin = blockIdx.x * chunk;
  const int end = min(P, begin + chunk);
  if (r < lanes)
    walk_runs(d_out, idx, begin, end, lanes, r, c, ld, per, n,
              [&](int k, float s) { slots[k * T + t] += s; });
  __syncthreads();
  // the block's sums, lane by lane in order: the launch's result where it is
  // one block, else the block's row of the scratch
  float* row = dst + (size_t)blockIdx.x * n * z;
  for (int o = t; o < n * z; o += T) {
    const int k = o / z, cc = o - k * z;
    float s = 0.f;
    for (int rr = 0; rr < lanes; ++rr) s += slots[k * T + rr * z + cc];
    row[o] = s;
  }
}

// One warp an entry of d_latents: lane l sums the blocks l, l + 32, ... in
// order, then a fixed shuffle tree.
__global__ void latent_take_flush_kernel(const float* __restrict__ scratch,
                                         float* __restrict__ d_latents, int nz, int blocks) {
  const int o = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (o >= nz) return;  // a whole warp
  float s = 0.f;
  for (int b = lane; b < blocks; b += 32) s += scratch[(size_t)b * nz + o];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) d_latents[o] = s;
}

template <typename I>
__global__ void latent_take_bwd_atomic_kernel(const float* __restrict__ d_out,
                                              const I* __restrict__ idx,
                                              float* __restrict__ d_latents, int P, int ld,
                                              int z, int n, int per, int chunk) {
  const int lanes = blockDim.x / z, r = threadIdx.x / z, c = threadIdx.x - r * z;
  const int begin = blockIdx.x * chunk;
  if (r < lanes)
    walk_runs(d_out, idx, begin, min(P, begin + chunk), lanes, r, c, ld, per, n,
              [&](int k, float s) { atomicAdd(d_latents + k * z + c, s); });
}

template <typename I>
cudaError_t launch_bwd(const float* d_out, const I* idx, float* d_latents, float* scratch,
                       int scratch_rows, int P, int ld, int z, int n, int per,
                       cudaStream_t stream) {
  const int lanes = kThreads / z;
  const int per_block = lanes * kRowsPerThread;
  int blocks = (P + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : blocks;
  const size_t smem = (size_t)n * kThreads * sizeof(float);
  if (smem > kSharedBudget) {
    blocks = blocks > 16 * 132 ? 16 * 132 : blocks;
    const int chunk = (P + blocks - 1) / blocks;
    cudaError_t e = cudaMemsetAsync(d_latents, 0, (size_t)n * z * sizeof(float), stream);
    if (e != cudaSuccess) return e;
    latent_take_bwd_atomic_kernel<I><<<blocks, kThreads, 0, stream>>>(d_out, idx, d_latents, P,
                                                                      ld, z, n, per, chunk);
    return cudaGetLastError();
  }
  blocks = blocks > scratch_rows ? scratch_rows : blocks;
  const int chunk = (P + blocks - 1) / blocks;
  latent_take_bwd_kernel<I><<<blocks, kThreads, smem, stream>>>(
      d_out, idx, blocks == 1 ? d_latents : scratch, P, ld, z, n, per, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || blocks == 1) return e;
  const int warps = 8;
  latent_take_flush_kernel<<<(n * z + warps - 1) / warps, warps * 32, 0, stream>>>(
      scratch, d_latents, n * z, blocks);
  return cudaGetLastError();
}

}  // namespace

// latents [n, z] f32; idx [P / per] int32 (idx64 0) or int64 (idx64 1), or
// null; out [P, z] f32. 1 <= z <= 256, per >= 1.
extern "C" int latent_take_fwd(const void* latents, const void* idx, void* out, int P, int z,
                               int n, int per, int idx64, void* stream) {
  if (z < 1 || z > kThreads || n < 1 || per < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)P * z;
  if (total == 0) return (int)cudaSuccess;
  long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want > 132 * 16 ? 132 * 16 : want);
  const cudaStream_t s = (cudaStream_t)stream;
  if (idx64)
    latent_take_kernel<long long><<<blocks, kThreads, 0, s>>>(
        (const float*)latents, (const long long*)idx, (float*)out, total, z, per, n);
  else
    latent_take_kernel<int><<<blocks, kThreads, 0, s>>>(
        (const float*)latents, (const int*)idx, (float*)out, total, z, per, n);
  return (int)cudaGetLastError();
}

// d_out: P rows of z f32, row stride ld >= z; d_latents [n, z] f32 (every
// entry written); scratch [scratch_rows, n z] f32, scratch_rows >= 1: the
// blocks' rows (so at most scratch_rows blocks).
extern "C" int latent_take_bwd(const void* d_out, const void* idx, void* d_latents,
                               void* scratch, int scratch_rows, int P, int ld, int z, int n,
                               int per, int idx64, void* stream) {
  if (z < 1 || z > kThreads || n < 1 || per < 1 || ld < z || scratch_rows < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (P == 0)
    return (int)cudaMemsetAsync(d_latents, 0, (size_t)n * z * sizeof(float), s);
  return idx64 ? (int)launch_bwd((const float*)d_out, (const long long*)idx, (float*)d_latents,
                                 (float*)scratch, scratch_rows, P, ld, z, n, per, s)
               : (int)launch_bwd((const float*)d_out, (const int*)idx, (float*)d_latents,
                                 (float*)scratch, scratch_rows, P, ld, z, n, per, s);
}
