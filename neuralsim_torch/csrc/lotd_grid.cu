// K3 lotd_grid: the dense and hash (Instant-NGP) levels of the LoTD encoding,
// 8-corner trilinear gather with the optional analytic jacobian, all gather
// levels in one launch.
//
// Replaces: neuralsim_tpu/fields/encodings/lotd.py
//   LoTDEncoding._level_features + _corner_rows_weight (lines 219-248,
//   410-456) and neuralsim_tpu/ops/gather.py gather_cols (lines 28-41).
//
// Per level (res, size rows, table offset, F features, dense|hash, out row):
//   pos = x01 * res, cell = min(floor(pos), res-1), frac = pos - cell
//   corner c (bit i = axis i): w = prod_i (bit ? frac_i : 1-frac_i)
//   row = dense: sum_i (cell_i+bit_i) (res+1)^i
//         hash:  xor_i ((cell_i+bit_i) * prime_i) in uint32, mod size
//   feats[f] = sum_c w * table[offset + f*size + row]   (corners 0..7 in order)
//   jac[i][f] = res * sum_c (+-1) * prod_{j != i} w_j * table[...]
// The table keeps the JAX layout: each level's segment viewed as [F, size].
// Rows are clamped into the level (gather_cols' mode="clip"). Feature f of a
// level goes to row (out row + f) of the encoding's feature-major output
// out [C, N] (and jac [3, C, N]), which the stacked-CP kernel fills too.
//
// What bounds it on an H100: memory latency of the random row reads. Per
// point and level it reads 8 corners x F floats scattered over the level
// (hash levels are 256 KB each at F=2, 2^15 rows, so they live in L2), and
// writes 4 (+12) bytes per feature, to neighbouring addresses across a warp.
// One thread per point walks the levels; the per-level metadata is a tiny
// int32 table read through the read-only cache.
// Sums use explicit _rn operations so no FMA changes the JAX rounding.
//
// Backward (lotd_grid_bwd), the gradient of both outputs into the table: the
// same corners, weights, hash and clamp as the forward, and per point, level,
// corner and feature
//   d table[offset + f*size + row] += w * d_out[f] + res * sum_i dw_i * d_jac[i][f]
// What bounds it: by bytes it reads 12 + 16 F bytes a point and level (the
// cotangents) and writes the levels' gradients once. What held it back was
// contention: a dense level of a vehicle (R 8, 13: 729 and 2,744 rows) takes
// ~900 float atomics on each address, and the lanes of a warp (neighbouring
// samples of one ray) hit the same few rows, so their atomics serialise in L2.
// The design:
//  * before any add, the lanes of a warp that hold a run of equal rows of a
//    level (a ray's samples in one cell) sum their values by shuffles, and
//    only the run's first lane adds: one add for the run;
//  * the caller may name private levels (dense levels whose segments fit a
//    shared-memory budget together: `private_mask`, `n_private` floats), for
//    launches with enough points to pay for them; then the grid is
//    persistent, one block a SM, and each block sums its own copy of those
//    levels in dynamic shared memory. A named level whose segment does not
//    fit what is left of the `n_private` floats takes device atomics, so a
//    plan that does not match the meta costs speed, never correctness;
//  * each block stores its copy in `scratch` [blocks, n_private], and a
//    second kernel sums every column over the blocks in block order into the
//    table: no device atomic on a private level, and a sum over blocks that is
//    the same from run to run (within a block the shared float atomics still
//    vary the last bits). The other levels take device atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_runs.cuh"

namespace {

constexpr int D = 3;
constexpr int META = 6;  // res, size, offset, F, is_hash, out row
__constant__ uint32_t kPrimes[D] = {1u, 2654435761u, 805459861u};

__global__ void grid_kernel(const float* __restrict__ table,
                            const float* __restrict__ pos01,  // [N, 3]
                            const int* __restrict__ meta,     // [L, 6]
                            float* __restrict__ out,          // [C, N]
                            float* __restrict__ jac,          // [3, C, N] or null
                            int N, int C, int L) {
  const size_t plane = (size_t)C * N;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += gridDim.x * blockDim.x) {
    float x[D];
#pragma unroll
    for (int ax = 0; ax < D; ++ax)
      x[ax] = fminf(fmaxf(pos01[(size_t)n * D + ax], 0.f), 1.f);
    for (int l = 0; l < L; ++l) {
      const int res = meta[l * META + 0];
      const int size = meta[l * META + 1];
      const int offset = meta[l * META + 2];
      const int nf = meta[l * META + 3];
      const int is_hash = meta[l * META + 4];
      const int col = meta[l * META + 5];
      const float fres = (float)res;
      int cell[D];
      float frac[D];
#pragma unroll
      for (int ax = 0; ax < D; ++ax) {
        float pos = __fmul_rn(x[ax], fres);
        float c = fminf(floorf(pos), (float)(res - 1));
        cell[ax] = (int)c;
        frac[ax] = __fsub_rn(pos, c);
      }
      int rows[8];
      float w[8], dw[8][D];
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        float aw[D];
        int ci[D];
#pragma unroll
        for (int ax = 0; ax < D; ++ax) {
          int b = (corner >> ax) & 1;
          aw[ax] = b ? frac[ax] : __fsub_rn(1.f, frac[ax]);
          ci[ax] = cell[ax] + b;
        }
        w[corner] = __fmul_rn(__fmul_rn(aw[0], aw[1]), aw[2]);
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float s = ((corner >> i) & 1) ? 1.f : -1.f;
          float v = s;
#pragma unroll
          for (int j = 0; j < D; ++j)
            if (j != i) v = __fmul_rn(v, aw[j]);
          dw[corner][i] = v;
        }
        int row;
        if (is_hash) {
          uint32_t h = (uint32_t)ci[0] * kPrimes[0];
          h ^= (uint32_t)ci[1] * kPrimes[1];
          h ^= (uint32_t)ci[2] * kPrimes[2];
          row = (int)(h % (uint32_t)size);
        } else {
          row = ci[0] + ci[1] * (res + 1) + ci[2] * (res + 1) * (res + 1);
        }
        rows[corner] = min(max(row, 0), size - 1);
      }
      for (int f = 0; f < nf; ++f) {
        const float* tf = table + offset + (size_t)f * size;
        float acc = 0.f, j0 = 0.f, j1 = 0.f, j2 = 0.f;
#pragma unroll
        for (int corner = 0; corner < 8; ++corner) {
          float v = __ldg(tf + rows[corner]);
          acc = __fadd_rn(acc, __fmul_rn(w[corner], v));
          j0 = __fadd_rn(j0, __fmul_rn(dw[corner][0], v));
          j1 = __fadd_rn(j1, __fmul_rn(dw[corner][1], v));
          j2 = __fadd_rn(j2, __fmul_rn(dw[corner][2], v));
        }
        const size_t o = (size_t)(col + f) * N + n;
        out[o] = acc;
        if (jac != nullptr) {
          jac[o] = __fmul_rn(j0, fres);
          jac[plane + o] = __fmul_rn(j1, fres);
          jac[2 * plane + o] = __fmul_rn(j2, fres);
        }
      }
    }
  }
}

constexpr int kBwdThreads = 256;         // a block of the atomics-only grid
constexpr int kBwdPrivateThreads = 512;  // a block of the persistent grid

// Level l, of seg floats, goes to the shared copy at soff where the mask names
// it and it fits the copy's n_private floats.
__device__ __forceinline__ bool is_private(unsigned mask, int l, int soff, int seg,
                                           int n_private) {
  return l < 31 && ((mask >> l) & 1u) && soff + seg <= n_private;
}

__global__ void __launch_bounds__(kBwdPrivateThreads)
grid_bwd_kernel(const float* __restrict__ pos01,  // [N, 3]
                const int* __restrict__ meta,     // [L, 6]
                const float* __restrict__ d_out,  // [C, N] or null
                const float* __restrict__ d_jac,  // [3, C, N] or null
                float* __restrict__ d_table,      // flat, zeroed
                float* __restrict__ scratch,      // [gridDim.x, n_private] or null
                int N, int C, int L, unsigned private_mask, int n_private) {
  extern __shared__ float priv[];  // this block's copy of the private levels
  for (int i = threadIdx.x; i < n_private; i += blockDim.x) priv[i] = 0.f;
  __syncthreads();

  const size_t plane = (size_t)C * N;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  // whole warps walk the points, so every lane reaches the warp intrinsics
  for (int base = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32; base < N;
       base += warps * 32) {
    const int n = base + lane;
    const bool valid = n < N;
    float x[D];
#pragma unroll
    for (int ax = 0; ax < D; ++ax)
      x[ax] = valid ? fminf(fmaxf(pos01[(size_t)n * D + ax], 0.f), 1.f) : 0.f;
    int soff = 0;  // the level's offset in the shared copy
    for (int l = 0; l < L; ++l) {
      const int res = meta[l * META + 0];
      const int size = meta[l * META + 1];
      const int offset = meta[l * META + 2];
      const int nf = meta[l * META + 3];
      const int is_hash = meta[l * META + 4];
      const int col = meta[l * META + 5];
      const bool in_shared = is_private(private_mask, l, soff, nf * size, n_private);
      const float fres = (float)res;
      int cell[D];
      float frac[D];
#pragma unroll
      for (int ax = 0; ax < D; ++ax) {
        float pos = __fmul_rn(x[ax], fres);
        float c = fminf(floorf(pos), (float)(res - 1));
        cell[ax] = (int)c;
        frac[ax] = __fsub_rn(pos, c);
      }
      float* seg = in_shared ? priv + soff : d_table + offset;
      for (int f0 = 0; f0 < nf; f0 += 4) {  // features in groups of four
        float go[4], g0[4], g1[4], g2[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool has = valid && f0 + k < nf;
          const size_t o = (size_t)(col + f0 + k) * N + n;
          go[k] = has && d_out != nullptr ? d_out[o] : 0.f;
          g0[k] = has && d_jac != nullptr ? d_jac[o] : 0.f;
          g1[k] = has && d_jac != nullptr ? d_jac[plane + o] : 0.f;
          g2[k] = has && d_jac != nullptr ? d_jac[2 * plane + o] : 0.f;
        }
#pragma unroll
        for (int corner = 0; corner < 8; ++corner) {
          float aw[D];
          int ci[D];
#pragma unroll
          for (int ax = 0; ax < D; ++ax) {
            int b = (corner >> ax) & 1;
            aw[ax] = b ? frac[ax] : 1.f - frac[ax];
            ci[ax] = cell[ax] + b;
          }
          const float w = aw[0] * aw[1] * aw[2];
          float dw[D];
#pragma unroll
          for (int i = 0; i < D; ++i) {
            float t = ((corner >> i) & 1) ? fres : -fres;
#pragma unroll
            for (int j = 0; j < D; ++j)
              if (j != i) t *= aw[j];
            dw[i] = t;
          }
          int row;
          if (is_hash) {
            uint32_t h = (uint32_t)ci[0] * kPrimes[0];
            h ^= (uint32_t)ci[1] * kPrimes[1];
            h ^= (uint32_t)ci[2] * kPrimes[2];
            row = (int)(h % (uint32_t)size);
          } else {
            row = ci[0] + ci[1] * (res + 1) + ci[2] * (res + 1) * (res + 1);
          }
          row = min(max(row, 0), size - 1);
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] = w * go[k] + dw[0] * g0[k] + dw[1] * g1[k] + dw[2] * g2[k];
          // a lane past N keys -1, so it never joins a real row's run
          if (sum_over_run(valid ? row : -1, lane, v) && valid) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (f0 + k < nf) atomicAdd(seg + (size_t)(f0 + k) * size + row, v[k]);
          }
        }
      }
      if (in_shared) soff += nf * size;
    }
  }

  if (n_private > 0) {
    __syncthreads();
    float* dst = scratch + (size_t)blockIdx.x * n_private;
    for (int i = threadIdx.x; i < n_private; i += blockDim.x) dst[i] = priv[i];
  }
}

// d_table[the private entry of column c] += sum over blocks b, in order, of
// scratch[b, c]: one thread a column, so nothing collides.
__global__ void grid_bwd_flush_kernel(const float* __restrict__ scratch,
                                      const int* __restrict__ meta,
                                      float* __restrict__ d_table, int n_private, int blocks,
                                      int L, unsigned private_mask) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_private) return;
  float acc = 0.f;
#pragma unroll 32  // loads in flight: the column's blocks are far apart
  for (int b = 0; b < blocks; ++b) acc += scratch[(size_t)b * n_private + c];
  int soff = 0;
  for (int l = 0; l < L; ++l) {
    const int seg = meta[l * META + 3] * meta[l * META + 1];
    if (!is_private(private_mask, l, soff, seg, n_private)) continue;
    if (c < soff + seg) {
      d_table[meta[l * META + 2] + (c - soff)] += acc;
      return;
    }
    soff += seg;
  }
}

}  // namespace

extern "C" int lotd_grid_fwd(const void* table, const void* pos01, const void* meta,
                             void* out, void* jac, int N, int C, int L, void* stream) {
  const int threads = 256;
  int blocks = (N + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : (blocks > 132 * 16 ? 132 * 16 : blocks);
  grid_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)pos01, (const int*)meta, (float*)out,
      (float*)jac, N, C, L);
  return (int)cudaGetLastError();
}

// private_mask: bit l set where level l is summed in shared memory (l < 31);
// n_private: those levels' floats (F x size each, in level order), and the
// columns of scratch [SMs, n_private] (null if n_private is 0). The grid: a
// thread a point in blocks of kBwdThreads, up to 16 blocks a SM, where
// n_private is 0; else persistent, one block of kBwdPrivateThreads a SM.
extern "C" int lotd_grid_bwd(const void* pos01, const void* meta, const void* d_out,
                             const void* d_jac, void* d_table, void* scratch, int N, int C,
                             int L, int private_mask, int n_private, void* stream) {
  if (n_private < 0 || (n_private > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int threads = n_private > 0 ? kBwdPrivateThreads : kBwdThreads;
  const int cap = n_private > 0 ? sms : 16 * sms;
  int blocks = (N + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : (blocks > cap ? cap : blocks);
  const size_t smem = (size_t)n_private * sizeof(float);
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(grid_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  grid_bwd_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos01, (const int*)meta, (const float*)d_out, (const float*)d_jac,
      (float*)d_table, (float*)scratch, N, C, L, (unsigned)private_mask, n_private);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_private == 0) return (int)e;
  grid_bwd_flush_kernel<<<(n_private + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)scratch, (const int*)meta, (float*)d_table, n_private, blocks, L,
      (unsigned)private_mask);
  return (int)cudaGetLastError();
}
