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
// as an f32 atomicAdd in device memory (hash collisions and neighbouring
// points share rows, so the sum order, and with it the last bits, change from
// run to run). What bounds it: the atomics' throughput in L2 (the levels'
// gradients, 256 KB each, stay there); by bytes it reads 16 * C per point.
#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void grid_bwd_kernel(const float* __restrict__ pos01,  // [N, 3]
                                const int* __restrict__ meta,     // [L, 6]
                                const float* __restrict__ d_out,  // [C, N] or null
                                const float* __restrict__ d_jac,  // [3, C, N] or null
                                float* __restrict__ d_table,      // flat, zeroed
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
          aw[ax] = b ? frac[ax] : 1.f - frac[ax];
          ci[ax] = cell[ax] + b;
        }
        w[corner] = aw[0] * aw[1] * aw[2];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float v = ((corner >> i) & 1) ? fres : -fres;
#pragma unroll
          for (int j = 0; j < D; ++j)
            if (j != i) v *= aw[j];
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
        const size_t o = (size_t)(col + f) * N + n;
        const float go = d_out != nullptr ? d_out[o] : 0.f;
        float g0 = 0.f, g1 = 0.f, g2 = 0.f;
        if (d_jac != nullptr) {
          g0 = d_jac[o];
          g1 = d_jac[plane + o];
          g2 = d_jac[2 * plane + o];
        }
        float* tf = d_table + offset + (size_t)f * size;
#pragma unroll
        for (int corner = 0; corner < 8; ++corner)
          atomicAdd(tf + rows[corner], w[corner] * go + dw[corner][0] * g0
                                           + dw[corner][1] * g1 + dw[corner][2] * g2);
      }
    }
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

extern "C" int lotd_grid_bwd(const void* pos01, const void* meta, const void* d_out,
                             const void* d_jac, void* d_table, int N, int C, int L,
                             void* stream) {
  const int threads = 256;
  int blocks = (N + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : (blocks > 132 * 16 ? 132 * 16 : blocks);
  grid_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)pos01, (const int*)meta, (const float*)d_out, (const float*)d_jac,
      (float*)d_table, N, C, L);
  return (int)cudaGetLastError();
}
