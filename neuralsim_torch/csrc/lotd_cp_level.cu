// K2 lotd_cp_level: the per-level CP levels of the LoTD encoding (a single
// CP level, or every CP level under NEURALSIM_CP_STACKED=0), all of them in
// one launch, with the optional analytic jacobian d(feats)/d(pos01).
//
// Replaces: neuralsim_tpu/fields/encodings/lotd.py
//   LoTDEncoding._cp_level_features (lines 250-320), without bidx.
//
// Per level (R, table offset, F features, out row), the level's lines are
// the table segment [offset, offset + 3*R*F) viewed as [3, R, F] (the JAX
// layout), and per point n and feature f:
//   pos_ax   = clip(x01_ax, 0, 1) * (R-1)
//   f_ax     = sum_r bf16(line[ax, r, f]) * bf16(relu(1 - |pos_ax - r|))
//   g_ax     = (sum_r bf16(line[ax, r, f]) * tent'(pos_ax - r)) * (R-1)
//   feats    = f_0 * f_1 * f_2,   jac[ax] = g_ax * f_other * f_other'
// with tent'(d) = -sign(d) where |d| < 1 and 0 elsewhere (0 at an exactly
// integer pos). Products and sums are f32: the JAX bf16 tent matmul, of
// which only the two nonzero taps per axis are computed (K1's device code,
// with a per-level R and the lines read from the f32 table and rounded to
// bf16 as they are read, so no rounded copy of the table is made). Feature
// f of a level goes to row (out row + f) of the encoding's feature-major
// output out [C, N] (and jac [3, C, N]), which the dense/hash kernel fills
// too.
//
// What bounds it on an H100: bytes. Per point and level it reads 12 bytes
// and writes 4*F (features) + 12*F (jacobian) bytes; the lines (3*R*F
// floats, 49 KB at R = 1,024, F = 4) stay in L1/L2. Block (x, y) computes
// level y for its points, so a warp's threads (neighbouring points) store to
// neighbouring addresses.
//
// Backward (lotd_cp_level_bwd): the gradient of both outputs into the f32
// CP segments of the table (JAX differentiates the same function; JAX rounds
// the line gradient to bf16, this sums it in f32). Per point, feature and
// axis, with o1, o2 the other two axes:
//   d f_ax = d_out * f_o1 * f_o2 + d_jac[o1] * g_o1 * f_o2 + d_jac[o2] * g_o2 * f_o1
//   d g_ax = d_jac[ax] * f_o1 * f_o2
//   d line[ax, lo + k, f] += d f_ax * w_k + d g_ax * s_k * (R-1),   k = 0, 1
// No gradient goes to the positions. What threatens it is contention: a
// coarse level's whole gradient is 3 x 16 x 4 floats under 10^5 points. So
// each block sums a slab of its level's features for its points in shared
// memory (f32 shared atomics, at most 96 KB so that two blocks share an SM)
// and adds its sums to the table's gradient once per entry at the end (K1's
// scheme); the caller's buffer may already hold the dense/hash gradient. A
// level whose 3*R floats of one feature do not fit (R > 8,192) adds each
// point's share to the table's gradient straight away, all F at once.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int D = 3;
constexpr int META = 4;  // R, offset, F, out row

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// relu(1 - |delta|), rounded to bf16 as the JAX tent matrix is
__device__ __forceinline__ float tent(float delta) {
  return bf16_round(fmaxf(0.f, __fsub_rn(1.f, fabsf(delta))));
}

// d tent / d pos = -sign(delta) on |delta| < 1 (sign(0) = 0)
__device__ __forceinline__ float tent_slope(float delta) {
  if (!(fabsf(delta) < 1.f)) return 0.f;
  return delta > 0.f ? -1.f : (delta < 0.f ? 1.f : 0.f);
}

// The two taps of point n along each axis at resolution R.
__device__ __forceinline__ void point_taps(const float* __restrict__ pos01, int n, int R,
                                           int* lo, float* w0, float* w1, float* s0,
                                           float* s1) {
  const float rm1 = (float)(R - 1);
#pragma unroll
  for (int ax = 0; ax < D; ++ax) {
    float x = fminf(fmaxf(pos01[(size_t)n * D + ax], 0.f), 1.f);
    float pos = __fmul_rn(x, rm1);
    int l = min((int)floorf(pos), R - 2);
    l = max(l, 0);
    float d0 = __fsub_rn(pos, (float)l);
    float d1 = __fsub_rn(pos, (float)(l + 1));
    lo[ax] = l;
    w0[ax] = tent(d0);
    w1[ax] = tent(d1);
    s0[ax] = tent_slope(d0);
    s1[ax] = tent_slope(d1);
  }
}

// Forward: block (x, y) handles points x of level y.
__global__ void cp_level_kernel(const float* __restrict__ table,  // flat, f32
                                const float* __restrict__ pos01,  // [N, 3]
                                const int* __restrict__ meta,     // [L, 4]
                                float* __restrict__ out,          // [C, N]
                                float* __restrict__ jac,          // [3, C, N] or null
                                int N, int C) {
  const int* m = meta + blockIdx.y * META;
  const int R = __ldg(m), F = __ldg(m + 2), row = __ldg(m + 3);
  const float* lines = table + __ldg(m + 1);     // [3, R, F]
  const float rm1 = (float)(R - 1);
  const size_t plane = (size_t)C * N;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += gridDim.x * blockDim.x) {
    int lo[D];
    float w0[D], w1[D], s0[D], s1[D];
    point_taps(pos01, n, R, lo, w0, w1, s0, s1);
    for (int f = 0; f < F; ++f) {
      float fa[D], ga[D];
#pragma unroll
      for (int ax = 0; ax < D; ++ax) {
        const float* p = lines + ((size_t)ax * R + lo[ax]) * F + f;
        float a = bf16_round(__ldg(p)), b = bf16_round(__ldg(p + F));
        fa[ax] = __fadd_rn(__fmul_rn(a, w0[ax]), __fmul_rn(b, w1[ax]));
        ga[ax] = __fmul_rn(__fadd_rn(__fmul_rn(a, s0[ax]), __fmul_rn(b, s1[ax])), rm1);
      }
      const size_t o = (size_t)(row + f) * N + n;
      out[o] = __fmul_rn(__fmul_rn(fa[0], fa[1]), fa[2]);
      if (jac != nullptr) {
        jac[o] = __fmul_rn(__fmul_rn(ga[0], fa[1]), fa[2]);
        jac[plane + o] = __fmul_rn(__fmul_rn(ga[1], fa[0]), fa[2]);
        jac[2 * plane + o] = __fmul_rn(__fmul_rn(ga[2], fa[0]), fa[1]);
      }
    }
  }
}

// What the backward asks for: 96 KB of shared memory a block, so that two of
// its blocks share an SM. A slab holds FT features of one level: [3, R, FT].
constexpr int SMEM_FLOATS = 96 * 1024 / 4;

// Backward: block (x, y) sums level y's gradient for points x, one slab of
// features at a time, in shared memory, then adds it to d_table (or, past
// the shared memory, adds to d_table directly).
__global__ void cp_level_bwd_kernel(const float* __restrict__ table,
                                    const float* __restrict__ pos01,  // [N, 3]
                                    const int* __restrict__ meta,     // [L, 4]
                                    const float* __restrict__ d_out,  // [C, N] or null
                                    const float* __restrict__ d_jac,  // [3, C, N] or null
                                    float* __restrict__ d_table,      // flat, f32
                                    int N, int C) {
  extern __shared__ float sg[];  // [3, R, FT] gradient sums of this slab
  const int* m = meta + blockIdx.y * META;
  const int R = __ldg(m), off = __ldg(m + 1), F = __ldg(m + 2), row = __ldg(m + 3);
  const float* lines = table + off;
  const bool in_smem = D * R <= SMEM_FLOATS;
  const int FT = in_smem ? min(F, SMEM_FLOATS / (D * R)) : F;  // F past the smem
  const float rm1 = (float)(R - 1);
  const size_t plane = (size_t)C * N;
  for (int f0 = 0; f0 < F; f0 += FT) {
    const int nf = min(F, f0 + FT) - f0;
    if (in_smem)
      for (int i = threadIdx.x; i < D * R * FT; i += blockDim.x) sg[i] = 0.f;
    __syncthreads();
    for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
         n += gridDim.x * blockDim.x) {
      int lo[D];
      float w0[D], w1[D], s0[D], s1[D];
      point_taps(pos01, n, R, lo, w0, w1, s0, s1);
#pragma unroll
      for (int ax = 0; ax < D; ++ax) {
        s0[ax] *= rm1;
        s1[ax] *= rm1;
      }
      for (int k = 0; k < nf; ++k) {
        const int f = f0 + k;
        const size_t o = (size_t)(row + f) * N + n;
        const float go = d_out != nullptr ? d_out[o] : 0.f;
        float fa[D], ga[D], gj[D];
#pragma unroll
        for (int ax = 0; ax < D; ++ax) {
          const float* p = lines + ((size_t)ax * R + lo[ax]) * F + f;
          float a = bf16_round(__ldg(p)), b = bf16_round(__ldg(p + F));
          fa[ax] = a * w0[ax] + b * w1[ax];
          ga[ax] = a * s0[ax] + b * s1[ax];
          gj[ax] = d_jac != nullptr ? d_jac[ax * plane + o] : 0.f;
        }
#pragma unroll
        for (int ax = 0; ax < D; ++ax) {
          const int o1 = (ax + 1) % D, o2 = (ax + 2) % D;
          const float dfa = go * fa[o1] * fa[o2] + gj[o1] * ga[o1] * fa[o2]
                            + gj[o2] * ga[o2] * fa[o1];
          const float dga = gj[ax] * fa[o1] * fa[o2];
          const size_t at = ((size_t)ax * R + lo[ax]) * FT + k;
          const float v0 = dfa * w0[ax] + dga * s0[ax], v1 = dfa * w1[ax] + dga * s1[ax];
          // two branches, so that the shared ones compile as shared atomics
          // (through one generic pointer they become slower generic ones)
          if (in_smem) {
            atomicAdd(sg + at, v0);
            atomicAdd(sg + at + FT, v1);
          } else {
            atomicAdd(d_table + off + at, v0);
            atomicAdd(d_table + off + at + FT, v1);
          }
        }
      }
    }
    __syncthreads();
    if (in_smem)
      for (int i = threadIdx.x; i < D * R * FT; i += blockDim.x) {
        const int k = i % FT, ar = i / FT;   // ar = ax * R + r
        if (k < nf && sg[i] != 0.f) atomicAdd(d_table + off + (size_t)ar * F + f0 + k, sg[i]);
      }
    __syncthreads();
  }
}

}  // namespace

extern "C" int lotd_cp_level_fwd(const void* table, const void* pos01, const void* meta,
                                 void* out, void* jac, int N, int L, int C, void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int blocks = (N + threads - 1) / threads;
  dim3 grid(blocks < 1 ? 1 : blocks, L);
  cp_level_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)pos01, (const int*)meta, (float*)out, (float*)jac, N,
      C);
  return (int)cudaGetLastError();
}

extern "C" int lotd_cp_level_bwd(const void* table, const void* pos01, const void* meta,
                                 const void* d_out, const void* d_jac, void* d_table, int N,
                                 int L, int C, void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)SMEM_FLOATS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      cp_level_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int threads = 512;
  int bx = (N + threads - 1) / threads;              // two blocks an SM over all levels
  const int cap = (sms * 2 + L - 1) / L;
  bx = bx < 1 ? 1 : (bx > cap ? cap : bx);
  dim3 grid(bx, L);
  cp_level_bwd_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)pos01, (const int*)meta, (const float*)d_out,
      (const float*)d_jac, (float*)d_table, N, C);
  return (int)cudaGetLastError();
}
