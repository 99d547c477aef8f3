// K1 lotd_cp_stacked: all stacked-CP levels of the LoTD encoding at once,
// with the optional analytic jacobian d(feats)/d(pos01).
//
// Replaces: neuralsim_tpu/fields/encodings/lotd.py
//   LoTDEncoding._cp_stacked_features (lines 346-408). The parameter-only
//   line upsampling (_cp_stacked_lines, lines 322-344) stays plain torch.
//
// What it computes, per point n and stacked feature f:
//   pos_ax   = clip(x01_ax, 0, 1) * (R-1)
//   f_ax     = sum_r line[ax, f, r] * bf16(relu(1 - |pos_ax - r|))
//   g_ax     = (sum_r line[ax, f, r] * tent'(pos_ax - r)) * (R-1)
//   feats    = f_0 * f_1 * f_2,   jac[ax] = g_ax * f_other * f_other'
// with tent'(d) = -sign(d) where |d| < 1 and 0 elsewhere (so the jacobian is 0
// at an exactly integer pos, both ends included). Lines are bf16, the tent
// weights are rounded to bf16, products and sums are f32 — the JAX numbers.
// Feature f goes to row rows[f] of the encoding's feature-major output
// out [C, N] (and jac [3, C, N]), which the dense/hash kernel fills too.
//
// What bounds it on an H100: bytes. Per point it reads 12 bytes and writes
// 4*F (features) + 12*F (jacobian) bytes; the work is ~10 flops per output.
// The TPU form is a dense [F, R] @ [R, N] tent matmul per axis (R-fold
// redundant MACs); here only the two nonzero taps per axis are computed. The
// lines may be wide ([3, F, R] is 590 KB as bf16 at F=96, R=1024, more than a
// block's shared memory even so), so the features are cut into slabs of FT
// (grid y) and block (x, y) computes slab y for its points: the taps come
// from the bf16 lines in device memory through the read-only path; a slab of
// FT=8 at R=1024 is 49 KB, which stays in the SM's L1, and all lines stay in
// the 50 MB L2. The outputs are feature-major, so the threads of a warp
// (neighbouring points) store to neighbouring addresses.
//
// Backward (lotd_cp_stacked_bwd), the gradient of both outputs into the lines
// (JAX differentiates the same function; the on-render eikonal loss trains
// through the jacobian). Per point, feature and axis, with o1, o2 the other
// two axes:
//   d f_ax = d_out * f_o1 * f_o2 + d_jac[o1] * g_o1 * f_o2 + d_jac[o2] * g_o2 * f_o1
//   d g_ax = d_jac[ax] * f_o1 * f_o2
//   d line[ax, f, lo + k] += d f_ax * w_k + d g_ax * s_k * (R-1),   k = 0, 1
// The gradient is taken at the bf16-rounded line values and accumulated in
// f32. No gradient goes to the positions. What bounds it: bytes (it reads
// 16 * C cotangent bytes per point); what threatens it is the target, only
// 3*F*R floats for hundreds of thousands of points, where global atomics
// would serialise. So every block sums ONE feature slab into a copy in shared
// memory (f32 shared atomics; [3, FT, R] f32, at most 96 KB so that two
// blocks share an SM: FT=8 at R=1024, all 12 features at R=116), reads the
// line values from device memory as the forward does, and adds its copy to
// the global gradient once at the end.
//
// Why narrow lines get no copy in shared memory although [3, F, R] f32 is only
// 16.7 KB at F=12, R=116: a pair of kernels that held it there was no faster
// than these (NVIDIA H100 80GB HBM3, one call, 196,608 points: forward
// 0.031-0.034 against 0.023-0.030 ms, backward 0.245 against 0.177-0.182 ms),
// and one pair serves every width.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int D = 3;

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

// bf16 line value at p, through the read-only path (bf16 -> f32 is a shift)
__device__ __forceinline__ float line_at(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// The two taps of point n along each axis: cell, tent weights and slopes.
__device__ __forceinline__ void point_taps(const float* __restrict__ pos01, int n, int R,
                                           float rm1, int* lo, float* w0, float* w1,
                                           float* s0, float* s1) {
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

// Forward: block (x, y) handles points x and the feature slab [y*FT, (y+1)*FT).
__global__ void cp_stacked_kernel(const __nv_bfloat16* __restrict__ lines,  // [3, F, R]
                                       const float* __restrict__ pos01,          // [N, 3]
                                       const int* __restrict__ rows,             // [F]
                                       float* __restrict__ out,                  // [C, N]
                                       float* __restrict__ jac,                  // [3, C, N] or null
                                       int N, int F, int R, int C, int FT) {
  const int f0 = blockIdx.y * FT, f1 = min(F, f0 + FT);
  const float rm1 = (float)(R - 1);
  const size_t plane = (size_t)C * N;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += gridDim.x * blockDim.x) {
    int lo[D];
    float w0[D], w1[D], s0[D], s1[D];
    point_taps(pos01, n, R, rm1, lo, w0, w1, s0, s1);
    for (int f = f0; f < f1; ++f) {
      float fa[D], ga[D];
#pragma unroll
      for (int ax = 0; ax < D; ++ax) {
        const __nv_bfloat16* line = lines + ((size_t)(ax * F + f)) * R + lo[ax];
        float a = line_at(line), b = line_at(line + 1);
        fa[ax] = __fadd_rn(__fmul_rn(a, w0[ax]), __fmul_rn(b, w1[ax]));
        ga[ax] = __fmul_rn(__fadd_rn(__fmul_rn(a, s0[ax]), __fmul_rn(b, s1[ax])), rm1);
      }
      const size_t o = (size_t)__ldg(rows + f) * N + n;
      out[o] = __fmul_rn(__fmul_rn(fa[0], fa[1]), fa[2]);
      if (jac != nullptr) {
        jac[o] = __fmul_rn(__fmul_rn(ga[0], fa[1]), fa[2]);
        jac[plane + o] = __fmul_rn(__fmul_rn(ga[1], fa[0]), fa[2]);
        jac[2 * plane + o] = __fmul_rn(__fmul_rn(ga[2], fa[0]), fa[1]);
      }
    }
  }
}

// Backward: the sums of one feature slab in shared memory, the line values
// from device memory.
__global__ void cp_stacked_bwd_kernel(const __nv_bfloat16* __restrict__ lines,  // [3, F, R]
                                           const float* __restrict__ pos01,          // [N, 3]
                                           const int* __restrict__ rows,             // [F]
                                           const float* __restrict__ d_out,          // [C, N] or null
                                           const float* __restrict__ d_jac,          // [3, C, N] or null
                                           float* __restrict__ d_lines,              // [3, F, R], zeroed
                                           int N, int F, int R, int C, int FT) {
  extern __shared__ float sg[];  // [3, FT, R] gradient sums of this slab
  const int f0 = blockIdx.y * FT, nf = min(F, f0 + FT) - f0;
  for (int i = threadIdx.x; i < D * FT * R; i += blockDim.x) sg[i] = 0.f;
  __syncthreads();
  const float rm1 = (float)(R - 1);
  const size_t plane = (size_t)C * N;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += gridDim.x * blockDim.x) {
    int lo[D];
    float w0[D], w1[D], s0[D], s1[D];
    point_taps(pos01, n, R, rm1, lo, w0, w1, s0, s1);
#pragma unroll
    for (int ax = 0; ax < D; ++ax) {
      s0[ax] *= rm1;
      s1[ax] *= rm1;
    }
    for (int k = 0; k < nf; ++k) {
      const int f = f0 + k;
      float fa[D], ga[D], gj[D];
      const size_t o = (size_t)__ldg(rows + f) * N + n;
      const float go = d_out != nullptr ? d_out[o] : 0.f;
#pragma unroll
      for (int ax = 0; ax < D; ++ax) {
        const __nv_bfloat16* line = lines + ((size_t)(ax * F + f)) * R + lo[ax];
        float a = line_at(line), b = line_at(line + 1);
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
        float* g = sg + (ax * FT + k) * R + lo[ax];
        atomicAdd(g, dfa * w0[ax] + dga * s0[ax]);
        atomicAdd(g + 1, dfa * w1[ax] + dga * s1[ax]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * FT * R; i += blockDim.x) {
    const int ax = i / (FT * R), rem = i - ax * FT * R;
    const int k = rem / R, r = rem - k * R;
    if (k < nf && sg[i] != 0.f)
      atomicAdd(d_lines + ((size_t)(ax * F + f0 + k)) * R + r, sg[i]);
  }
}

// What the backward asks for at most, so that two of its blocks share an SM,
// and what a block may ask for at all (227 KB).
constexpr size_t SMEM_SLAB = 96 * 1024;
constexpr size_t SMEM_BLOCK_MAX = 232448;

}  // namespace

extern "C" int lotd_cp_stacked_fwd(const void* lines, const void* pos01, const void* rows,
                                   void* out, void* jac, int N, int F, int R, int C,
                                   void* stream) {
  if (F < 1 || R < 2) return (int)cudaErrorInvalidValue;
  const int threads = 256, FT = F < 8 ? F : 8;
  int blocks = (N + threads - 1) / threads;
  dim3 grid(blocks < 1 ? 1 : blocks, (F + FT - 1) / FT);
  cp_stacked_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)lines, (const float*)pos01, (const int*)rows, (float*)out,
      (float*)jac, N, F, R, C, FT);
  return (int)cudaGetLastError();
}

extern "C" int lotd_cp_stacked_bwd(const void* lines, const void* pos01, const void* rows,
                                   const void* d_out, const void* d_jac, void* d_lines, int N,
                                   int F, int R, int C, void* stream) {
  if (F < 1 || R < 2) return (int)cudaErrorInvalidValue;
  const size_t per_feat = (size_t)D * R * sizeof(float);
  if (per_feat > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
  int FT = (int)(SMEM_SLAB / per_feat);
  FT = FT < 1 ? 1 : (FT > F ? F : FT);
  const int slabs = (F + FT - 1) / FT, threads = 512;
  const size_t smem = per_feat * FT;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cp_stacked_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int bx = (N + threads - 1) / threads;               // two blocks an SM over all slabs
  const int cap = (132 * 2 + slabs - 1) / slabs;
  bx = bx < 1 ? 1 : (bx > cap ? cap : bx);
  dim3 grid(bx, slabs);
  cp_stacked_bwd_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)lines, (const float*)pos01, (const int*)rows,
      (const float*)d_out, (const float*)d_jac, (float*)d_lines, N, F, R, C, FT);
  return (int)cudaGetLastError();
}
