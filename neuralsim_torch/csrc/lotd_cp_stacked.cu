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
// redundant MACs); here only the two nonzero taps per axis are computed, and
// the lines ([3, F, R] f32, 16.7 KB at F=12, R=116) sit in shared memory so
// every tap is a shared-memory read. The outputs are feature-major, so the
// threads of a warp (neighbouring points) store to neighbouring addresses. A
// grid-stride loop over a capped grid keeps the per-block line load small
// against the output traffic.
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
// 3*F*R floats for up to 196,608 points, where global atomics would
// serialise. So every block sums into a copy in shared memory (f32 shared
// atomics) and adds its copy to the global gradient once at the end.
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

__global__ void cp_stacked_kernel(const __nv_bfloat16* __restrict__ lines,  // [3, F, R]
                                  const float* __restrict__ pos01,          // [N, 3]
                                  const int* __restrict__ rows,             // [F]
                                  float* __restrict__ out,                  // [C, N]
                                  float* __restrict__ jac,                  // [3, C, N] or null
                                  int N, int F, int R, int C) {
  extern __shared__ float sl[];  // [3, F, R] as f32
  for (int i = threadIdx.x; i < D * F * R; i += blockDim.x)
    sl[i] = __bfloat162float(lines[i]);
  __syncthreads();
  const float rm1 = (float)(R - 1);
  const size_t plane = (size_t)C * N;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += gridDim.x * blockDim.x) {
    int lo[D];
    float w0[D], w1[D], s0[D], s1[D];
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
    for (int f = 0; f < F; ++f) {
      float fa[D], ga[D];
#pragma unroll
      for (int ax = 0; ax < D; ++ax) {
        const float* line = sl + (ax * F + f) * R + lo[ax];
        float a = line[0], b = line[1];
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

__global__ void cp_stacked_bwd_kernel(const __nv_bfloat16* __restrict__ lines,  // [3, F, R]
                                      const float* __restrict__ pos01,          // [N, 3]
                                      const int* __restrict__ rows,             // [F]
                                      const float* __restrict__ d_out,          // [C, N] or null
                                      const float* __restrict__ d_jac,          // [3, C, N] or null
                                      float* __restrict__ d_lines,              // [3, F, R], zeroed
                                      int N, int F, int R, int C) {
  extern __shared__ float sl[];  // [3, F, R] line values, then [3, F, R] gradient sums
  float* sg = sl + D * F * R;
  for (int i = threadIdx.x; i < D * F * R; i += blockDim.x) {
    sl[i] = __bfloat162float(lines[i]);
    sg[i] = 0.f;
  }
  __syncthreads();
  const float rm1 = (float)(R - 1);
  const size_t plane = (size_t)C * N;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += gridDim.x * blockDim.x) {
    int lo[D];
    float w0[D], w1[D], s0[D], s1[D];
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
      s0[ax] = tent_slope(d0) * rm1;
      s1[ax] = tent_slope(d1) * rm1;
    }
    for (int f = 0; f < F; ++f) {
      float fa[D], ga[D], gj[D];
      const size_t o = (size_t)__ldg(rows + f) * N + n;
      const float go = d_out != nullptr ? d_out[o] : 0.f;
#pragma unroll
      for (int ax = 0; ax < D; ++ax) {
        const float* line = sl + (ax * F + f) * R + lo[ax];
        float a = line[0], b = line[1];
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
        float* g = sg + (ax * F + f) * R + lo[ax];
        atomicAdd(g, dfa * w0[ax] + dga * s0[ax]);
        atomicAdd(g + 1, dfa * w1[ax] + dga * s1[ax]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * F * R; i += blockDim.x)
    if (sg[i] != 0.f) atomicAdd(d_lines + i, sg[i]);
}

}  // namespace

extern "C" int lotd_cp_stacked_fwd(const void* lines, const void* pos01, const void* rows,
                                   void* out, void* jac, int N, int F, int R, int C,
                                   void* stream) {
  const int threads = 256;
  int blocks = (N + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : (blocks > 132 * 4 ? 132 * 4 : blocks);
  size_t smem = (size_t)D * F * R * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cp_stacked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cp_stacked_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)lines, (const float*)pos01, (const int*)rows, (float*)out,
      (float*)jac, N, F, R, C);
  return (int)cudaGetLastError();
}

extern "C" int lotd_cp_stacked_bwd(const void* lines, const void* pos01, const void* rows,
                                   const void* d_out, const void* d_jac, void* d_lines, int N,
                                   int F, int R, int C, void* stream) {
  const int threads = 256;
  int blocks = (N + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : (blocks > 132 * 2 ? 132 * 2 : blocks);
  size_t smem = (size_t)2 * D * F * R * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cp_stacked_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cp_stacked_bwd_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)lines, (const float*)pos01, (const int*)rows,
      (const float*)d_out, (const float*)d_jac, (float*)d_lines, N, F, R, C);
  return (int)cudaGetLastError();
}
