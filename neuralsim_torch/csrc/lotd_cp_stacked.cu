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
// f32, in a buffer laid out [3, R, F] (feature fastest; the wrapper returns it
// transposed to [3, F, R]). No gradient goes to the positions.
//
// What bounds it on an H100: bytes, 16 * F cotangent bytes a point (0.0385 ms
// at 196,608 points, F 40). What held it back (0.15-0.30 ms there) was the
// target, 3*F*R floats that hundreds of thousands of points add to: a warp's
// lanes are neighbouring samples of one ray, so their cells along an axis
// repeat, and a shared float atomic is a compare-and-swap loop on sm_90a; and
// a launch of 512 points (the uniform eikonal) ran as one block a feature
// slab, one feature after the other. The design:
//  * the lanes of a warp that hold a run of equal cells along an axis (found
//    once a point and axis, warp_runs.cuh) sum each feature's two tap values
//    by shuffles, and only the run's first lane adds; where the next run
//    starts at the next cell, the shared entry takes one add;
//  * each run's sums go to the gradient with float4 device atomics (one a
//    value where F % 4 != 0), no copy in shared memory: with the runs
//    combined, a per-block copy summed with shared compare-and-swap loops
//    lost to the device atomics at every launch tried on the card (512 to
//    262,144 points, F 12-96, R 116-1,024);
//  * kLanes lanes take a point, each four of its features, so that an atomic
//    instruction of a warp adds neighbouring float4s of a gradient row: on
//    the card a device atomic cost about the same for a float or a float4,
//    and lanes that shared a line in one instruction raised the rate;
//  * block (x, y) takes feature groups kLanes y .., and the C entry sizes the
//    grid from N, F and the SM count, so a launch of 512 points spreads over
//    the card as one of 196,608 does.
// What holds it back now: without its atomics it still took most of its
// time (at 196,608 points, F 40): the scattered bf16 reads of the lines
// (two taps a feature and axis) and the cotangents, and the run structure.
//
// Why the lines' values get no copy in shared memory although [3, F, R] f32
// is only 16.7 KB at F=12, R=116: a pair of kernels that held it there was no
// faster than the forward and the slab backward of that time (NVIDIA H100
// 80GB HBM3, one call, 196,608 points: forward 0.031-0.034 against
// 0.023-0.030 ms, backward 0.245 against 0.177-0.182 ms), and one pair serves
// every width.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "warp_runs.cuh"


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

constexpr int G = 4;  // features a lane takes: a float4 of the gradient
// lanes a point: they take neighbouring float4s of its gradient rows, so that
// one atomic instruction of a warp adds 32 contiguous bytes a point (of 1, 2,
// 4 and 8 lanes, 2 was the fastest at the multi-object launches)
constexpr int kLanes = 2;
constexpr int kBwdThreads = 128;

// Point n's two tap values along each axis for the features f0 .. f0+G-1:
// v[ax][k] at entry lo, v[ax][G + k] at lo + 1 (0 for a feature past F or a
// lane past N).
__device__ __forceinline__ void tap_grads(const __nv_bfloat16* __restrict__ lines,
                                          const int* __restrict__ rows,
                                          const float* __restrict__ d_out,
                                          const float* __restrict__ d_jac, int n, bool valid,
                                          int f0, int F, int R, int N, size_t plane,
                                          const WarpPoints& p, float (&v)[D][2 * G]) {
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int f = f0 + k;
    float fa[D] = {0.f, 0.f, 0.f}, ga[D] = {0.f, 0.f, 0.f}, gj[D] = {0.f, 0.f, 0.f};
    float go = 0.f;
    if (valid && f < F) {
      const size_t o = (size_t)__ldg(rows + f) * N + n;
      go = d_out != nullptr ? d_out[o] : 0.f;
#pragma unroll
      for (int ax = 0; ax < D; ++ax) {
        const __nv_bfloat16* line = lines + ((size_t)(ax * F + f)) * R + p.lo[ax];
        const float a = line_at(line), b = line_at(line + 1);
        fa[ax] = a * p.w0[ax] + b * p.w1[ax];
        ga[ax] = a * p.s0[ax] + b * p.s1[ax];
        gj[ax] = d_jac != nullptr ? d_jac[ax * plane + o] : 0.f;
      }
    }
#pragma unroll
    for (int ax = 0; ax < D; ++ax) {
      const int o1 = (ax + 1) % D, o2 = (ax + 2) % D;
      const float dfa = go * fa[o1] * fa[o2] + gj[o1] * ga[o1] * fa[o2]
                        + gj[o2] * ga[o2] * fa[o1];
      const float dga = gj[ax] * fa[o1] * fa[o2];
      v[ax][k] = dfa * p.w0[ax] + dga * p.s0[ax];
      v[ax][G + k] = dfa * p.w1[ax] + dga * p.s1[ax];
    }
  }
}

// Block (x, y) adds features G (kLanes y + slot) .. + G-1 of its points to
// the gradient with device atomics, one add a run and tap: a warp takes 32 /
// kLanes points, kLanes lanes a point (lane = kLanes point + slot).
__global__ void __launch_bounds__(kBwdThreads)
cp_stacked_bwd_kernel(const __nv_bfloat16* __restrict__ lines,  // [3, F, R]
                      const float* __restrict__ pos01,          // [N, 3]
                      const int* __restrict__ rows,             // [F]
                      const float* __restrict__ d_out,          // [C, N] or null
                      const float* __restrict__ d_jac,          // [3, C, N] or null
                      float* __restrict__ d_lines,              // [3, R, F], zeroed
                      int N, int F, int R, int C) {
  constexpr int P = 32 / kLanes;  // points a warp
  const int lane = threadIdx.x & 31;
  const int f0 = (blockIdx.y * kLanes + lane % kLanes) * G, m = min(G, F - f0);
  const bool vec = F % 4 == 0;  // every group of four is whole and 16-byte aligned
  const float rm1 = (float)(R - 1);
  const size_t plane = (size_t)C * N;
  const int warps = gridDim.x * (blockDim.x >> 5);
  // whole warps walk the points, so every lane reaches the warp intrinsics
  for (int base = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * P; base < N;
       base += warps * P) {
    const int n = base + lane / kLanes;
    const bool valid = n < N;
    WarpPoints p;
    point_taps(pos01, valid ? n : 0, R, rm1, p.lo, p.w0, p.w1, p.s0, p.s1);
    find_tap_runs<kLanes>(p, valid, rm1, lane);
    float v[D][2 * G];
    tap_grads(lines, rows, d_out, d_jac, n, valid, f0, F, R, N, plane, p, v);
#pragma unroll
    for (int ax = 0; ax < D; ++ax) {
      tap_sum<kLanes, G>(p.t[ax], v[ax]);
      if (p.t[ax].r.head && valid && m > 0) {
        float* e = d_lines + ((size_t)ax * R + p.lo[ax]) * F + f0;
        add4_global<0>(e, v[ax], m, vec);
        if (!p.t[ax].give_next) add4_global<G>(e + F, v[ax], m, vec);
      }
    }
  }
}

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

// d_lines: [3, R, F] float32, zeroed.
extern "C" int lotd_cp_stacked_bwd(const void* lines, const void* pos01, const void* rows,
                                   const void* d_out, const void* d_jac, void* d_lines, int N,
                                   int F, int R, int C, void* stream) {
  if (F < 1 || R < 2 || N < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int gy = (F + G * kLanes - 1) / (G * kLanes);
  const int per_block = kBwdThreads / kLanes;  // points a block-wide step
  int bx = (N + per_block - 1) / per_block;    // up to 16 blocks an SM
  const int cap = (sms * 16 + gy - 1) / gy;
  bx = bx < 1 ? 1 : (bx > cap ? cap : bx);
  cp_stacked_bwd_kernel<<<dim3(bx, gy), kBwdThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)lines, (const float*)pos01, (const int*)rows,
      (const float*)d_out, (const float*)d_jac, (float*)d_lines, N, F, R, C);
  return (int)cudaGetLastError();
}
