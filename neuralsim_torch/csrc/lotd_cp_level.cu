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
// No gradient goes to the positions; the caller's buffer may already hold the
// dense/hash gradient.
//
// What bounds it on an H100: bytes, 16 * F cotangent bytes a point and level
// (0.0383 ms for the street's ten levels at 196,608 points). What held it
// back (0.64 ms there) was contention: a coarse level's whole gradient is
// 3 x 16 x 4 floats under 10^5 points, a warp's lanes are neighbouring
// samples of one ray (their cells repeat), a shared float atomic is a
// compare-and-swap loop on sm_90a, and every level got the same blocks, run
// one level after the other, whatever its size. The design:
//  * the lanes of a warp that hold a run of equal cells along an axis (found
//    once a point, level and axis, warp_runs.cuh) sum each feature's two tap
//    values by shuffles, and only the run's first lane adds; where the next
//    run starts at the next cell, the shared entry takes one add;
//  * each run's sums go to the table's gradient with float4 device atomics
//    (one a value where F % 4 != 0 or the segment is not 16-byte aligned),
//    no copy in shared memory: with the runs combined, copies of the coarse
//    levels summed with shared compare-and-swap loops lost to the device
//    atomics on every ladder timed on the card (PERF.md);
//  * the grid is persistent: each block walks (level, chunk of S points)
//    items, levels interleaved (item i is level i % L), so that at any moment
//    the blocks add to every level and a coarse level's few entries never
//    take the whole card's adds at once; the C entry sizes S and the grid
//    from N, L and the SM count, about four items a block, so a launch of
//    512 points spreads over L x 16 blocks. What bounds it now is the rate of
//    the device atomics (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "warp_runs.cuh"

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

constexpr int G = 4;  // features a thread takes at once: a float4
constexpr int kBwdThreads = 256;

// Point n's two tap values along each axis for the level's features f0 ..
// f0+G-1 below F: v[ax][k] at entry lo, v[ax][G + k] at lo + 1 (0 for a
// feature past F or a lane past the item).
__device__ __forceinline__ void tap_grads(const float* __restrict__ lines,  // [3, R, F]
                                          const float* __restrict__ d_out,
                                          const float* __restrict__ d_jac, int n, bool valid,
                                          int f0, int F, int R, int row, int N, size_t plane,
                                          const WarpPoints& p, float (&v)[D][2 * G]) {
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int f = f0 + k;
    float fa[D] = {0.f, 0.f, 0.f}, ga[D] = {0.f, 0.f, 0.f}, gj[D] = {0.f, 0.f, 0.f};
    float go = 0.f;
    if (valid && f < F) {
      const size_t o = (size_t)(row + f) * N + n;
      go = d_out != nullptr ? d_out[o] : 0.f;
#pragma unroll
      for (int ax = 0; ax < D; ++ax) {
        const float* q = lines + ((size_t)ax * R + p.lo[ax]) * F + f;
        const float a = bf16_round(__ldg(q)), b = bf16_round(__ldg(q + F));
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

// Backward: each block walks items (level l, points [c S, (c+1) S)), item i
// being level i % L, chunk i / L.
__global__ void __launch_bounds__(kBwdThreads)
cp_level_bwd_kernel(const float* __restrict__ table,
                    const float* __restrict__ pos01,  // [N, 3]
                    const int* __restrict__ meta,     // [L, 4]
                    const float* __restrict__ d_out,  // [C, N] or null
                    const float* __restrict__ d_jac,  // [3, C, N] or null
                    float* __restrict__ d_table,      // flat, f32
                    int N, int C, int L, int S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int items = L * ((N + S - 1) / S);
  const size_t plane = (size_t)C * N;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int l = item % L, p0 = (item / L) * S, p1 = min(N, p0 + S);
    const int* m = meta + l * META;
    const int R = __ldg(m), off = __ldg(m + 1), F = __ldg(m + 2), row = __ldg(m + 3);
    const float* lines = table + off;  // [3, R, F]
    float* dst = d_table + off;
    const bool vec = F % 4 == 0 && (reinterpret_cast<size_t>(dst) & 15) == 0;
    const float rm1 = (float)(R - 1);
    // whole warps walk the points, so every lane reaches the warp intrinsics
    for (int base = p0 + warp * 32; base < p1; base += nwarps * 32) {
      const int n = base + lane;
      const bool valid = n < p1;
      WarpPoints p;
      point_taps(pos01, valid ? n : p0, R, p.lo, p.w0, p.w1, p.s0, p.s1);
      find_tap_runs<1>(p, valid, rm1, lane);
      for (int f0 = 0; f0 < F; f0 += G) {
        float v[D][2 * G];
        tap_grads(lines, d_out, d_jac, n, valid, f0, F, R, row, N, plane, p, v);
        const int mf = min(G, F - f0);
#pragma unroll
        for (int ax = 0; ax < D; ++ax) {
          tap_sum<1, G>(p.t[ax], v[ax]);
          if (p.t[ax].r.head && valid) {
            float* e = dst + (ax * R + p.lo[ax]) * F + f0;
            add4_global<0>(e, v[ax], mf, vec);
            if (!p.t[ax].give_next) add4_global<G>(e + F, v[ax], mf, vec);
          }
        }
      }
    }
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
  if (L < 1 || N < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  // two blocks an SM; items of S points (whole warps), about four a block
  const long long blocks_max = 2LL * sms;
  const long long per = ((long long)N * L + 4 * blocks_max - 1) / (4 * blocks_max);
  const int S = per < 32 ? 32 : (int)((per + 31) / 32 * 32);
  const long long items = (long long)L * ((N + S - 1) / S);
  const int blocks = (int)(items < 1 ? 1 : (items < blocks_max ? items : blocks_max));
  cp_level_bwd_kernel<<<blocks, kBwdThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)pos01, (const int*)meta, (const float*)d_out,
      (const float*)d_jac, (float*)d_table, N, C, L, S);
  return (int)cudaGetLastError();
}
