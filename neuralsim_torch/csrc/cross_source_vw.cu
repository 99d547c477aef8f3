// K8 cross_source_vw: exact visibility weights of an UNSORTED merged buffer,
// the order-free composite of the multi-object compose renderer (forward).
//
// Replaces: neuralsim_tpu/ops/segment.py cross_source_vw (lines 105-147),
//   which the sort-free merge of neuralsim_tpu/renderers/buffers.py
//   merge_and_integrate (lines 91-103) runs over the concatenated lanes of
//   every object, the street and the distant field.
//
// Per ray, over its L lanes (any order; masked lanes anywhere):
//   a_i      = mask_i ? clip(alpha_i, 0, 1) : 0
//   log1ma_i = log1p(-min(a_i, 0.999))        (an occluder lets 1e-3 through)
//   key_i    = mask_i ? t_i : 1e10
//   log T_i  = sum_j [(key_j, j) < (key_i, i)] * log1ma_j   (ties by lane index)
//   vw_i     = a_i * exp(log T_i)
// which is what a stable depth sort followed by the transmittance product
// gives, without sorting or gathering.
//
// What bounds it on an H100: operations. The compare-and-add is O(L^2) per
// ray (28,224 pairs at L = 168) against 13 bytes per lane of traffic (t,
// alpha, mask in; vw out). Design: one warp per ray. The warp stages the
// ray's keys, log1ma and a in shared memory (12 bytes a lane), then each
// lane owns the lanes i = lane + 32 g, g < G, keeps their keys and sums in
// registers, and walks every j once: one broadcast read of (key_j, log1ma_j)
// from shared memory feeds G compares. The sum runs over j in order, 0 to
// L - 1, in float32; log1pf and expf as PyTorch's own. Any L runs, 32 G
// lanes a pass; shared memory bounds L at 1,024 for four warps a block, and
// the launcher takes fewer warps for longer rows (up to 4,096 with one).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 8;               // lanes i owned by one thread per pass
constexpr float BIG = 1e10f;
constexpr float OCC_CAP = 0.999f;  // 1 - 1e-3, as the plain version rounds it

__global__ void cross_source_vw_kernel(const float* __restrict__ t,      // [N, L]
                                       const uint8_t* __restrict__ mask, // [N, L]
                                       const float* __restrict__ alpha,  // [N, L]
                                       float* __restrict__ vw,           // [N, L]
                                       int N, int L) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= N) return;  // whole warps leave together
  float* skey = smem + (size_t)warp * 3 * L;
  float* slog = skey + L;
  float* sa = slog + L;
  const size_t o = (size_t)r * L;
  for (int j = lane; j < L; j += 32) {
    const bool m = mask[o + j] != 0;
    const float a = m ? fminf(fmaxf(alpha[o + j], 0.f), 1.f) : 0.f;
    skey[j] = m ? t[o + j] : BIG;
    slog[j] = log1pf(-fminf(a, OCC_CAP));
    sa[j] = a;
  }
  __syncwarp();
  for (int base = 0; base < L; base += 32 * G) {
    float ki[G], acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = base + lane + 32 * g;
      ki[g] = i < L ? skey[i] : BIG;
      acc[g] = 0.f;
    }
    for (int j = 0; j < L; ++j) {
      const float kj = skey[j];
      const float lj = slog[j];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int i = base + lane + 32 * g;
        const bool before = kj < ki[g] || (kj == ki[g] && j < i);
        acc[g] += before ? lj : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = base + lane + 32 * g;
      if (i < L) vw[o + i] = sa[i] * expf(acc[g]);
    }
  }
}

}  // namespace

extern "C" int cross_source_vw(const void* t, const void* mask, const void* alpha, void* vw,
                               int N, int L, void* stream) {
  if (N < 0 || L < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int per_warp = 3 * L * (int)sizeof(float);
  int warps = 4;
  while (warps > 1 && warps * per_warp > 48 * 1024) warps /= 2;
  if (warps * per_warp > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (N + warps - 1) / warps;
  cross_source_vw_kernel<<<blocks, 32 * warps, warps * per_warp, (cudaStream_t)stream>>>(
      (const float*)t, (const uint8_t*)mask, (const float*)alpha, (float*)vw, N, L);
  return (int)cudaGetLastError();
}
