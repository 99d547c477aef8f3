// K8 cross_source_vw: exact visibility weights of an UNSORTED merged buffer,
// the order-free composite of the multi-object compose renderer, forward and
// backward.
//
// Replaces: neuralsim_tpu/ops/segment.py cross_source_vw (lines 105-147) and
//   JAX's autodiff of it, which the sort-free merge of
//   neuralsim_tpu/renderers/buffers.py merge_and_integrate (lines 91-103)
//   runs over the concatenated lanes of every object, the street and the
//   distant field.
//
// Per ray, over its L lanes (any order; masked lanes anywhere):
//   a_i      = mask_i ? clip(alpha_i, 0, 1) : 0
//   log1ma_i = log1p(-min(a_i, 0.999))        (an occluder lets 1e-3 through)
//   key_i    = mask_i ? t_i : 1e10
//   S_i      = sum_j [(key_j, j) < (key_i, i)] * log1ma_j   (ties by lane index)
//   vw_i     = a_i * exp(S_i)
// which is what a stable depth sort followed by the transmittance product
// gives, without sorting or gathering. With g = dL/dvw:
//   dL/da_k = g_k exp(S_k) + l'_k * sum_{i : (key_k, k) < (key_i, i)} g_i vw_i
//   l'_k    = -1 / (1 - min(a_k, 0.999)) times JAX's gradient of the min
//             (1 below the cap, 1/2 at a tie, 0 above)
//   dL/dalpha_k = mask_k ? dL/da_k times the clip's gradient (1 inside
//             (0, 1), 1/2 at exactly 0 or 1, 0 outside) : 0
// (jnp.clip and jnp.minimum split a tie's gradient in halves, and so do
// torch.maximum and torch.minimum of the plain version). No gradient goes to
// t: the order is not differentiable.
//
// What bounds it on an H100: operations. The compare-and-add is O(L^2) per
// ray (28,224 pairs at L = 168) against 13 bytes per lane of traffic in the
// forward (t, alpha, mask in; vw out; 4 more with S) and 21 in the backward
// (t, mask, alpha, S, g in; d alpha out). Design, both passes: one warp per
// ray. The warp stages the ray's keys and one value per lane in shared
// memory (forward: log1ma and a, 12 bytes a lane; backward: u_i = g_i vw_i,
// 8 bytes a lane), then each lane owns the lanes i = lane + 32 g, g < G,
// keeps their keys and sums in registers, and walks every j once: one
// broadcast read of (key_j, value_j) from shared memory feeds G compares.
// The sum runs over j in order, 0 to L - 1, in float32; log1pf and expf as
// PyTorch's own. The forward writes S when the backward will want it, so the
// backward does not repeat the forward's loop for the transmittance: it has
// one O(L^2) loop of its own, the sum of u over the lanes after k. Any L
// runs, 32 G lanes a pass; shared memory bounds L at 1,024 for four warps a
// block, and the launchers take fewer warps for longer rows (up to 4,096
// forward, 6,144 backward, with one).
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
                                       float* __restrict__ logt,         // [N, L] or null
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
      if (i < L) {
        vw[o + i] = sa[i] * expf(acc[g]);
        if (logt != nullptr) logt[o + i] = acc[g];
      }
    }
  }
}

// The gradient of jnp.clip(x, 0, 1) and of jnp.minimum(x, cap): a tie splits it.
__device__ __forceinline__ float clip_grad(float x) {
  return (x > 0.f && x < 1.f) ? 1.f : ((x == 0.f || x == 1.f) ? 0.5f : 0.f);
}

__global__ void cross_source_vw_bwd_kernel(const float* __restrict__ t,      // [N, L]
                                           const uint8_t* __restrict__ mask, // [N, L]
                                           const float* __restrict__ alpha,  // [N, L]
                                           const float* __restrict__ logt,   // [N, L] S
                                           const float* __restrict__ g_vw,   // [N, L]
                                           float* __restrict__ d_alpha,      // [N, L]
                                           int N, int L) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= N) return;  // whole warps leave together
  float* skey = smem + (size_t)warp * 2 * L;
  float* su = skey + L;
  const size_t o = (size_t)r * L;
  for (int j = lane; j < L; j += 32) {
    const bool m = mask[o + j] != 0;
    const float a = m ? fminf(fmaxf(alpha[o + j], 0.f), 1.f) : 0.f;
    skey[j] = m ? t[o + j] : BIG;
    su[j] = g_vw[o + j] * (a * expf(logt[o + j]));  // g_j * vw_j
  }
  __syncwarp();
  for (int base = 0; base < L; base += 32 * G) {
    float kk[G], acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int k = base + lane + 32 * g;
      kk[g] = k < L ? skey[k] : BIG;
      acc[g] = 0.f;
    }
    for (int i = 0; i < L; ++i) {
      const float ki = skey[i];
      const float ui = su[i];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int k = base + lane + 32 * g;
        const bool after = kk[g] < ki || (kk[g] == ki && k < i);
        acc[g] += after ? ui : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int k = base + lane + 32 * g;
      if (k >= L) continue;
      if (mask[o + k] == 0) {
        d_alpha[o + k] = 0.f;
        continue;
      }
      const float x = alpha[o + k];
      const float a = fminf(fmaxf(x, 0.f), 1.f);
      const float cap_grad = a < OCC_CAP ? 1.f : (a == OCC_CAP ? 0.5f : 0.f);
      const float dl = -cap_grad / (1.f - fminf(a, OCC_CAP));
      const float da = g_vw[o + k] * expf(logt[o + k]) + dl * acc[g];
      d_alpha[o + k] = da * clip_grad(x);
    }
  }
}

// Warps a block for rows of L lanes at `per_lane` bytes of shared memory each.
int warps_for(int L, int per_lane) {
  const int per_warp = per_lane * L;
  int warps = 4;
  while (warps > 1 && warps * per_warp > 48 * 1024) warps /= 2;
  return warps * per_warp > 48 * 1024 ? 0 : warps;
}

}  // namespace

extern "C" int cross_source_vw(const void* t, const void* mask, const void* alpha, void* vw,
                               void* logt, int N, int L, void* stream) {
  if (N < 0 || L < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int warps = warps_for(L, 3 * (int)sizeof(float));
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const int blocks = (N + warps - 1) / warps;
  cross_source_vw_kernel<<<blocks, 32 * warps, warps * 3 * L * (int)sizeof(float),
                           (cudaStream_t)stream>>>(
      (const float*)t, (const uint8_t*)mask, (const float*)alpha, (float*)vw, (float*)logt,
      N, L);
  return (int)cudaGetLastError();
}

extern "C" int cross_source_vw_bwd(const void* t, const void* mask, const void* alpha,
                                   const void* logt, const void* g_vw, void* d_alpha, int N,
                                   int L, void* stream) {
  if (N < 0 || L < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int warps = warps_for(L, 2 * (int)sizeof(float));
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const int blocks = (N + warps - 1) / warps;
  cross_source_vw_bwd_kernel<<<blocks, 32 * warps, warps * 2 * L * (int)sizeof(float),
                               (cudaStream_t)stream>>>(
      (const float*)t, (const uint8_t*)mask, (const float*)alpha, (const float*)logt,
      (const float*)g_vw, (float*)d_alpha, N, L);
  return (int)cudaGetLastError();
}
