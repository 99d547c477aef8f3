// K5 neus_upsample: one NeuS upsample stage, in two launches.
//
// Replaces:
//   (a) neuralsim_tpu/fields/neus.py sdf_to_upsample_weights +
//       neighbor_cos_estimate (lines 80-100), with ops/segment.py
//       alpha_to_vw (lines 43-54) and sample_pdf (lines 229-276);
//   (b) neuralsim_tpu/ops/segment.py merge_sorted_samples (lines 150-190).
//
// (a) Per ray, over its S sorted samples t with sdf and mask:
//   cos_i  = clip((sdf_{i+1}-sdf_i) / max(t_{i+1}-t_i, 1e-6), -1e3, 0), last
//            sample padded with the previous estimate
//   dt_i   = t_{i+1}-t_i, 1e-3 for the last sample
//   alpha  = NeuS CDF-ratio alpha at inv_s, 0 where masked
//   w_i    = alpha_i * prod_{j<i} (1 - alpha_j + 1e-10)      (written out)
//   then the direct inverse CDF over bins = [t, max(far, near+1e-4)]:
//   t(u)   = bins_0 + sum_i len_i * clip((u-cdf_i)/max(cdf_{i+1}-cdf_i,1e-12),0,1)
//   with cdf from w + 1e-5 (not the searchsorted form), u the caller's
//   [nf] det midpoints (u_stride 0) or [N, nf] stratified draws.
// (b) Per ray, a stable merge of two ascending lists carrying mask and sdf:
//   element i of a goes to i + #{j: tb[j] < ta[i]}, element j of b to
//   j + #{i: ta[i] <= tb[j]} (on a tie the element of the first list goes
//   first), the rank placement of merge_sorted_samples.
//
// What bounds them on an H100: neither moves much (one 4096-ray stage reads
// ~1.5 MB and writes ~1.6 MB), so at the slice's shapes both are bound by
// launch latency and the per-ray sequential scans. The transmittance and the
// cdf are sequential recurrences; (a) gives each of a ray's nf draws its own
// thread, which recomputes the ray's weights in registers (the sigmoids are
// cheap next to the latency they hide), so a 4096-ray stage runs 65,536
// threads instead of 4,096. (b) has no recurrence: one warp a ray (four rays
// a block where they fit 48 KB of shared memory) loads both lists' depths with coalesced loads into shared memory,
// and each lane places ceil((A + B) / 32) elements by the two counts above,
// over the other list in shared memory (A x B compares a ray, split over the
// lanes). An element's position is exactly the plain version's, ties
// included, and a warp's stores land in its ray's one output row. So 4,096
// rays run 4,096 warps, with no chain of dependent loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float neus_alpha(float sdf, float cos, float dist, float inv_s) {
  const float eps = 1e-5f;
  float half = __fmul_rn(__fmul_rn(cos, dist), 0.5f);
  float cdf_prev = sigmoid(__fmul_rn(__fsub_rn(sdf, half), inv_s));
  float cdf_next = sigmoid(__fmul_rn(__fadd_rn(sdf, half), inv_s));
  float a = __fdiv_rn(__fadd_rn(__fsub_rn(cdf_prev, cdf_next), eps), __fadd_rn(cdf_prev, eps));
  return fminf(fmaxf(a, 0.f), 1.f);
}

// One thread per (ray, draw k). The nf threads of a ray each run the same
// sequential pass over the ray's samples (identical operations, so identical
// weights and cdf); thread k = 0 writes the weights.
__global__ void weights_pdf_kernel(const float* __restrict__ t,      // [N, S]
                                   const float* __restrict__ sdf,    // [N, S]
                                   const uint8_t* __restrict__ mask, // [N, S]
                                   const float* __restrict__ near,   // [N]
                                   const float* __restrict__ far,    // [N]
                                   const float* __restrict__ u,      // [nf] or [N, nf]
                                   float* __restrict__ w,            // [N, S]
                                   float* __restrict__ t_new,        // [N, nf]
                                   int N, int S, int nf, int u_stride, float inv_s) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = g / nf, k = g - r * nf;
  if (r >= N) return;
  const float* tr = t + (size_t)r * S;
  const float* sr = sdf + (size_t)r * S;
  const uint8_t* mr = mask + (size_t)r * S;

  // vw_i = alpha_i * T_i for sample i, carrying the transmittance
  auto weight = [&](int i, float& trans) {
    const int j = i < S - 1 ? i : S - 2;
    float dtj = fmaxf(__fsub_rn(tr[j + 1], tr[j]), 1e-6f);
    float cos = fminf(fmaxf(__fdiv_rn(__fsub_rn(sr[j + 1], sr[j]), dtj), -1e3f), 0.f);
    float dt = i < S - 1 ? __fsub_rn(tr[i + 1], tr[i]) : 1e-3f;
    float alpha = mr[i] ? neus_alpha(sr[i], cos, dt, inv_s) : 0.f;
    float vw = __fmul_rn(alpha, trans);
    trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f));
    return vw;
  };

  float trans = 1.f, total = 0.f;
  for (int i = 0; i < S; ++i) total = __fadd_rn(total, __fadd_rn(weight(i, trans), 1e-5f));

  const float uk = u[(size_t)r * u_stride + k];
  const float last = fmaxf(far[r], __fadd_rn(near[r], 1e-4f));
  float* wr = w + (size_t)r * S;
  float acc = 0.f, csum = 0.f, c0 = 0.f;
  trans = 1.f;
  for (int i = 0; i < S; ++i) {
    const float vw = weight(i, trans);
    if (k == 0) wr[i] = vw;
    csum = __fadd_rn(csum, __fadd_rn(vw, 1e-5f));
    float c1 = __fdiv_rn(csum, total);
    float len = __fsub_rn(i < S - 1 ? tr[i + 1] : last, tr[i]);
    float den = fmaxf(__fsub_rn(c1, c0), 1e-12f);
    float seg = fminf(fmaxf(__fdiv_rn(__fsub_rn(uk, c0), den), 0.f), 1.f);
    acc = __fadd_rn(acc, __fmul_rn(seg, len));
    c0 = c1;
  }
  t_new[(size_t)r * nf + k] = __fadd_rn(tr[0], acc);
}

constexpr int kMergeRays = 4;  // rays (warps) a block, fewer for lists past 48 KB a block

__global__ void merge_kernel(const float* __restrict__ ta, const float* __restrict__ tb,
                             const uint8_t* __restrict__ ma, const uint8_t* __restrict__ mb,
                             const float* __restrict__ sa, const float* __restrict__ sb,
                             float* __restrict__ t, uint8_t* __restrict__ m,
                             float* __restrict__ s, int N, int A, int B) {
  extern __shared__ float keys[];  // [rays a block][A + B]: the ray's ta, then tb
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= N) return;  // the whole warp
  const size_t oa = (size_t)r * A, ob = (size_t)r * B, o = (size_t)r * (A + B);
  float* ka = keys + warp * (A + B);
  float* kb = ka + A;
  for (int i = lane; i < A; i += 32) ka[i] = ta[oa + i];
  for (int j = lane; j < B; j += 32) kb[j] = tb[ob + j];
  __syncwarp();
  for (int i = lane; i < A; i += 32) {
    const float v = ka[i];
    int p = i;
    for (int j = 0; j < B; ++j) p += kb[j] < v;
    t[o + p] = v;
    m[o + p] = ma[oa + i];
    s[o + p] = sa[oa + i];
  }
  for (int j = lane; j < B; j += 32) {
    const float v = kb[j];
    int p = j;
#pragma unroll 8
    for (int i = 0; i < A; ++i) p += ka[i] <= v;
    t[o + p] = v;
    m[o + p] = mb[ob + j];
    s[o + p] = sb[ob + j];
  }
}

}  // namespace

extern "C" int neus_upsample_weights_pdf(const void* t, const void* sdf, const void* mask,
                                         const void* near, const void* far, const void* u,
                                         void* w, void* t_new, int N, int S, int nf,
                                         int u_stride, float inv_s, void* stream) {
  if (S < 2 || nf < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long long work = (long long)N * nf;
  const int blocks = work > 0 ? (int)((work + threads - 1) / threads) : 1;
  weights_pdf_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const float*)sdf, (const uint8_t*)mask, (const float*)near,
      (const float*)far, (const float*)u, (float*)w, (float*)t_new, N, S, nf, u_stride,
      inv_s);
  return (int)cudaGetLastError();
}

extern "C" int merge_sorted_samples(const void* ta, const void* tb, const void* ma,
                                    const void* mb, const void* sa, const void* sb, void* t,
                                    void* m, void* s, int N, int A, int B, void* stream) {
  if (A < 0 || B < 0) return (int)cudaErrorInvalidValue;
  // a ray's depths in shared memory: past the default 48 KB a block, fewer
  // rays a block, then one ray with the card's opt-in limit (227 KB on an H100)
  const size_t row = (size_t)(A + B) * sizeof(float);
  int rays = kMergeRays;
  while (rays > 1 && rays * row > 48 * 1024) --rays;
  const size_t smem = rays * row;
  if (smem > 48 * 1024) {
    cudaError_t e;
    int dev = 0, optin = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
        cudaSuccess)
      return (int)e;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    if ((e = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return (int)e;
  }
  const int blocks = N > 0 ? (N + rays - 1) / rays : 1;
  merge_kernel<<<blocks, 32 * rays, smem, (cudaStream_t)stream>>>(
      (const float*)ta, (const float*)tb, (const uint8_t*)ma, (const uint8_t*)mb,
      (const float*)sa, (const float*)sb, (float*)t, (uint8_t*)m, (float*)s, N, A, B);
  return (int)cudaGetLastError();
}
