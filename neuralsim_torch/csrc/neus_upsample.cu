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
//   w_i    = alpha_i * prod_{j<i} (1 - alpha_j + 1e-10)      (written if asked)
//   then the direct inverse CDF over bins = [t, max(far, near+1e-4)]:
//   t(u)   = bins_0 + sum_i len_i * clip((u-cdf_i)/max(cdf_{i+1}-cdf_i,1e-12),0,1)
//   with cdf from w + 1e-5 (not the searchsorted form), u the caller's
//   [nf] det midpoints or, from [N, nf] noise, the stratified draws
//   u_k = (k + noise_k) * rcp(nf): the float32 roundings that PyTorch gives
//   `(arange(nf) + noise) / nf` on a CUDA tensor (it multiplies by the
//   reciprocal of a scalar divisor), so the kernel needs no glue launches.
// (b) Per ray, a stable merge of two ascending lists carrying mask and sdf:
//   element i of a goes to i + #{j: tb[j] < ta[i]}, element j of b to
//   j + #{i: ta[i] <= tb[j]} (on a tie the element of the first list goes
//   first), the rank placement of merge_sorted_samples.
//
// What bounds them on an H100: neither moves much (one 4096-ray stage reads
// ~1.5 MB and writes ~1.6 MB), so at the slice's shapes both are bound by
// launch latency and the per-ray sequential scans. The transmittance and the
// cdf are sequential recurrences, which must keep the plain order for the
// draws to keep their bits; (a) computes each sample's alpha once in a group
// of lanes, walks the recurrences from shared memory in every lane of the
// group and finds each draw's bin by binary search (see weights_pdf_kernel).
// (b) has no recurrence: one warp a ray (four rays
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

// G = 16 lanes a ray, two rays a warp (the two rays share each of the
// walk's instructions). The group first stages the ray's
// depths, sdf and mask in shared memory (one round of loads). Lane l owns
// samples l, l + G, ...: it computes each owned sample's cos, dt and alpha
// once, with the operations and roundings of the plain chain, and stages the
// alpha and the bin length in shared memory. The recurrences stay
// sequential and in the plain order, so their bits do not move: every lane
// of the group walks the transmittance product and the running cdf sum step
// by step from broadcast reads, and the owner of sample i keeps its weight,
// its cdf sum and P_i, the sequential prefix ((len_0 + len_1) + ...) +
// len_{i-1}. Then one lane a draw (draws past G take more passes) finds by
// binary search the last bin b with c0_b < u (b = 0 where there is none)
// and returns bins_0 + (P_b + seg_b * len_b), which equals the plain loop's
// sum bit for bit:
//   - bins before b give seg = 1 exactly: c1_i <= c0_b < u, so
//     u - c0_i >= c1_i - c0_i in floats (rounding is monotone), and the
//     1e-12 clamp never binds (each cdf step is at least (1e-5 - ulp) /
//     total, total <= 1 + S 1e-5); so the plain sum adds len_i * 1 = len_i,
//     which is P_b;
//   - bins after b have c0_i >= u, so seg = clip(<= 0) = +-0, and adding
//     +-0 * len leaves the sum (never -0) as it is; a u on a bin edge
//     (u = c1_b) gives seg_b = 1 and the next bin 0;
//   - the cdf is never NaN (alpha is clipped by fminf/fmaxf, which drop a
//     NaN), and a NaN u gives b = 0, seg 0, as the plain loop does.
// A non-finite bin length past b would make the plain sum NaN (0 * inf): the
// draw returns NaN then. The weights are written only where the caller asks
// (w not null).
constexpr int G = 16;  // lanes a ray
constexpr int kUpsampleRowsPerWarp = 32 / G;

__global__ void weights_pdf_kernel(const float* __restrict__ t,      // [N, S]
                                   const float* __restrict__ sdf,    // [N, S]
                                   const uint8_t* __restrict__ mask, // [N, S]
                                   const float* __restrict__ near,   // [N]
                                   const float* __restrict__ far,    // [N]
                                   const float* __restrict__ u,      // [nf] or null
                                   const float* __restrict__ noise,  // [N, nf] or null
                                   float* __restrict__ w,            // [N, S] or null
                                   float* __restrict__ t_new,        // [N, nf]
                                   int N, int S, int nf, float inv_s) {
  extern __shared__ float sm[];  // [rays a block][8 S + 1]
  const int lane = threadIdx.x & 31, gl = lane & (G - 1);
  const int slot = threadIdx.x / G;                // the ray's place in the block
  const int first = blockIdx.x * (blockDim.x / G);
  if (first + (threadIdx.x >> 5) * kUpsampleRowsPerWarp >= N) return;  // the whole warp
  // a group past N walks the last ray again (the warp stays whole for its
  // shuffles) and writes nothing
  const bool valid = first + slot < N;
  const int r = valid ? first + slot : N - 1;
  float* s_t = sm + (size_t)slot * (8 * S + 1);
  float* s_sdf = s_t + S;
  float* s_m = s_sdf + S;
  float* s_alpha = s_m + S;
  float* s_len = s_alpha + S;
  float* s_vw = s_len + S;
  float* s_P = s_vw + S;
  float* s_cdf = s_P + S;  // S + 1: c0_i = s_cdf[i], c1_i = s_cdf[i + 1]
  // every load in one round: the ray's depths, sdf and mask into shared
  // memory, its near and far, and the lane's first draw
  for (int i = gl; i < S; i += G) {
    s_t[i] = t[(size_t)r * S + i];
    s_sdf[i] = sdf[(size_t)r * S + i];
    s_m[i] = mask[(size_t)r * S + i] ? 1.f : 0.f;
  }
  const float last = fmaxf(far[r], __fadd_rn(near[r], 1e-4f));
  const float inv_nf = __frcp_rn((float)nf);
  auto draw = [&](int k) {
    return noise != nullptr ? __fmul_rn(__fadd_rn((float)k, noise[(size_t)r * nf + k]), inv_nf)
                            : u[k];
  };
  const float u_first = gl < nf ? draw(gl) : 0.f;
  __syncwarp();

  int bad = -1;  // the last bin whose length is not finite
  for (int i = gl; i < S; i += G) {
    const int j = i < S - 1 ? i : S - 2;
    const float dtj = fmaxf(__fsub_rn(s_t[j + 1], s_t[j]), 1e-6f);
    const float cos =
        fminf(fmaxf(__fdiv_rn(__fsub_rn(s_sdf[j + 1], s_sdf[j]), dtj), -1e3f), 0.f);
    const float dt = i < S - 1 ? __fsub_rn(s_t[i + 1], s_t[i]) : 1e-3f;
    s_alpha[i] = s_m[i] != 0.f ? neus_alpha(s_sdf[i], cos, dt, inv_s) : 0.f;
    const float len = __fsub_rn(i < S - 1 ? s_t[i + 1] : last, s_t[i]);
    s_len[i] = len;
    if (!(fabsf(len) <= 3.402823466e38f)) bad = i;  // inf or NaN
  }
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) bad = max(bad, __shfl_xor_sync(0xffffffffu, bad, d));
  __syncwarp();

  // vw_i = alpha_i * T_i, T_{i+1} = T_i * ((1 - alpha_i) + 1e-10), the cdf's
  // running sum of vw + 1e-5 and P, in the plain order, in every lane
  float trans = 1.f, csum = 0.f, P = 0.f;
#pragma unroll 8
  for (int i = 0; i < S; ++i) {
    const float alpha = s_alpha[i];
    const float vw = __fmul_rn(alpha, trans);
    trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f));
    csum = __fadd_rn(csum, __fadd_rn(vw, 1e-5f));
    if ((i & (G - 1)) == gl) {
      s_vw[i] = vw;
      s_cdf[i + 1] = csum;
      s_P[i] = P;
    }
    P = __fadd_rn(P, s_len[i]);
  }
  const float total = csum;
  for (int i = gl; i < S; i += G) s_cdf[i + 1] = __fdiv_rn(s_cdf[i + 1], total);
  if (gl == 0) s_cdf[0] = 0.f;
  if (w != nullptr && valid)
    for (int i = gl; i < S; i += G) w[(size_t)r * S + i] = s_vw[i];
  __syncwarp();

  for (int k = gl; k < nf; k += G) {
    const float uk = k == gl ? u_first : draw(k);
    int lo = 0, n = S;  // lo: the number of bins with c0 < u
    while (n > 0) {
      const int h = n >> 1;
      if (s_cdf[lo + h] < uk) {
        lo += h + 1;
        n -= h + 1;
      } else {
        n = h;
      }
    }
    const int b = lo > 0 ? lo - 1 : 0;
    const float c0 = s_cdf[b];
    const float den = fmaxf(__fsub_rn(s_cdf[b + 1], c0), 1e-12f);
    const float seg = fminf(fmaxf(__fdiv_rn(__fsub_rn(uk, c0), den), 0.f), 1.f);
    float acc = __fadd_rn(s_P[b], __fmul_rn(seg, s_len[b]));
    if (bad > b) acc = __int_as_float(0x7fffffff);
    if (valid) t_new[(size_t)r * nf + k] = __fadd_rn(s_t[0], acc);
  }
}

int launch_weights_pdf(const void* t, const void* sdf, const void* mask, const void* near,
                       const void* far, const void* u, const void* noise, void* w, void* t_new,
                       int N, int S, int nf, float inv_s, cudaStream_t stream) {
  // a ray's depths, sdf, mask, alphas, lengths, weights, prefixes and cdf in
  // shared memory: past 48 KB a block, fewer warps a block, then one with the
  // opt-in limit
  const size_t row = (8 * (size_t)S + 1) * sizeof(float);
  int warps = 4;
  while (warps > 1 && warps * kUpsampleRowsPerWarp * row > 48 * 1024) --warps;
  const size_t smem = warps * kUpsampleRowsPerWarp * row;
  if (smem > 48 * 1024) {
    cudaError_t e;
    int dev = 0, optin = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
        cudaSuccess)
      return (int)e;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    if ((e = cudaFuncSetAttribute(weights_pdf_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return (int)e;
  }
  const int rays = warps * kUpsampleRowsPerWarp;
  weights_pdf_kernel<<<(N + rays - 1) / rays, 32 * warps, smem, stream>>>(
      (const float*)t, (const float*)sdf, (const uint8_t*)mask, (const float*)near,
      (const float*)far, (const float*)u, (const float*)noise, (float*)w, (float*)t_new, N, S,
      nf, inv_s);
  return (int)cudaGetLastError();
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
                                         const void* noise, void* w, void* t_new, int N, int S,
                                         int nf, float inv_s, void* stream) {
  if (S < 2 || nf < 1 || N < 0 || (u == nullptr) == (noise == nullptr))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return launch_weights_pdf(t, sdf, mask, near, far, u, noise, w, t_new, N, S, nf, inv_s, st);
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
