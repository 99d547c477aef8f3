// K6 volume_composite: alpha -> transmittance -> volume integration, forward
// and backward.
//
// Replaces: neuralsim_tpu/ops/segment.py alpha_to_vw (lines 43-54) with
//   exclusive_cumprod (lines 30-40), and neuralsim_tpu/renderers/buffers.py
//   volume_integrate (lines 21-52) on a single sorted buffer.
//
// Per ray, one sequential pass over its S samples:
//   a_i  = mask_i ? alpha_i : 0
//   vw_i = a_i * prod_{j<i} (1 - a_j + 1e-10)                (written out)
//   mask_volume = sum vw,  depth_volume = sum vw*t / max(sum vw, 1e-8),
//   rgb_volume = sum vw*rgb,  normals_volume = sum vw*nablas (not normalised),
//   samples_cnt = sum mask                                    (sums over masked lanes)
// rgb and nablas may be null, and then their outputs are not written.
//
// What bounds it on an H100: bytes. Per sample it reads 33 bytes (t, mask,
// alpha, rgb, nablas) and writes 4 (vw); the arithmetic is ~20 flops. The
// transmittance is a sequential product, so one thread owns one ray and keeps
// every running sum in registers; the per-ray rows are read by one thread
// each, which relies on L1 to merge the strided reads (a warp-per-ray layout
// with a shuffle scan is the faster form, left for later).
//
// Backward (volume_composite_bwd): cotangents of vw [N, S], mask_volume,
// depth_volume [N], rgb_volume, normals_volume [N, 3] -> d alpha [N, S],
// d rgb, d nablas [N, S, 3]. With q_i = 1 - a_i + 1e-10, T_i = prod_{j<i} q_j,
// v_i = a_i T_i, and g_i the whole cotangent reaching v_i
//   g_i = g_vw_i + mask_i * (g_mask + g_depth * (t_i - [vsum >= 1e-8] * depth) / den
//                            + g_rgb . rgb_i + g_nrm . nablas_i),  den = max(vsum, 1e-8)
// the product rule gives d a_i = T_i * (g_i - B_i), where
//   B_i = sum_{k>i} g_k a_k prod_{i<j<k} q_j,  so  B_{i-1} = g_i a_i + q_i B_i.
// That form divides by nothing, so a lane with alpha == 1 (q = 1e-10) stays
// exact where "suffix sum over q_i" would divide by 1e-10. One thread per ray
// sweeps forward once, leaving T_i in the d_alpha row (its own scratch) and
// summing vsum and dsum as the forward does, then walks backward. Masked lanes
// get zero. No gradient goes to t. What bounds it: bytes (37 read and 28
// written per sample).
//
// K12 neus_composite (forward and backward): the NeuS alpha of the final
// evaluation fused into the same per-ray pass, for a NeuS buffer that is
// composited alone (the multi-object LiDAR step's street; a close-range
// field without a distant one).
//
// Replaces: neuralsim_tpu/fields/neus.py neus_alpha_from_sdf (lines 63-77)
//   with the cos anneal and the mask of NeuSField.ray_query (lines 529-543),
//   then K6's composite. Per lane, with d the ray's direction and an the
//   cos anneal:
//   tc   = d . nablas_i
//   cos  = -(relu(0.5 - 0.5 tc) (1 - an) + relu(-tc) an)
//   dt   = t_{i+1} - t_i (1e-3 on the last lane)
//   P, Q = sigmoid((sdf_i -+ cos dt / 2) inv_s)
//   a_i  = mask_i ? clip((P - Q + 1e-5) / (P + 1e-5), 0, 1) : 0   (written out)
// and K6's sums over a_i. inv_s is read from device memory (no host sync).
// The backward takes the cotangents of every output (any may be null: zero),
// gets d a_i as K6's backward does (plus the alpha output's own cotangent),
// and carries it back through the clip (half the gradient at a tie a == 0
// or 1, as jnp.clip; nothing outside [0, 1]), the quotient, the sigmoids and
// the anneal (relu's gradient 0 at 0) into d sdf, d nablas (the normals sum
// and the cos), d rgb, and each ray's share of d inv_s (the caller sums the
// rays: deterministic, no float atomics). No gradient goes to t or d. What
// bounds it on an H100: bytes, as K6 (the forward reads 33 bytes a lane and
// writes 8; the backward reads 41 and writes 20), with ~40 (forward) and
// ~90 (backward) flops a lane; one thread owns one ray.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void composite_kernel(const float* __restrict__ t,        // [N, S]
                                 const uint8_t* __restrict__ mask,   // [N, S]
                                 const float* __restrict__ alpha,    // [N, S]
                                 const float* __restrict__ rgb,      // [N, S, 3] or null
                                 const float* __restrict__ nablas,   // [N, S, 3] or null
                                 float* __restrict__ vw,             // [N, S]
                                 float* __restrict__ mask_volume,    // [N]
                                 float* __restrict__ depth_volume,   // [N]
                                 float* __restrict__ rgb_volume,     // [N, 3]
                                 float* __restrict__ normals_volume, // [N, 3]
                                 int* __restrict__ samples_cnt,      // [N]
                                 int N, int S) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const size_t o = (size_t)r * S;
  float trans = 1.f, vsum = 0.f, dsum = 0.f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f;
  int cnt = 0;
  for (int i = 0; i < S; ++i) {
    const bool m = mask[o + i] != 0;
    const float a = m ? alpha[o + i] : 0.f;
    const float v = __fmul_rn(a, trans);
    trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, a), 1e-10f));
    vw[o + i] = v;
    if (!m) continue;
    ++cnt;
    vsum = __fadd_rn(vsum, v);
    dsum = __fadd_rn(dsum, __fmul_rn(v, t[o + i]));
    if (rgb != nullptr) {
      const float* c = rgb + (o + i) * 3;
      c0 = __fadd_rn(c0, __fmul_rn(v, c[0]));
      c1 = __fadd_rn(c1, __fmul_rn(v, c[1]));
      c2 = __fadd_rn(c2, __fmul_rn(v, c[2]));
    }
    if (nablas != nullptr) {
      const float* g = nablas + (o + i) * 3;
      n0 = __fadd_rn(n0, __fmul_rn(v, g[0]));
      n1 = __fadd_rn(n1, __fmul_rn(v, g[1]));
      n2 = __fadd_rn(n2, __fmul_rn(v, g[2]));
    }
  }
  mask_volume[r] = vsum;
  depth_volume[r] = __fdiv_rn(dsum, fmaxf(vsum, 1e-8f));
  samples_cnt[r] = cnt;
  if (rgb != nullptr) {
    rgb_volume[r * 3 + 0] = c0;
    rgb_volume[r * 3 + 1] = c1;
    rgb_volume[r * 3 + 2] = c2;
  }
  if (nablas != nullptr) {
    normals_volume[r * 3 + 0] = n0;
    normals_volume[r * 3 + 1] = n1;
    normals_volume[r * 3 + 2] = n2;
  }
}

__global__ void composite_bwd_kernel(const float* __restrict__ t,        // [N, S]
                                     const uint8_t* __restrict__ mask,   // [N, S]
                                     const float* __restrict__ alpha,    // [N, S]
                                     const float* __restrict__ rgb,      // [N, S, 3] or null
                                     const float* __restrict__ nablas,   // [N, S, 3] or null
                                     const float* __restrict__ g_vw,     // [N, S]
                                     const float* __restrict__ g_mask,   // [N]
                                     const float* __restrict__ g_depth,  // [N]
                                     const float* __restrict__ g_rgb,    // [N, 3] or null
                                     const float* __restrict__ g_nrm,    // [N, 3] or null
                                     float* __restrict__ d_alpha,        // [N, S]
                                     float* __restrict__ d_rgb,          // [N, S, 3] or null
                                     float* __restrict__ d_nablas,       // [N, S, 3] or null
                                     int N, int S) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const size_t o = (size_t)r * S;
  float trans = 1.f, vsum = 0.f, dsum = 0.f;
  for (int i = 0; i < S; ++i) {
    const bool m = mask[o + i] != 0;
    const float a = m ? alpha[o + i] : 0.f;
    const float v = __fmul_rn(a, trans);
    d_alpha[o + i] = trans;
    trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, a), 1e-10f));
    if (!m) continue;
    vsum = __fadd_rn(vsum, v);
    dsum = __fadd_rn(dsum, __fmul_rn(v, t[o + i]));
  }
  const float den = fmaxf(vsum, 1e-8f);
  const float gm = g_mask[r];
  const float gd = g_depth[r] / den;
  const float depth = vsum >= 1e-8f ? dsum / den : 0.f;
  float gc[3] = {0.f, 0.f, 0.f}, gn[3] = {0.f, 0.f, 0.f};
  if (rgb != nullptr)
    for (int k = 0; k < 3; ++k) gc[k] = g_rgb[r * 3 + k];
  if (nablas != nullptr)
    for (int k = 0; k < 3; ++k) gn[k] = g_nrm[r * 3 + k];
  float B = 0.f;
  for (int i = S - 1; i >= 0; --i) {
    const bool m = mask[o + i] != 0;
    const float T = d_alpha[o + i];
    if (!m) {  // a = 0 and q = 1 + 1e-10, which is 1 in f32: B passes through
      d_alpha[o + i] = 0.f;
      if (rgb != nullptr)
        for (int k = 0; k < 3; ++k) d_rgb[(o + i) * 3 + k] = 0.f;
      if (nablas != nullptr)
        for (int k = 0; k < 3; ++k) d_nablas[(o + i) * 3 + k] = 0.f;
      continue;
    }
    const float a = alpha[o + i];
    const float v = a * T;
    float g = g_vw[o + i] + gm + gd * (t[o + i] - depth);
    if (rgb != nullptr) {
      const float* c = rgb + (o + i) * 3;
      g += gc[0] * c[0] + gc[1] * c[1] + gc[2] * c[2];
      for (int k = 0; k < 3; ++k) d_rgb[(o + i) * 3 + k] = v * gc[k];
    }
    if (nablas != nullptr) {
      const float* c = nablas + (o + i) * 3;
      g += gn[0] * c[0] + gn[1] * c[1] + gn[2] * c[2];
      for (int k = 0; k < 3; ++k) d_nablas[(o + i) * 3 + k] = v * gn[k];
    }
    d_alpha[o + i] = T * (g - B);
    B = g * a + __fadd_rn(__fsub_rn(1.f, a), 1e-10f) * B;
  }
}


// One lane of a NeuS buffer: the alpha and what its backward needs.
struct NeuSLane {
  float tc, y1, dt, ep, en, P, Q, num, den, raw, a;
};

__device__ __forceinline__ void neus_lane(const float* __restrict__ t,
                                          const float* __restrict__ sdf,
                                          const float* __restrict__ nablas, const float d[3],
                                          size_t o, int i, int S, float an, float inv_s,
                                          NeuSLane& L) {
  const float* g = nablas + (o + i) * 3;
  L.tc = __fadd_rn(__fadd_rn(__fmul_rn(d[0], g[0]), __fmul_rn(d[1], g[1])),
                   __fmul_rn(d[2], g[2]));
  L.y1 = __fadd_rn(__fmul_rn(-L.tc, 0.5f), 0.5f);
  const float cos = -__fadd_rn(__fmul_rn(fmaxf(L.y1, 0.f), __fsub_rn(1.f, an)),
                               __fmul_rn(fmaxf(-L.tc, 0.f), an));
  L.dt = i + 1 < S ? __fsub_rn(t[o + i + 1], t[o + i]) : 1e-3f;
  const float half = __fmul_rn(__fmul_rn(cos, L.dt), 0.5f);
  const float s = sdf[o + i];
  L.ep = __fsub_rn(s, half);
  L.en = __fadd_rn(s, half);
  L.P = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(L.ep, inv_s))));
  L.Q = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(L.en, inv_s))));
  L.num = __fadd_rn(__fsub_rn(L.P, L.Q), 1e-5f);
  L.den = __fadd_rn(L.P, 1e-5f);
  L.raw = __fdiv_rn(L.num, L.den);
  L.a = L.raw < 0.f ? 0.f : (L.raw > 1.f ? 1.f : L.raw);  // a NaN stays NaN
}

__global__ void neus_composite_kernel(const float* __restrict__ t,        // [N, S]
                                      const uint8_t* __restrict__ mask,   // [N, S]
                                      const float* __restrict__ sdf,      // [N, S]
                                      const float* __restrict__ nablas,   // [N, S, 3]
                                      const float* __restrict__ rays_d,   // [N, 3]
                                      const float* __restrict__ inv_s_p,  // []
                                      const float* __restrict__ rgb,      // [N, S, 3] or null
                                      float* __restrict__ vw,             // [N, S]
                                      float* __restrict__ mask_volume,    // [N]
                                      float* __restrict__ depth_volume,   // [N]
                                      float* __restrict__ rgb_volume,     // [N, 3] or null
                                      float* __restrict__ normals_volume, // [N, 3]
                                      int* __restrict__ samples_cnt,      // [N]
                                      float* __restrict__ alpha,          // [N, S]
                                      int N, int S, float an) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const size_t o = (size_t)r * S;
  const float inv_s = __ldg(inv_s_p);
  const float d[3] = {rays_d[r * 3 + 0], rays_d[r * 3 + 1], rays_d[r * 3 + 2]};
  float trans = 1.f, vsum = 0.f, dsum = 0.f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f;
  int cnt = 0;
  NeuSLane L;
  for (int i = 0; i < S; ++i) {
    const bool m = mask[o + i] != 0;
    float a = 0.f;
    if (m) {
      neus_lane(t, sdf, nablas, d, o, i, S, an, inv_s, L);
      a = L.a;
    }
    alpha[o + i] = a;
    const float v = __fmul_rn(a, trans);
    trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, a), 1e-10f));
    vw[o + i] = v;
    if (!m) continue;
    ++cnt;
    vsum = __fadd_rn(vsum, v);
    dsum = __fadd_rn(dsum, __fmul_rn(v, t[o + i]));
    if (rgb != nullptr) {
      const float* c = rgb + (o + i) * 3;
      c0 = __fadd_rn(c0, __fmul_rn(v, c[0]));
      c1 = __fadd_rn(c1, __fmul_rn(v, c[1]));
      c2 = __fadd_rn(c2, __fmul_rn(v, c[2]));
    }
    const float* g = nablas + (o + i) * 3;
    n0 = __fadd_rn(n0, __fmul_rn(v, g[0]));
    n1 = __fadd_rn(n1, __fmul_rn(v, g[1]));
    n2 = __fadd_rn(n2, __fmul_rn(v, g[2]));
  }
  mask_volume[r] = vsum;
  depth_volume[r] = __fdiv_rn(dsum, fmaxf(vsum, 1e-8f));
  samples_cnt[r] = cnt;
  if (rgb != nullptr) {
    rgb_volume[r * 3 + 0] = c0;
    rgb_volume[r * 3 + 1] = c1;
    rgb_volume[r * 3 + 2] = c2;
  }
  normals_volume[r * 3 + 0] = n0;
  normals_volume[r * 3 + 1] = n1;
  normals_volume[r * 3 + 2] = n2;
}

__global__ void neus_composite_bwd_kernel(const float* __restrict__ t,        // [N, S]
                                          const uint8_t* __restrict__ mask,   // [N, S]
                                          const float* __restrict__ sdf,      // [N, S]
                                          const float* __restrict__ nablas,   // [N, S, 3]
                                          const float* __restrict__ rays_d,   // [N, 3]
                                          const float* __restrict__ inv_s_p,  // []
                                          const float* __restrict__ rgb,      // [N, S, 3] or null
                                          const float* __restrict__ g_vw,     // [N, S] or null
                                          const float* __restrict__ g_mask,   // [N] or null
                                          const float* __restrict__ g_depth,  // [N] or null
                                          const float* __restrict__ g_rgb,    // [N, 3] or null
                                          const float* __restrict__ g_nrm,    // [N, 3] or null
                                          const float* __restrict__ g_alpha,  // [N, S] or null
                                          float* __restrict__ d_sdf,          // [N, S]
                                          float* __restrict__ d_nablas,       // [N, S, 3]
                                          float* __restrict__ d_rgb,          // [N, S, 3] or null
                                          float* __restrict__ d_inv_s,        // [N]
                                          int N, int S, float an) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const size_t o = (size_t)r * S;
  const float inv_s = __ldg(inv_s_p);
  const float d[3] = {rays_d[r * 3 + 0], rays_d[r * 3 + 1], rays_d[r * 3 + 2]};
  NeuSLane L;
  // forward sweep: T_i into the d_sdf row (its own scratch), the sums as K6
  float trans = 1.f, vsum = 0.f, dsum = 0.f;
  for (int i = 0; i < S; ++i) {
    const bool m = mask[o + i] != 0;
    float a = 0.f;
    if (m) {
      neus_lane(t, sdf, nablas, d, o, i, S, an, inv_s, L);
      a = L.a;
    }
    const float v = __fmul_rn(a, trans);
    d_sdf[o + i] = trans;
    trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, a), 1e-10f));
    if (!m) continue;
    vsum = __fadd_rn(vsum, v);
    dsum = __fadd_rn(dsum, __fmul_rn(v, t[o + i]));
  }
  const float den = fmaxf(vsum, 1e-8f);
  const float gm = g_mask != nullptr ? g_mask[r] : 0.f;
  const float gd = g_depth != nullptr ? g_depth[r] / den : 0.f;
  const float depth = vsum >= 1e-8f ? dsum / den : 0.f;
  float gc[3] = {0.f, 0.f, 0.f}, gn[3] = {0.f, 0.f, 0.f};
  if (rgb != nullptr && g_rgb != nullptr)
    for (int k = 0; k < 3; ++k) gc[k] = g_rgb[r * 3 + k];
  if (g_nrm != nullptr)
    for (int k = 0; k < 3; ++k) gn[k] = g_nrm[r * 3 + k];
  float B = 0.f, dinv = 0.f;
  for (int i = S - 1; i >= 0; --i) {
    const bool m = mask[o + i] != 0;
    const float T = d_sdf[o + i];
    if (!m) {  // a = 0 and q = 1 + 1e-10, which is 1 in f32: B passes through
      d_sdf[o + i] = 0.f;
      for (int k = 0; k < 3; ++k) d_nablas[(o + i) * 3 + k] = 0.f;
      if (rgb != nullptr)
        for (int k = 0; k < 3; ++k) d_rgb[(o + i) * 3 + k] = 0.f;
      continue;
    }
    neus_lane(t, sdf, nablas, d, o, i, S, an, inv_s, L);
    const float a = L.a;
    const float v = a * T;
    const float* nb = nablas + (o + i) * 3;
    float g = (g_vw != nullptr ? g_vw[o + i] : 0.f) + gm + gd * (t[o + i] - depth)
              + gn[0] * nb[0] + gn[1] * nb[1] + gn[2] * nb[2];
    if (rgb != nullptr) {
      const float* c = rgb + (o + i) * 3;
      g += gc[0] * c[0] + gc[1] * c[1] + gc[2] * c[2];
      for (int k = 0; k < 3; ++k) d_rgb[(o + i) * 3 + k] = v * gc[k];
    }
    float da = T * (g - B) + (g_alpha != nullptr ? g_alpha[o + i] : 0.f);
    B = g * a + __fadd_rn(__fsub_rn(1.f, a), 1e-10f) * B;
    // the clip: the whole gradient inside (0, 1), half at a tie, none outside
    const float raw = L.raw;
    da *= (raw > 0.f && raw < 1.f) ? 1.f : ((raw == 0.f || raw == 1.f) ? 0.5f : 0.f);
    // raw = num / den, num = P - Q + eps, den = P + eps
    const float dnum = da / L.den;
    const float dden = -da * L.num / (L.den * L.den);
    const float du = (dnum + dden) * L.P * (1.f - L.P);   // through P = sigmoid(u)
    const float dv = -dnum * L.Q * (1.f - L.Q);           // through Q = sigmoid(v)
    const float dep = du * inv_s, den_ = dv * inv_s;
    dinv += du * L.ep + dv * L.en;
    d_sdf[o + i] = dep + den_;
    // ep = sdf - cos dt / 2, en = sdf + cos dt / 2; cos from tc through the anneal
    const float dcos = (den_ - dep) * 0.5f * L.dt;
    const float dtc = dcos * ((L.y1 > 0.f ? 0.5f * (1.f - an) : 0.f)
                              + (-L.tc > 0.f ? an : 0.f));
    for (int k = 0; k < 3; ++k) d_nablas[(o + i) * 3 + k] = v * gn[k] + dtc * d[k];
  }
  d_inv_s[r] = dinv;
}

}  // namespace

extern "C" int volume_composite_fwd(const void* t, const void* mask, const void* alpha,
                                    const void* rgb, const void* nablas, void* vw,
                                    void* mask_volume, void* depth_volume, void* rgb_volume,
                                    void* normals_volume, void* samples_cnt, int N, int S,
                                    void* stream) {
  const int threads = 32;  // one warp a block: 4096 rays spread over 128 SMs
  const int blocks = N > 0 ? (N + threads - 1) / threads : 1;
  composite_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const uint8_t*)mask, (const float*)alpha, (const float*)rgb,
      (const float*)nablas, (float*)vw, (float*)mask_volume, (float*)depth_volume,
      (float*)rgb_volume, (float*)normals_volume, (int*)samples_cnt, N, S);
  return (int)cudaGetLastError();
}

extern "C" int volume_composite_bwd(const void* t, const void* mask, const void* alpha,
                                    const void* rgb, const void* nablas, const void* g_vw,
                                    const void* g_mask, const void* g_depth, const void* g_rgb,
                                    const void* g_nrm, void* d_alpha, void* d_rgb,
                                    void* d_nablas, int N, int S, void* stream) {
  const int threads = 32;
  const int blocks = N > 0 ? (N + threads - 1) / threads : 1;
  composite_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const uint8_t*)mask, (const float*)alpha, (const float*)rgb,
      (const float*)nablas, (const float*)g_vw, (const float*)g_mask, (const float*)g_depth,
      (const float*)g_rgb, (const float*)g_nrm, (float*)d_alpha, (float*)d_rgb,
      (float*)d_nablas, N, S);
  return (int)cudaGetLastError();
}

extern "C" int neus_composite_fwd(const void* t, const void* mask, const void* sdf,
                                  const void* nablas, const void* rays_d, const void* inv_s,
                                  const void* rgb, void* vw, void* mask_volume,
                                  void* depth_volume, void* rgb_volume, void* normals_volume,
                                  void* samples_cnt, void* alpha, int N, int S, float anneal,
                                  void* stream) {
  const int threads = 32;
  const int blocks = N > 0 ? (N + threads - 1) / threads : 1;
  neus_composite_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const uint8_t*)mask, (const float*)sdf, (const float*)nablas,
      (const float*)rays_d, (const float*)inv_s, (const float*)rgb, (float*)vw,
      (float*)mask_volume, (float*)depth_volume, (float*)rgb_volume, (float*)normals_volume,
      (int*)samples_cnt, (float*)alpha, N, S, anneal);
  return (int)cudaGetLastError();
}

extern "C" int neus_composite_bwd(const void* t, const void* mask, const void* sdf,
                                  const void* nablas, const void* rays_d, const void* inv_s,
                                  const void* rgb, const void* g_vw, const void* g_mask,
                                  const void* g_depth, const void* g_rgb, const void* g_nrm,
                                  const void* g_alpha, void* d_sdf, void* d_nablas, void* d_rgb,
                                  void* d_inv_s, int N, int S, float anneal, void* stream) {
  const int threads = 32;
  const int blocks = N > 0 ? (N + threads - 1) / threads : 1;
  neus_composite_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const uint8_t*)mask, (const float*)sdf, (const float*)nablas,
      (const float*)rays_d, (const float*)inv_s, (const float*)rgb, (const float*)g_vw,
      (const float*)g_mask, (const float*)g_depth, (const float*)g_rgb, (const float*)g_nrm,
      (const float*)g_alpha, (float*)d_sdf, (float*)d_nablas, (float*)d_rgb, (float*)d_inv_s,
      N, S, anneal);
  return (int)cudaGetLastError();
}
