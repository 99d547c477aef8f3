// K4 and K10 occ_ray_proposal, K7 occ_ema_update: the EMA occupancy grids.
//
// Replaces:
//   K4  neuralsim_tpu/accel/occ_grid.py OccGridEma.ray_proposal (lines
//       158-203) with _occ_probe_f (lines 136-152) and ops/segment.py
//       sample_pdf (lines 229-276);
//   K10 OccGridEmaBatched.ray_proposal_batched (lines 247-268) and
//       OccGridEmaDynamic.ray_proposal_dynamic (lines 320-337): the same
//       march over one of G grids [G, R, R, R] per ray, chosen by an index
//       ``lead`` (the row's instance, or its time's keyframe); the probe reads
//       the flat cell lead * R^3 + cell, clipped to [0, G R^3 - 1] as
//       _occ_probe_f's take(mode="clip") does. K4 is the same device code with
//       no index (G = 1);
//   K7  neuralsim_tpu/accel/occ_grid.py OccGridEma.update (lines 99-118)
//       after the field evaluation, with _occ_from_raw (lines 75-93).
//
// K4, per ray: probe the boolean grid at the midpoints of M equal segments of
// [near, far]; weight an occupied segment 1 (every segment 1 where the ray
// touches nothing occupied: the uniform fallback), add 1e-6, and draw n
// stratified depths from the inverse CDF over the M+1 segment edges,
//   t(u) = e_0 + sum_i (e_{i+1}-e_i) * clip((u-cdf_i)/max(cdf_{i+1}-cdf_i,1e-12),0,1).
// The TPU form probes through a bf16 copy of the mask with one flat take and
// evaluates the inverse CDF as an [n, M] clip-sum. Here a ray has 16 or 32
// lanes (M <= 64: four segments a lane at most), each probing its segments'
// midpoints once. The proposal is discrete in the cell index, so the probe
// position is computed with the plain version's unfused operations in its
// order (o + t*d, (x - min) / (max - min), * R, truncation toward zero): a
// fused multiply-add would flip a cell on a last-bit difference. The running
// sum of the weights and the prefix P_i of the segment lengths go from the
// left in f32, once a ray, as the plain version's do: an empty segment weighs
// 1e-6 against 1, so nearly every bin is near-empty and the inverse CDF turns
// a last-bit cdf difference there into a depth shift. Then a lane a draw
// finds its bin b by binary search and returns e_0 + (P_b + seg_b len_b).
// See occ_ray_proposal_kernel for why that is the sequential clip-sum's
// value bit for bit. With noise the kernel forms the draws itself, so a call
// is one launch. What bounds it on an H100: neither bytes (32 B of ray data,
// 4 B of lead, M mask bytes, 4*n noise and 4*n output bytes per ray) nor
// operations; it is bound by instruction issue and latency: the probes'
// divides and gathers, the M-step walk, then the searches.
//
// K7, per voxel: raw field values of its S jittered samples -> occupancy
//   sdf:     4 s (1 - s), s = sigmoid(max(|raw| - voxel_half_diag, 0) * inv_s)
//   density: 1 - exp(-raw * dt)
// then max over the S samples, max(decay * old, new), the warm-up floor, and
// the threshold into the boolean mask. One thread per voxel, neighbouring
// threads on neighbouring voxels. What bounds it: bytes (4*S + 4 read, 4 + 1
// written per voxel: 27 MB at 128^3, S = 1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// max that keeps a NaN, as torch.maximum does
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

constexpr int kProposalRays = 16;  // rays a block
constexpr int kMaxSegments = 64;

// kRayLanes lanes a ray: 32 (a warp a ray) where the launch's rays fit the
// card's warps at once, else 16 (two rays a warp, which share each
// instruction of the cdf walk). The draws' bins, and why the result is the
// plain version's: the plain sum is acc = sum_i seg_i len_i from the left, with
//   seg_i = clip((u - c_i) / max(c_{i+1} - c_i, 1e-12), 0, 1)
// (clip by fmaxf/fminf: never NaN, so seg_i is in [0, 1]). Let b be the
// first segment whose seg_b < 1 (b = M where there is none). Then
//   - every i < b has seg_i = 1 exactly, and 1 * len_i = len_i, so the sum
//     up to b is the sequential prefix P_b = ((len_0 + len_1) + ...);
//   - every i > b has seg_i = +0: if the clamp did not bind at b, seg_b < 1
//     gives u < c_{b+1} (were u >= c_{b+1}, then u - c_b >= c_{b+1} - c_b by
//     the monotone rounding of a subtraction, and the quotient >= 1), so
//     u - c_i < 0 for i > b. The clamp binds only where c_{b+1} == c_b:
//     every weight is at least 1e-6 and total is at least 1, so a cdf step
//     that is not 0 is at least ~1.5e-8; a step is 0 once the running sum
//     passes 32, where an empty segment's 1e-6 is lost in f32, and there
//     c_b >= 0.5, so u - c_b is <= 0 or at least an ulp of 0.5 (6e-8): seg_b
//     < 1 means u <= c_b = c_{b+1} <= c_i. Adding +0 * len_i leaves the sum;
//   - so acc = P_b + seg_b len_b, the plain rounding of its last step.
// The same argument makes "seg_i < 1" monotone in i, so b is found by a
// binary search with the plain clip test itself, evaluated without its
// divide: with x = u - c_i and y = max(c_{i+1} - c_i, 1e-12) (both rounded;
// y a normal float > 0), the rounded x / y is >= 1 exactly where x >= y
// (x >= y gives a quotient >= 1; x < y gives x <= y (1 - 2^-24), the float
// below y, so the quotient rounds to at most 1 - 2^-24; a NaN x fails both
// tests and clips to 0). Finding b by u < c_{i+1} would not do: past a
// running sum of 32 an empty segment's c_{i+1} equals c_i, and the render's
// midpoints can land exactly on a cdf value. A non-finite length past b
// makes the plain sum NaN (0 * inf): the draw returns NaN then.
//
// Lane l of a ray owns segments l, l + kRayLanes, ...: it probes them and
// writes their weights and lengths to shared memory; an occupied segment
// weighs (1 + 0) + 1e-6 and an empty one (0 + 0) + 1e-6, or (0 + 1) + 1e-6
// on a ray with no occupied probe, the plain weights' roundings. Every lane
// walks the running sum and P from the left (lane 0 of the ray keeps them),
// the owners divide the sums by the total, and lane l takes draws l,
// l + kRayLanes, ...
template <int kRayLanes>
__global__ void __launch_bounds__(kProposalRays * kRayLanes)
occ_ray_proposal_kernel(const float* __restrict__ rays_o,   // [N, 3]
                        const float* __restrict__ rays_d,   // [N, 3]
                        const float* __restrict__ near,     // [N]
                        const float* __restrict__ far,      // [N]
                        const uint8_t* __restrict__ grid,   // [G, R, R, R] bool
                        const int32_t* __restrict__ lead,   // [N] or null (G = 1)
                        const float* __restrict__ aabb_min, // [3]
                        const float* __restrict__ aabb_max, // [3]
                        const float* __restrict__ lin,      // [M + 1] in [0, 1]
                        const float* __restrict__ u,        // [n] or null
                        const float* __restrict__ noise,    // [N, n] or null
                        float* __restrict__ t_out,          // [N, n]
                        int N, int G, int R, int M, int n) {
  // a ray's (weight, length) of each segment and (running sum, P) before it
  __shared__ float2 s_wl[kProposalRays][kMaxSegments];
  __shared__ float2 s_cP[kProposalRays][kMaxSegments + 1];
  constexpr int kRaysAWarp = 32 / kRayLanes;
  constexpr int kOwned = kMaxSegments / kRayLanes;  // segments a lane, at most
  const int lane = threadIdx.x & 31, gl = lane & (kRayLanes - 1);
  const int slot = threadIdx.x / kRayLanes;  // the ray's place in the block
  const int first_ray = blockIdx.x * kProposalRays;
  if (first_ray + (threadIdx.x >> 5) * kRaysAWarp >= N) return;  // the whole warp
  // a group past N walks the last ray again (the warp stays whole for its
  // shuffles) and writes nothing
  const bool valid = first_ray + slot < N;
  const int r = valid ? first_ray + slot : N - 1;
  float2* wl = s_wl[slot];
  float2* cP = s_cP[slot];
  const float nr = near[r];
  const float span = __fsub_rn(far[r], nr);
  auto edge = [&](int i) { return __fadd_rn(nr, __fmul_rn(span, __ldg(lin + i))); };

  float o[3], d[3], mn[3], ext[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[(size_t)r * 3 + a];
    d[a] = rays_d[(size_t)r * 3 + a];
    mn[a] = __ldg(aabb_min + a);
    ext[a] = __fsub_rn(__ldg(aabb_max + a), mn[a]);
  }
  const float Rf = (float)R;
  const long long R3 = (long long)R * R * R;
  const long long base = lead ? (long long)lead[r] * R3 : 0ll;
  const long long last = (long long)G * R3 - 1;

  // the probes: whether each owned segment's midpoint lies in an occupied
  // cell, and its length
  bool occ[kOwned];
  bool any = false;
  int bad = -1;  // the last segment whose length is not finite
#pragma unroll
  for (int j = 0; j < kOwned; ++j) {
    const int i = gl + j * kRayLanes;
    occ[j] = false;
    if (i < M) {
      const float e0 = edge(i), e1 = edge(i + 1);
      const float li = __fsub_rn(e1, e0);
      const float tm = __fmul_rn(0.5f, __fadd_rn(e1, e0));
      bool inside = true;
      int cell[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float x = __fadd_rn(o[a], __fmul_rn(tm, d[a]));
        const float x01 = __fdiv_rn(__fsub_rn(x, mn[a]), ext[a]);
        inside = inside && (x01 >= 0.f) && (x01 <= 1.f);
        const int c = (int)__fmul_rn(x01, Rf);
        cell[a] = min(max(c, 0), R - 1);
      }
      long long at = base + ((long long)cell[0] * R + cell[1]) * R + cell[2];
      at = at < 0 ? 0 : (at > last ? last : at);
      occ[j] = inside && grid[at] != 0;
      any = any || occ[j];
      wl[i].y = li;
      if (!(fabsf(li) <= 3.402823466e38f)) bad = i;  // inf or NaN
    }
  }
  const unsigned group = (kRayLanes == 32 ? 0xffffffffu : (1u << kRayLanes) - 1u)
                         << (lane & ~(kRayLanes - 1));
  const bool miss = (__ballot_sync(0xffffffffu, any) & group) == 0u;
#pragma unroll
  for (int m = kRayLanes / 2; m > 0; m >>= 1)
    bad = max(bad, __shfl_xor_sync(0xffffffffu, bad, m));
  // the weights: (occ + miss) + 1e-6, which takes two values
  const float w_full = __fadd_rn(1.f, 1e-6f);
#pragma unroll
  for (int j = 0; j < kOwned; ++j) {
    const int i = gl + j * kRayLanes;
    if (i < M) wl[i].x = occ[j] || miss ? w_full : 1e-6f;
  }
  __syncwarp();

  // the running sum of the weights and P, from the left, in every lane of
  // the ray; its lane 0 keeps (csum_i, P_i), the sums before segment i
  float csum = 0.f, P = 0.f;
  const bool keeper = gl == 0;
#pragma unroll 8
  for (int i = 0; i < M; ++i) {
    const float2 v = wl[i];
    if (keeper) cP[i] = make_float2(csum, P);
    csum = __fadd_rn(csum, v.x);
    P = __fadd_rn(P, v.y);
  }
  const float total = csum;
  if (keeper) cP[M] = make_float2(total, P);
  __syncwarp();
  // c_i = csum_i / total (c_0 = 0 stays)
  for (int i = gl + 1; i <= M; i += kRayLanes) cP[i].x = __fdiv_rn(cP[i].x, total);
  __syncwarp();

  const float first = edge(0);
  const float inv_n = __frcp_rn((float)n);
  for (int k = gl; k < n; k += kRayLanes) {
    // the draws as PyTorch forms (arange(n) + noise) / n on the card: a
    // product with the reciprocal of the scalar divisor
    const float uk = noise != nullptr
                         ? __fmul_rn(__fadd_rn((float)k, noise[(size_t)r * n + k]), inv_n)
                         : u[k];
    int b = 0, cnt = M;  // b: the number of leading segments with seg == 1
    while (cnt > 0) {
      const int h = cnt >> 1;
      const float c0 = cP[b + h].x;
      if (__fsub_rn(uk, c0) >= fmaxf(__fsub_rn(cP[b + h + 1].x, c0), 1e-12f)) {
        b += h + 1;
        cnt -= h + 1;
      } else {
        cnt = h;
      }
    }
    float acc = cP[b].y;
    if (b < M) {
      const float c0 = cP[b].x;
      const float den = fmaxf(__fsub_rn(cP[b + 1].x, c0), 1e-12f);
      const float seg = fminf(fmaxf(__fdiv_rn(__fsub_rn(uk, c0), den), 0.f), 1.f);
      acc = __fadd_rn(acc, __fmul_rn(seg, wl[b].y));
    }
    if (bad > b) acc = __int_as_float(0x7fffffff);
    if (valid) t_out[(size_t)r * n + k] = __fadd_rn(first, acc);
  }
}

// One thread per voxel. mode 0: sdf (p = voxel half diagonal), 1: density
// (p = dt). warm_floor: the warm-up floor, or -inf outside the warm-up.
__global__ void occ_ema_update_kernel(const float* __restrict__ raw,   // [S, V]
                                      const float* __restrict__ val,   // [V]
                                      float* __restrict__ new_val,     // [V]
                                      uint8_t* __restrict__ mask,      // [V] bool
                                      int V, int S, int mode, float p, float inv_s,
                                      float decay, float thre, float warm_floor) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  float m = 0.f;
  for (int s = 0; s < S; ++s) {
    const float r = raw[(size_t)s * V + i];
    float o;
    if (mode == 0) {
      const float sd = nan_max(__fsub_rn(fabsf(r), p), 0.f);
      const float sx = sigmoid(__fmul_rn(sd, inv_s));
      o = __fmul_rn(__fmul_rn(4.f, sx), __fsub_rn(1.f, sx));
    } else {
      o = __fsub_rn(1.f, expf(-__fmul_rn(r, p)));
    }
    m = s == 0 ? o : nan_max(m, o);
  }
  float v = nan_max(__fmul_rn(val[i], decay), m);
  v = nan_max(v, warm_floor);
  new_val[i] = v;
  mask[i] = v > thre ? 1 : 0;
}

}  // namespace

// lead: null for one grid (K4), else an int32 grid index per ray (K10); u:
// the draws [n] (the midpoints), or null with noise [N, n] (stratified
// draws formed in the kernel): exactly one of the two.
extern "C" int occ_ray_proposal(const void* rays_o, const void* rays_d, const void* near,
                                const void* far, const void* grid, const void* lead,
                                const void* aabb_min, const void* aabb_max, const void* lin,
                                const void* u, const void* noise, void* t_out, int N, int G,
                                int R, int M, int n, void* stream) {
  if (M < 1 || M > kMaxSegments || n < 1 || R < 1 || G < 1 || N < 0 ||
      (u == nullptr) == (noise == nullptr))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int blocks = (N + kProposalRays - 1) / kProposalRays;
  // a warp a ray up to 32 warps an SM, else two rays a warp: past that the
  // rays take a second wave, and sharing the walk's instructions pays
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  auto launch = [&](auto kernel, int lanes) {
    kernel<<<blocks, kProposalRays * lanes, 0, (cudaStream_t)stream>>>(
        (const float*)rays_o, (const float*)rays_d, (const float*)near, (const float*)far,
        (const uint8_t*)grid, (const int32_t*)lead, (const float*)aabb_min,
        (const float*)aabb_max, (const float*)lin, (const float*)u, (const float*)noise,
        (float*)t_out, N, G, R, M, n);
  };
  if (N <= 32 * sms)
    launch(occ_ray_proposal_kernel<32>, 32);
  else
    launch(occ_ray_proposal_kernel<16>, 16);
  return (int)cudaGetLastError();
}

extern "C" int occ_ema_update(const void* raw, const void* val, void* new_val, void* mask,
                              int V, int S, int mode, float p, float inv_s, float decay,
                              float thre, float warm_floor, void* stream) {
  if (S < 1 || mode < 0 || mode > 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = V > 0 ? (V + threads - 1) / threads : 1;
  occ_ema_update_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)raw, (const float*)val, (float*)new_val, (uint8_t*)mask, V, S, mode, p,
      inv_s, decay, thre, warm_floor);
  return (int)cudaGetLastError();
}
