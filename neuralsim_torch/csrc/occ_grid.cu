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
// evaluates the inverse CDF as an [n, M] clip-sum; here every (ray, draw) pair
// has a thread that reads the M mask bytes directly (the n threads of a ray
// read the same bytes, so the loads are broadcasts out of L1), keeps the
// occupancy of the M segments as one 64-bit word in a register, and walks the
// cdf once. The proposal is discrete in the cell index, so the probe position
// is computed with the plain version's unfused operations in its order
// (o + t*d, (x - min) / (max - min), * R, truncation toward zero): a fused
// multiply-add would flip a cell on a last-bit difference. The running sum of
// the weights goes from the left in f32, as the plain version's does: an
// empty segment weighs 1e-6 against 1, so nearly every bin is near-empty and
// the inverse CDF turns a last-bit cdf difference there into a depth shift.
// What bounds it on an H100: neither bytes (32 B of ray data, 4 B of lead, M
// mask bytes, 4*n noise and 4*n output bytes per ray) nor operations; it is bound by
// launch latency and the two sequential passes over the M segments, hence one
// thread per draw instead of one per ray (16 times the threads in flight).
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

// One thread per (ray, draw k).
__global__ void occ_ray_proposal_kernel(const float* __restrict__ rays_o,   // [N, 3]
                                        const float* __restrict__ rays_d,   // [N, 3]
                                        const float* __restrict__ near,     // [N]
                                        const float* __restrict__ far,      // [N]
                                        const uint8_t* __restrict__ grid,   // [G, R, R, R] bool
                                        const int32_t* __restrict__ lead,   // [N] or null (G = 1)
                                        const float* __restrict__ aabb_min, // [3]
                                        const float* __restrict__ aabb_max, // [3]
                                        const float* __restrict__ lin,      // [M + 1] in [0, 1]
                                        const float* __restrict__ u,        // [n] or [N, n]
                                        float* __restrict__ t_out,          // [N, n]
                                        int N, int G, int R, int M, int n, int u_stride) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int r = (int)(g / n), k = (int)(g - (long long)r * n);
  if (r >= N) return;
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

  // probes: bit i of occ says that segment i's midpoint lies in an occupied cell
  unsigned long long occ = 0ull;
  float e0 = edge(0);
  for (int i = 0; i < M; ++i) {
    const float e1 = edge(i + 1);
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
    if (inside && grid[at]) occ |= 1ull << i;
    e0 = e1;
  }
  const float miss = occ == 0ull ? 1.f : 0.f;   // no occupied probe: uniform weights
  auto weight = [&](int i) {
    return __fadd_rn(__fadd_rn((occ >> i) & 1ull ? 1.f : 0.f, miss), 1e-6f);
  };

  float total = 0.f;
  for (int i = 0; i < M; ++i) total = __fadd_rn(total, weight(i));

  const float uk = u[(size_t)r * u_stride + k];
  float acc = 0.f, csum = 0.f, c0 = 0.f;
  const float first = edge(0);
  e0 = first;
  for (int i = 0; i < M; ++i) {
    const float e1 = edge(i + 1);
    csum = __fadd_rn(csum, weight(i));
    const float c1 = __fdiv_rn(csum, total);
    const float den = fmaxf(__fsub_rn(c1, c0), 1e-12f);
    const float seg = fminf(fmaxf(__fdiv_rn(__fsub_rn(uk, c0), den), 0.f), 1.f);
    acc = __fadd_rn(acc, __fmul_rn(seg, __fsub_rn(e1, e0)));
    c0 = c1;
    e0 = e1;
  }
  t_out[(size_t)r * n + k] = __fadd_rn(first, acc);
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

// lead: null for one grid (K4), else an int32 grid index per ray (K10).
extern "C" int occ_ray_proposal(const void* rays_o, const void* rays_d, const void* near,
                                const void* far, const void* grid, const void* lead,
                                const void* aabb_min, const void* aabb_max, const void* lin,
                                const void* u, void* t_out, int N, int G, int R, int M, int n,
                                int u_stride, void* stream) {
  if (M < 1 || M > 64 || n < 1 || R < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long long work = (long long)N * n;
  const int blocks = work > 0 ? (int)((work + threads - 1) / threads) : 1;
  occ_ray_proposal_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)near, (const float*)far,
      (const uint8_t*)grid, (const int32_t*)lead, (const float*)aabb_min,
      (const float*)aabb_max, (const float*)lin, (const float*)u, (float*)t_out, N, G, R, M, n,
      u_stride);
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
