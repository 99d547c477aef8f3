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
//       around the field evaluation: the voxel points (lines 106-111; the
//       batched and dynamic updates' lines 224-227 and 295-298) in
//       occ_voxel_points, then _occ_from_raw (lines 75-93), the EMA, the
//       warm-up floor, the threshold and the occupied count in
//       occ_ema_update. The count replaces occupied_fraction's
//       mean(mask.astype(float32)) (lines 154-155).
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
// K7's points, per voxel and sample: ((f32(i) + u) * fl(1 / R)) * (max - min)
// + min along each axis, each step rounded alone as the card's plain version
// rounds it (PyTorch divides a float tensor by a Python scalar as a product
// with its float reciprocal; no FMA contraction). The output keeps the
// jitter's flat [L R^3 x 3] order, so a thread takes four consecutive floats
// of it (a float4 in, a float4 out, neighbouring threads on neighbouring
// bytes) and walks the voxel index and the axis from its first float. What
// bounds it: bytes (12 read and 12 written a point: 201 MB for the street's
// 128^3 x 4 samples, 0.060 ms at 3.35 TB/s); the plain version takes about
// seven launches over the points. For the per-instance and per-keyframe
// grids the same launch writes each point's lead, in place of the plain
// version's repeat_interleave: the instance index l (int64, as torch.arange
// gives it and the latent lookup reads it) or the keyframe's time
// (l + 0.5) * fl(1 / L), as the card rounds (arange + 0.5) / L.
//
// K7, per voxel: raw field values of its S jittered samples -> occupancy
//   sdf:     4 s (1 - s), s = sigmoid(max(|raw| - voxel_half_diag, 0) * inv_s)
//   density: 1 - exp(-raw * dt)
// then max over the S samples, max(decay * old, new), the warm-up floor, and
// the threshold into the boolean mask, with the earlier kernel's arithmetic
// (so its bits). Four voxels a thread: a float4 of each sample's row of raw,
// a float4 of the old values and of the new, the four mask bytes in one
// 32-bit store; S unrolled for 1 and 4. The blocks stride over the grid, at
// most four an SM, so a thread keeps its count in a register across its
// quads. The same launch counts the occupied voxels: a warp's by
// __reduce_add_sync, a block's in shared memory, the blocks' by one 64-bit
// atomic add a block that adds the block's count to the high word and 1 to
// the low word, its ticket (exact in any order, and no fence: the block that
// draws the last ticket reads the total from what its own atomic returns).
// That block resets the word and writes the count and the fraction
// count * fl(1 / V): how the card's mean(mask.float()) rounds it (a sum of
// 0s and 1s is exact up to 2^24, then one product with the float
// reciprocal). What bounds it: bytes (4 S + 4
// read, 4 + 1 written a voxel: 27 MB at 128^3 and S 1, 0.0081 ms; 52 MB at
// S 4, 0.0157 ms).
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

// One sample's occupancy. mode 0: sdf (p = voxel half diagonal), 1: density
// (p = dt).
__device__ __forceinline__ float occ_of(float r, int mode, float p, float inv_s) {
  if (mode == 0) {
    const float sd = nan_max(__fsub_rn(fabsf(r), p), 0.f);
    const float sx = sigmoid(__fmul_rn(sd, inv_s));
    return __fmul_rn(__fmul_rn(4.f, sx), __fsub_rn(1.f, sx));
  }
  return __fsub_rn(1.f, expf(-__fmul_rn(r, p)));
}

// A voxel's new value from its samples' max m and its old value.
// warm_floor: the warm-up floor, or -inf outside the warm-up.
__device__ __forceinline__ float ema_of(float m, float old, float decay, float warm_floor) {
  return nan_max(nan_max(__fmul_rn(old, decay), m), warm_floor);
}

constexpr int kPointThreads = 256;
constexpr int kEmaThreads = 256;
constexpr int kEmaBlocksPerSm = 4;

// A thread four consecutive floats of x; vec: u and x 16-byte aligned and
// n % 4 == 0 (one float4 each way), else four scalar floats (the tail too).
// The thread that writes a point's first coordinate writes its lead.
__global__ void __launch_bounds__(kPointThreads)
occ_voxel_points_kernel(const float* __restrict__ u,         // [L, R, R, R, 3]
                        const float* __restrict__ aabb_min,  // [3]
                        const float* __restrict__ aabb_max,  // [3]
                        float* __restrict__ x,               // [L R^3, 3]
                        long long* __restrict__ lead_idx,    // [L R^3] or null
                        float* __restrict__ lead_t,          // [L R^3] or null
                        unsigned n, unsigned R, unsigned R3, float inv_R, float inv_L,
                        int vec) {
  const unsigned e0 = 4u * (blockIdx.x * kPointThreads + threadIdx.x);
  if (e0 >= n) return;
  const float mn0 = __ldg(aabb_min), mn1 = __ldg(aabb_min + 1), mn2 = __ldg(aabb_min + 2);
  const float ex0 = __fsub_rn(__ldg(aabb_max), mn0);
  const float ex1 = __fsub_rn(__ldg(aabb_max + 1), mn1);
  const float ex2 = __fsub_rn(__ldg(aabb_max + 2), mn2);
  // the first float's point p, axis a, lead l and voxel (i, j, k); the other
  // three follow
  unsigned p = e0 / 3u, l = p / R3;
  const unsigned v = p - l * R3;
  unsigned a = e0 - 3u * p, i = v / (R * R);
  const unsigned rem = v - i * (R * R);
  unsigned j = rem / R, k = rem - j * R;
  float in[4], out[4];
  if (vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(u) + (e0 >> 2));
    in[0] = q.x;
    in[1] = q.y;
    in[2] = q.z;
    in[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) in[c] = e0 + c < n ? __ldg(u + e0 + c) : 0.f;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const unsigned cell = a == 0u ? i : (a == 1u ? j : k);
    const float ex = a == 0u ? ex0 : (a == 1u ? ex1 : ex2);
    const float mn = a == 0u ? mn0 : (a == 1u ? mn1 : mn2);
    out[c] = __fadd_rn(__fmul_rn(__fmul_rn(__fadd_rn((float)cell, in[c]), inv_R), ex), mn);
    if (a == 0u && e0 + c < n) {
      if (lead_idx != nullptr) lead_idx[p] = (long long)l;
      if (lead_t != nullptr) lead_t[p] = __fmul_rn(__fadd_rn((float)l, 0.5f), inv_L);
    }
    if (++a == 3u) {
      a = 0u;
      ++p;
      if (++k == R) {
        k = 0u;
        if (++j == R) {
          j = 0u;
          if (++i == R) {
            i = 0u;
            ++l;
          }
        }
      }
    }
  }
  if (vec) {
    reinterpret_cast<float4*>(x)[e0 >> 2] = make_float4(out[0], out[1], out[2], out[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (e0 + c < n) x[e0 + c] = out[c];
  }
}

// Four voxels a thread, over a grid-stride loop of at most kEmaBlocksPerSm
// blocks an SM. vec: V % 4 == 0, raw, val and new_val 16-byte aligned and
// mask 4-byte aligned (float4 rows, one 32-bit mask store), else four scalar
// voxels (the tail too). kS: the samples a voxel, unrolled; 0 reads S at run
// time. acc: the blocks' sum in its high 32 bits and their ticket in its low
// 32, 0 between launches on a stream (the last block leaves it so): one
// atomic a block, and the block that draws the last ticket writes the count.
template <int kS>
__global__ void __launch_bounds__(kEmaThreads)
occ_ema_update_kernel(const float* __restrict__ raw,      // [S, V]
                      const float* __restrict__ val,      // [V]
                      float* __restrict__ new_val,        // [V]
                      uint8_t* __restrict__ mask,         // [V] bool
                      unsigned long long* __restrict__ acc,  // []
                      int* __restrict__ count_out,        // []
                      float* __restrict__ frac_out,       // []
                      long long V, int S, int mode, float p, float inv_s, float decay,
                      float thre, float warm_floor, float inv_V, int vec) {
  constexpr int kR = kS > 0 ? kS : 1;  // the samples held in registers
  const int nS = kS > 0 ? kS : S;
  const long long quads = (V + 3) / 4, stride = (long long)gridDim.x * kEmaThreads;
  unsigned occupied = 0u;
  for (long long q = (long long)blockIdx.x * kEmaThreads + threadIdx.x; q < quads;
       q += stride) {
    const long long i0 = 4ll * q;
    if (vec) {
      float4 r[kR];
#pragma unroll
      for (int s = 0; s < kR; ++s)
        r[s] = __ldg(reinterpret_cast<const float4*>(raw + (long long)s * V + i0));
      const float4 old = __ldg(reinterpret_cast<const float4*>(val + i0));
      float m0 = occ_of(r[0].x, mode, p, inv_s), m1 = occ_of(r[0].y, mode, p, inv_s);
      float m2 = occ_of(r[0].z, mode, p, inv_s), m3 = occ_of(r[0].w, mode, p, inv_s);
#pragma unroll
      for (int s = 1; s < kR; ++s) {
        m0 = nan_max(m0, occ_of(r[s].x, mode, p, inv_s));
        m1 = nan_max(m1, occ_of(r[s].y, mode, p, inv_s));
        m2 = nan_max(m2, occ_of(r[s].z, mode, p, inv_s));
        m3 = nan_max(m3, occ_of(r[s].w, mode, p, inv_s));
      }
      for (int s = kR; s < nS; ++s) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(raw + (long long)s * V + i0));
        m0 = nan_max(m0, occ_of(w.x, mode, p, inv_s));
        m1 = nan_max(m1, occ_of(w.y, mode, p, inv_s));
        m2 = nan_max(m2, occ_of(w.z, mode, p, inv_s));
        m3 = nan_max(m3, occ_of(w.w, mode, p, inv_s));
      }
      const float4 v = make_float4(ema_of(m0, old.x, decay, warm_floor),
                                   ema_of(m1, old.y, decay, warm_floor),
                                   ema_of(m2, old.z, decay, warm_floor),
                                   ema_of(m3, old.w, decay, warm_floor));
      *reinterpret_cast<float4*>(new_val + i0) = v;
      const unsigned b0 = v.x > thre, b1 = v.y > thre, b2 = v.z > thre, b3 = v.w > thre;
      *reinterpret_cast<unsigned*>(mask + i0) = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
      occupied += b0 + b1 + b2 + b3;
    } else {
      for (int c = 0; c < 4 && i0 + c < V; ++c) {
        const long long i = i0 + c;
        float m = occ_of(__ldg(raw + i), mode, p, inv_s);
        for (int s = 1; s < nS; ++s)
          m = nan_max(m, occ_of(__ldg(raw + (long long)s * V + i), mode, p, inv_s));
        const float v = ema_of(m, __ldg(val + i), decay, warm_floor);
        new_val[i] = v;
        mask[i] = v > thre ? 1 : 0;
        occupied += v > thre ? 1u : 0u;
      }
    }
  }
  // the occupied count: a warp's, the block's, then the grid's
  __shared__ unsigned s_warps[kEmaThreads / 32];
  occupied = __reduce_add_sync(0xffffffffu, occupied);
  if ((threadIdx.x & 31) == 0) s_warps[threadIdx.x >> 5] = occupied;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long block = 0ull;
#pragma unroll
    for (int w = 0; w < kEmaThreads / 32; ++w) block += s_warps[w];
    const unsigned long long old = atomicAdd(acc, (block << 32) | 1ull);
    if ((unsigned)old == gridDim.x - 1) {
      const unsigned total = (unsigned)(old >> 32) + (unsigned)block;
      *acc = 0ull;
      *count_out = (int)total;
      *frac_out = __fmul_rn(__uint2float_rn(total), inv_V);
    }
  }
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

// x: [L R^3, 3] from the jitter u [L, R, R, R, 3] and the box aabb_min,
// aabb_max [3]; lead_idx (int64) and lead_t (float) [L R^3] each a point's
// lead or null; inv_R, inv_L: fl(1 / R), fl(1 / L) in float32. 3 L R^3 < 2^31.
extern "C" int occ_voxel_points(const void* u, const void* aabb_min, const void* aabb_max,
                                void* x, void* lead_idx, void* lead_t, int L, int R,
                                float inv_R, float inv_L, void* stream) {
  if (L < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const long long R3 = (long long)R * R * R, n = 3ll * L * R3;
  if (n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int vec = (uintptr_t)u % 16 == 0 && (uintptr_t)x % 16 == 0 && n % 4 == 0;
  const long long quads = (n + 3) / 4;
  const unsigned blocks = (unsigned)((quads + kPointThreads - 1) / kPointThreads);
  occ_voxel_points_kernel<<<blocks, kPointThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)aabb_min, (const float*)aabb_max, (float*)x,
      (long long*)lead_idx, (float*)lead_t, (unsigned)n, (unsigned)R, (unsigned)R3, inv_R, inv_L,
      vec);
  return (int)cudaGetLastError();
}

// acc: one 64-bit word (8-byte aligned), 0 before the launch and left 0
// after it; count: one int and frac one float, written by the last block;
// inv_V: fl(1 / V); sms: the card's SM count.
extern "C" int occ_ema_update(const void* raw, const void* val, void* new_val, void* mask,
                              void* acc, void* count, void* frac, int V, int S, int mode,
                              float p, float inv_s, float decay, float thre, float warm_floor,
                              float inv_V, int sms, void* stream) {
  if (V < 1 || S < 1 || mode < 0 || mode > 1 || sms < 1 || (uintptr_t)acc % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int vec = V % 4 == 0 && (uintptr_t)raw % 16 == 0 && (uintptr_t)val % 16 == 0 &&
                  (uintptr_t)new_val % 16 == 0 && (uintptr_t)mask % 4 == 0;
  const long long quads = ((long long)V + 3) / 4;
  const long long want = (quads + kEmaThreads - 1) / kEmaThreads,
                  most = (long long)kEmaBlocksPerSm * sms;
  const unsigned blocks = (unsigned)(want < most ? want : most);
  auto launch = [&](auto kernel) {
    kernel<<<blocks, kEmaThreads, 0, (cudaStream_t)stream>>>(
        (const float*)raw, (const float*)val, (float*)new_val, (uint8_t*)mask,
        (unsigned long long*)acc, (int*)count, (float*)frac, (long long)V, S, mode, p, inv_s,
        decay, thre, warm_floor, inv_V, vec);
  };
  if (S == 1)
    launch(occ_ema_update_kernel<1>);
  else if (S == 4)
    launch(occ_ema_update_kernel<4>);
  else
    launch(occ_ema_update_kernel<0>);
  return (int)cudaGetLastError();
}
