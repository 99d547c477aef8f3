// K6 volume_composite: alpha -> transmittance -> volume integration, forward
// and backward.
//
// Replaces: neuralsim_tpu/ops/segment.py alpha_to_vw (lines 43-54) with
//   exclusive_cumprod (lines 30-40), and neuralsim_tpu/renderers/buffers.py
//   volume_integrate (lines 21-52) on a single sorted buffer.
//
// Per ray, over its S samples in order:
//   a_i  = mask_i ? alpha_i : 0
//   vw_i = a_i * prod_{j<i} (1 - a_j + 1e-10)                (written out)
//   mask_volume = sum vw,  depth_volume = sum vw*t / max(sum vw, 1e-8),
//   rgb_volume = sum vw*rgb,  normals_volume = sum vw*nablas (not normalised),
//   samples_cnt = sum mask                                    (sums over masked lanes)
// rgb and nablas may be null, and then their outputs are not written.
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
// exact where "suffix sum over q_i" would divide by 1e-10. Masked lanes get
// zero and let B pass (q = 1 + 1e-10 is 1 in f32). Where the caller asks for
// it (d_t not null: pose refinement moves the sample depths), the depths'
// gradient comes from the depth alone, d t_i = mask_i * (g_depth / den) * v_i
// (the weights do not depend on t).
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
// rays: deterministic, no float atomics). No gradient goes to t or d.
//
// What bounds them on an H100: bytes. K6 reads 33 bytes a lane and writes 4
// (its backward reads 37 and writes 28); K12 reads 33 and writes 8 (its
// backward 41 and 20), with ~20-50 (forward) and ~90 (backward) flops a lane.
// Only the recurrences are sequential: the transmittance and the sums in
// index order (whose bits are the plain chain's), and the backward's suffix
// B. So a ray takes a group of G lanes (8, 16 or 32) in blocks of 128
// threads, in chunks of K G samples (K 3-6 a lane; G and K chosen in the C
// entry from S, config_for): lane l owns samples l, l + G, ..., loads their t,
// mask, alpha (or sdf), rgb and nablas into registers, all issued before
// any arithmetic (the loads of a group's lanes are coalesced; an rgb or
// nablas row is read by its own lane, as no other lane needs it), and K12's
// lane computes its samples' NeuS terms once, in parallel (the backward
// keeps them in shared memory for its last phase). The walks are then
// short loops over shared memory, every lane of a group stepping them (a
// warp's lanes share each instruction, so the rays of a warp share the
// walk):
//   1. T_{j+1} = T_j q_j with q_j = (1 - a_j) + 1e-10 from the owners (1
//      where masked, as in the plain chain): one multiply a step;
//   2. each owner forms v_j = a_j T_j (the walk's product, the same bits)
//      and the terms of the 8 sums (weight, depth, rgb, normals), each 0
//      where masked, and lane c adds sum c over j in index order: one add
//      a step. A sum starts at +0 and is never -0, so adding a masked
//      lane's +0 leaves it as skipping that lane leaves it: vw, alpha and
//      every sum keep the plain chain's bits (and the earlier kernel's);
//   3. the backward: each owner forms g_j once depth is known, and
//      h_j = g_j a_j (0 where masked), and the group walks
//      B_{j-1} = h_j + q_j B_j in reverse; each owner then finishes d alpha
//      (and K12's chain back to sdf, nablas and inv_s) and writes its rows;
//      d inv_s is summed over the group in a fixed order.
// A ray wider than a chunk is walked chunk by chunk (T and the sums
// carried in registers); the backward keeps each chunk's starting T in
// dynamic shared memory and loads the chunk again for its reverse pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // a block: 128 / G rays
constexpr int kSums = 8;       // the forward's sums: weight, depth, rgb x 3, normals x 3
constexpr unsigned kAll = 0xffffffffu;

// Where a group of G lanes stands. A group past N walks ray N - 1 again
// (its warp stays whole for the warp-wide syncs and shuffles) and writes
// nothing.
struct Ray {
  int gl;      // the lane's place in its group
  int slot;    // the group's place in the block
  int r;       // its ray
  bool valid;  // r < N
  int base;    // the group's first lane in its warp
};

template <int G>
__device__ __forceinline__ bool ray_of(int N, Ray& R) {
  constexpr int rays = kThreads / G;
  R.gl = threadIdx.x & (G - 1);
  R.slot = threadIdx.x / G;
  const int first = blockIdx.x * rays;
  if (first + (int)(threadIdx.x >> 5) * (32 / G) >= N) return false;  // the whole warp
  R.r = first + R.slot;
  R.valid = R.r < N;
  if (!R.valid) R.r = N - 1;
  R.base = threadIdx.x & 31 & ~(G - 1);
  return true;
}

// One chunk of a ray in shared memory: t (K12's dt), q_j, T_j, and the
// sums' terms (the forward's 8, the backward's weight and depth), with the
// backward's h_j and B_j.
template <int G, int K, bool NEUS, int SUMS>
struct Stage {
  static constexpr int CH = K * G;
  float t[NEUS ? CH + 1 : 1];  // depths, and the next chunk's first
  float q[CH];
  float w[CH];
  float p[SUMS][CH + 1];  // sum-major, rows padded: the owners' writes and the
                          // sums' reads fall in distinct banks
};

template <int G, int K, bool NEUS>
struct BwdStage : Stage<G, K, NEUS, 2> {
  float h[K * G];
  float b[K * G];
  // K12's NeuS terms of the chunk's samples, for their lanes' last phase:
  // raw, P, Q, ep, en, dt, tc (in registers they would hold fewer blocks an
  // SM)
  float nl[7][NEUS ? K * G : 1];
};

struct Inputs {
  const float* t;       // [N, S]
  const uint8_t* mask;  // [N, S]
  const float* alpha;   // [N, S] (K6)
  const float* sdf;     // [N, S] (K12)
  const float* rays_d;  // [N, 3] (K12)
  const float* inv_s;   // [] (K12)
  const float* rgb;     // [N, S, 3] or null
  const float* nablas;  // [N, S, 3] (K6: or null)
  int N, S;
  float an;  // K12's cos anneal
};

// One lane of a NeuS buffer: the alpha and what its backward needs.
struct NeuSLane {
  float tc, y1, dt, ep, en, P, Q, num, den, raw, a;
};

__device__ __forceinline__ void neus_lane(const float nb[3], const float d[3], float dt, float s,
                                          float an, float inv_s, NeuSLane& L) {
  L.tc = __fadd_rn(__fadd_rn(__fmul_rn(d[0], nb[0]), __fmul_rn(d[1], nb[1])),
                   __fmul_rn(d[2], nb[2]));
  L.y1 = __fadd_rn(__fmul_rn(-L.tc, 0.5f), 0.5f);
  const float cos = -__fadd_rn(__fmul_rn(fmaxf(L.y1, 0.f), __fsub_rn(1.f, an)),
                               __fmul_rn(fmaxf(-L.tc, 0.f), an));
  L.dt = dt;
  const float half = __fmul_rn(__fmul_rn(cos, L.dt), 0.5f);
  L.ep = __fsub_rn(s, half);
  L.en = __fadd_rn(s, half);
  L.P = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(L.ep, inv_s))));
  L.Q = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(L.en, inv_s))));
  L.num = __fadd_rn(__fsub_rn(L.P, L.Q), 1e-5f);
  L.den = __fadd_rn(L.P, 1e-5f);
  L.raw = __fdiv_rn(L.num, L.den);
  L.a = L.raw < 0.f ? 0.f : (L.raw > 1.f ? 1.f : L.raw);  // a NaN stays NaN
}

// A lane's samples of a chunk, in registers: sample k is j = gl + k G.
template <int K>
struct Own {
  bool m[K];                            // masked in (false past the chunk)
  float t[K], a[K], c[K][3], nb[K][3];  // a: alpha, 0 where masked
  float gv[K], ga[K], dot[K];           // the backward's: cotangents of vw and alpha,
                                        // g_rgb . rgb + g_nrm . nablas
  NeuSLane L[K];                        // K12
};

// Load the chunk [c0, c0 + n) of ray o / S into the lane's registers, every
// load issued first and none in a branch (a sample past the chunk reads the
// chunk's last and counts as masked): t, mask, alpha or sdf, rgb, nablas
// and, in the backward (BWD), the cotangents of vw and alpha (zero where
// null) and the payloads' dot products with the ray's cotangents gc, gn. K12
// computes its samples' NeuS terms (its dt from the next lane's t, staged).
// Stages q_j for every j of the chunk's K G (1 past n: the walks can run the
// whole chunk). Returns the lane's count of masked-in samples.
template <int G, int K, bool NEUS, bool BWD, class St>
__device__ __forceinline__ int load_chunk(const Inputs& p, const Ray& R, size_t o, int c0, int n,
                                          St& st, Own<K>& w, const float d[3], float inv_s,
                                          const float* g_vw, const float* g_alpha,
                                          const float gc[3], const float gn[3]) {
  int cnt = 0;
  float s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = R.gl + k * G;
    const size_t i = o + c0 + min(j, n - 1);
    w.m[k] = p.mask[i] != 0 && j < n;
    w.t[k] = p.t[i];
    if constexpr (NEUS)
      s[k] = p.sdf[i];
    else
      w.a[k] = p.alpha[i];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      w.c[k][x] = p.rgb != nullptr ? p.rgb[i * 3 + x] : 0.f;
      w.nb[k][x] = p.nablas != nullptr ? p.nablas[i * 3 + x] : 0.f;
    }
    if constexpr (BWD) {
      w.gv[k] = g_vw != nullptr ? g_vw[i] : 0.f;
      w.ga[k] = g_alpha != nullptr ? g_alpha[i] : 0.f;
    }
    cnt += w.m[k];
  }
  if constexpr (NEUS) {
#pragma unroll
    for (int k = 0; k < K; ++k) st.t[R.gl + k * G] = w.t[k];
    if (R.gl == 0 && c0 + n < p.S) st.t[n] = p.t[o + c0 + n];
    __syncwarp();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = R.gl + k * G;
    if constexpr (NEUS) {
      const float dt = c0 + j + 1 < p.S ? __fsub_rn(st.t[j + 1], w.t[k]) : 1e-3f;
      neus_lane(w.nb[k], d, dt, s[k], p.an, inv_s, w.L[k]);
      w.a[k] = w.L[k].a;
      if constexpr (BWD) {
        const NeuSLane& l = w.L[k];
        st.nl[0][j] = l.raw, st.nl[1][j] = l.P, st.nl[2][j] = l.Q, st.nl[3][j] = l.ep;
        st.nl[4][j] = l.en, st.nl[5][j] = l.dt, st.nl[6][j] = l.tc;
      }
    }
    w.a[k] = w.m[k] ? w.a[k] : 0.f;
    st.q[j] = __fadd_rn(__fsub_rn(1.f, w.a[k]), 1e-10f);
    if constexpr (BWD) {  // the payloads' share of g_j, added as the earlier kernel added it
      const float* nb = w.nb[k];
      const float* cc = w.c[k];
      const float dn = gn[0] * nb[0] + gn[1] * nb[1] + gn[2] * nb[2];
      const float dc = gc[0] * cc[0] + gc[1] * cc[1] + gc[2] * cc[2];
      if constexpr (NEUS)
        w.dot[k] = p.rgb != nullptr ? dn + dc : dn;
      else
        w.dot[k] = p.rgb != nullptr ? (p.nablas != nullptr ? dc + dn : dc)
                                    : (p.nablas != nullptr ? dn : 0.f);
    }
  }
  __syncwarp();
  return cnt;
}

// The transmittance walk over a staged chunk of CH, in the plain order: T_j
// into w (lane 0 of the group writes it), trans = T_CH after (T_n: q is 1
// past n).
template <int CH, class St>
__device__ __forceinline__ void walk_trans(St& st, bool keep, float& trans) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    if (keep) st.w[j] = trans;
    trans = __fmul_rn(trans, st.q[j]);
  }
}

// Sum `sum` of the staged terms over the chunk, in index order (the terms
// past n are 0).
template <int CH, class St>
__device__ __forceinline__ void walk_sum(const St& st, int sum, float& acc) {
#pragma unroll
  for (int j = 0; j < CH; ++j) acc = __fadd_rn(acc, st.p[sum][j]);
}

__device__ __forceinline__ void ray_dir(const Inputs& p, const Ray& R, float d[3], float& inv_s) {
  d[0] = p.rays_d[R.r * 3 + 0];
  d[1] = p.rays_d[R.r * 3 + 1];
  d[2] = p.rays_d[R.r * 3 + 2];
  inv_s = __ldg(p.inv_s);
}

struct FwdOut {
  float* vw;              // [N, S]
  float* mask_volume;     // [N]
  float* depth_volume;    // [N]
  float* rgb_volume;      // [N, 3] or null
  float* normals_volume;  // [N, 3] or null
  int* samples_cnt;       // [N]
  float* alpha;           // [N, S] (K12)
};

template <int G, int K, bool NEUS>
__global__ void __launch_bounds__(kThreads) composite_kernel(const Inputs p, const FwdOut out) {
  constexpr int CH = K * G;
  __shared__ Stage<G, K, NEUS, kSums> stage[kThreads / G];
  Ray R;
  if (!ray_of<G>(p.N, R)) return;
  auto& st = stage[R.slot];
  const size_t o = (size_t)R.r * p.S;
  float d[3] = {0.f, 0.f, 0.f}, inv_s = 0.f;
  if constexpr (NEUS) ray_dir(p, R, d, inv_s);
  const float none[3] = {0.f, 0.f, 0.f};
  // lane c < 8 adds sum c: 0 the weight, 1 the depth, 2-4 rgb, 5-7 normals
  const int sum = min(R.gl, kSums - 1);
  Own<K> w;
  float trans = 1.f, acc = 0.f;
  int cnt = 0;
  for (int c0 = 0; c0 < p.S; c0 += CH) {
    const int n = min(CH, p.S - c0);
    if (c0 > 0) __syncwarp();  // the last chunk's terms are summed
    cnt += load_chunk<G, K, NEUS, false>(p, R, o, c0, n, st, w, d, inv_s, nullptr, nullptr,
                                         none, none);
    walk_trans<CH>(st, R.gl == 0, trans);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = R.gl + k * G;
      const bool m = w.m[k];
      const float v = __fmul_rn(w.a[k], st.w[j]);  // the walk's v_j
      if (R.valid && j < n) {
        out.vw[o + c0 + j] = v;
        if constexpr (NEUS) out.alpha[o + c0 + j] = w.a[k];
      }
      st.p[0][j] = m ? v : 0.f;
      st.p[1][j] = m ? __fmul_rn(v, w.t[k]) : 0.f;
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        if (p.rgb != nullptr) st.p[2 + x][j] = m ? __fmul_rn(v, w.c[k][x]) : 0.f;
        if (p.nablas != nullptr) st.p[5 + x][j] = m ? __fmul_rn(v, w.nb[k][x]) : 0.f;
      }
    }
    __syncwarp();
    walk_sum<CH>(st, sum, acc);
  }
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1) cnt += __shfl_xor_sync(kAll, cnt, s);
  const float vsum = __shfl_sync(kAll, acc, R.base);
  const float dsum = __shfl_sync(kAll, acc, R.base + 1);
  if (!R.valid) return;
  if (R.gl == 0) {
    out.mask_volume[R.r] = vsum;
    out.depth_volume[R.r] = __fdiv_rn(dsum, fmaxf(vsum, 1e-8f));
    out.samples_cnt[R.r] = cnt;
  } else if (R.gl >= 2 && R.gl < 5 && p.rgb != nullptr) {
    out.rgb_volume[R.r * 3 + R.gl - 2] = acc;
  } else if (R.gl >= 5 && R.gl < 8 && p.nablas != nullptr) {
    out.normals_volume[R.r * 3 + R.gl - 5] = acc;
  }
}

struct BwdIO {
  const float* g_vw;     // [N, S] (K12: or null)
  const float* g_mask;   // [N] (K12: or null)
  const float* g_depth;  // [N] (K12: or null)
  const float* g_rgb;    // [N, 3] or null
  const float* g_nrm;    // [N, 3] or null
  const float* g_alpha;  // [N, S] or null (K12)
  float* d_alpha;        // [N, S] (K6)
  float* d_sdf;          // [N, S] (K12)
  float* d_rgb;          // [N, S, 3] or null
  float* d_nablas;       // [N, S, 3] (K6: or null)
  float* d_inv_s;        // [N] (K12)
  float* d_t;            // [N, S] or null (K6)
};

template <int G, int K, bool NEUS>
__global__ void __launch_bounds__(kThreads) composite_bwd_kernel(const Inputs p, const BwdIO q) {
  constexpr int CH = K * G;
  __shared__ BwdStage<G, K, NEUS> stage[kThreads / G];
  extern __shared__ float chunk_trans[];  // [rays a block][chunks] where a ray takes several
  Ray R;
  if (!ray_of<G>(p.N, R)) return;
  auto& st = stage[R.slot];
  const size_t o = (size_t)R.r * p.S;
  const int chunks = (p.S + CH - 1) / CH;
  float* cs = chunk_trans + R.slot * chunks;
  float d[3] = {0.f, 0.f, 0.f}, inv_s = 0.f;
  if constexpr (NEUS) ray_dir(p, R, d, inv_s);
  float gc[3] = {0.f, 0.f, 0.f}, gn[3] = {0.f, 0.f, 0.f};
  if (p.rgb != nullptr && q.g_rgb != nullptr)
    for (int x = 0; x < 3; ++x) gc[x] = q.g_rgb[R.r * 3 + x];
  if (p.nablas != nullptr && q.g_nrm != nullptr)
    for (int x = 0; x < 3; ++x) gn[x] = q.g_nrm[R.r * 3 + x];
  Own<K> w;

  // the forward walk: T_j, then the weight sum (lane 0) and the depth sum
  // (lane 1) as the forward adds them
  const int sum = min(R.gl, 1);
  float trans = 1.f, acc = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int c0 = c * CH, n = min(CH, p.S - c0);
    if (c > 0) __syncwarp();
    load_chunk<G, K, NEUS, true>(p, R, o, c0, n, st, w, d, inv_s, q.g_vw, q.g_alpha, gc, gn);
    if (chunks > 1 && R.gl == 0) cs[c] = trans;
    walk_trans<CH>(st, R.gl == 0, trans);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = R.gl + k * G;
      const float v = __fmul_rn(w.a[k], st.w[j]);
      st.p[0][j] = w.m[k] ? v : 0.f;
      st.p[1][j] = w.m[k] ? __fmul_rn(v, w.t[k]) : 0.f;
    }
    __syncwarp();
    walk_sum<CH>(st, sum, acc);
  }
  const float vsum = __shfl_sync(kAll, acc, R.base);
  const float dsum = __shfl_sync(kAll, acc, R.base + 1);
  const float den = fmaxf(vsum, 1e-8f);
  const float gm = q.g_mask != nullptr ? q.g_mask[R.r] : 0.f;
  const float gd = q.g_depth != nullptr ? q.g_depth[R.r] / den : 0.f;
  const float depth = vsum >= 1e-8f ? dsum / den : 0.f;

  // the reverse pass, chunk by chunk from the last
  float B = 0.f, dinv = 0.f;
  float g[K];
  for (int c = chunks - 1; c >= 0; --c) {
    const int c0 = c * CH, n = min(CH, p.S - c0);
    if (chunks > 1) {  // load the chunk again, and its T_j from its starting T
      __syncwarp();
      load_chunk<G, K, NEUS, true>(p, R, o, c0, n, st, w, d, inv_s, q.g_vw, q.g_alpha, gc, gn);
      float tr = cs[c];
      walk_trans<CH>(st, R.gl == 0, tr);
    }
    // g_j and h_j = g_j a_j of the lane's samples (0 where masked)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      g[k] = w.gv[k] + gm + gd * (w.t[k] - depth) + w.dot[k];
      st.h[R.gl + k * G] = w.m[k] ? g[k] * w.a[k] : 0.f;
    }
    __syncwarp();
    // the suffix B_j, in reverse order (h_j 0 and q_j 1 where masked or past
    // n: B passes); lane 0 keeps each B_j
#pragma unroll
    for (int j = CH - 1; j >= 0; --j) {
      if (R.gl == 0) st.b[j] = B;
      B = st.h[j] + st.q[j] * B;
    }
    __syncwarp();
    // d alpha of the lane's samples (K12: on through the NeuS chain), and
    // their d rgb and d nablas rows
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = R.gl + k * G;
      const size_t i = o + c0 + j;
      const bool m = w.m[k];
      const float T = st.w[j];
      const float v = w.a[k] * T, da0 = T * (g[k] - st.b[j]);
      float dtc = 0.f;
      if constexpr (NEUS) {
        NeuSLane l;
        l.raw = st.nl[0][j], l.P = st.nl[1][j], l.Q = st.nl[2][j], l.ep = st.nl[3][j];
        l.en = st.nl[4][j], l.dt = st.nl[5][j], l.tc = st.nl[6][j];
        float da = da0 + w.ga[k];
        // the clip: the whole gradient inside (0, 1), half at a tie, none outside
        const float raw = l.raw;
        da *= (raw > 0.f && raw < 1.f) ? 1.f : ((raw == 0.f || raw == 1.f) ? 0.5f : 0.f);
        // raw = num / den, num = P - Q + eps, den = P + eps (as neus_lane rounds them)
        const float num = __fadd_rn(__fsub_rn(l.P, l.Q), 1e-5f), dn = __fadd_rn(l.P, 1e-5f);
        const float dnum = da / dn;
        const float dden = -da * num / (dn * dn);
        const float du = (dnum + dden) * l.P * (1.f - l.P);  // through P = sigmoid(u)
        const float dv = -dnum * l.Q * (1.f - l.Q);          // through Q = sigmoid(v)
        const float dep = du * inv_s, den_ = dv * inv_s;
        // ep = sdf - cos dt / 2, en = sdf + cos dt / 2; cos from tc through the anneal
        const float dcos = (den_ - dep) * 0.5f * l.dt;
        const float y1 = __fadd_rn(__fmul_rn(-l.tc, 0.5f), 0.5f);
        if (m) {
          dinv += du * l.ep + dv * l.en;
          dtc = dcos * ((y1 > 0.f ? 0.5f * (1.f - p.an) : 0.f) + (-l.tc > 0.f ? p.an : 0.f));
        }
        if (R.valid && j < n) q.d_sdf[i] = m ? dep + den_ : 0.f;
      } else {
        if (R.valid && j < n) q.d_alpha[i] = m ? da0 : 0.f;
        if (q.d_t != nullptr && R.valid && j < n) q.d_t[i] = m ? gd * v : 0.f;
      }
      if (R.valid && j < n) {
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          if (p.rgb != nullptr) q.d_rgb[i * 3 + x] = m ? v * gc[x] : 0.f;
          if (p.nablas != nullptr) {
            float dnb;
            if constexpr (NEUS)
              dnb = v * gn[x] + dtc * d[x];
            else
              dnb = v * gn[x];
            q.d_nablas[i * 3 + x] = m ? dnb : 0.f;
          }
        }
      }
    }
  }
  if constexpr (NEUS) {
    // each ray's share of d inv_s, summed over the group in a fixed order
#pragma unroll
    for (int s = G / 2; s > 0; s >>= 1) dinv += __shfl_xor_sync(kAll, dinv, s);
    if (R.valid && R.gl == 0) q.d_inv_s[R.r] = dinv;
  }
}

// G lanes a ray and K samples a lane in a chunk of K G. The walks run a
// whole chunk, so a chunk fits the ray where it can: 8 lanes up to 32
// samples, 16 lanes up to 48, 64 and (K12) 96 (3, 4 and 6 samples a lane),
// and past that 32 lanes and chunks of 128 (measured on an H100 against 8,
// 16 and 32 lanes of 2-8 samples at the main path's 48, 64 and 96). K6
// takes 32 lanes of 4 past 64 samples: at 16 of 6 its forward spills.
struct Config {
  int G, K;
};

Config config_for(int S, bool neus) {
  if (S <= 32) return {8, 4};
  if (S <= 48) return {16, 3};
  if (S <= 64) return {16, 4};
  if (S <= 96 && neus) return {16, 6};
  return {32, 4};
}

template <int G, int K, bool NEUS>
cudaError_t launch_fwd_gk(const Inputs& p, const FwdOut& out, cudaStream_t stream) {
  constexpr int rays = kThreads / G;
  const int blocks = p.N > 0 ? (p.N + rays - 1) / rays : 1;
  composite_kernel<G, K, NEUS><<<blocks, kThreads, 0, stream>>>(p, out);
  return cudaGetLastError();
}

template <int G, int K, bool NEUS>
cudaError_t launch_bwd_gk(const Inputs& p, const BwdIO& q, cudaStream_t stream) {
  constexpr int rays = kThreads / G, CH = K * G;
  const int chunks = (p.S + CH - 1) / CH;
  // a ray of several chunks keeps each chunk's starting T in dynamic shared
  // memory; past the default 48 KB a block, the card's opt-in limit
  const size_t dyn = chunks > 1 ? (size_t)rays * chunks * sizeof(float) : 0;
  const size_t total = dyn + rays * sizeof(BwdStage<G, K, NEUS>);
  if (total > 48 * 1024) {
    cudaError_t e;
    int dev = 0, optin = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
        cudaSuccess)
      return e;
    if (total > (size_t)optin) return cudaErrorInvalidValue;
    if ((e = cudaFuncSetAttribute(composite_bwd_kernel<G, K, NEUS>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn)) !=
        cudaSuccess)
      return e;
  }
  const int blocks = p.N > 0 ? (p.N + rays - 1) / rays : 1;
  composite_bwd_kernel<G, K, NEUS><<<blocks, kThreads, dyn, stream>>>(p, q);
  return cudaGetLastError();
}

// The configurations config_for picks, each a kernel of its own.
#define K6_CONFIGS(X) X(8, 4) X(16, 3) X(16, 4) X(32, 4)
#define K12_CONFIGS(X) X(8, 4) X(16, 3) X(16, 4) X(16, 6) X(32, 4)

template <bool NEUS>
int launch_fwd(const Inputs& p, const FwdOut& out, cudaStream_t stream) {
  if (p.N < 0 || p.S < 0) return (int)cudaErrorInvalidValue;
  const Config c = config_for(p.S, NEUS);
#define FWD(g, k) \
  if (c.G == g && c.K == k) return (int)launch_fwd_gk<g, k, NEUS>(p, out, stream);
  if constexpr (NEUS) {
    K12_CONFIGS(FWD)
  } else {
    K6_CONFIGS(FWD)
  }
#undef FWD
  return (int)cudaErrorInvalidValue;
}

template <bool NEUS>
int launch_bwd(const Inputs& p, const BwdIO& q, cudaStream_t stream) {
  if (p.N < 0 || p.S < 0) return (int)cudaErrorInvalidValue;
  const Config c = config_for(p.S, NEUS);
#define BWD(g, k) \
  if (c.G == g && c.K == k) return (int)launch_bwd_gk<g, k, NEUS>(p, q, stream);
  if constexpr (NEUS) {
    K12_CONFIGS(BWD)
  } else {
    K6_CONFIGS(BWD)
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int volume_composite_fwd(const void* t, const void* mask, const void* alpha,
                                    const void* rgb, const void* nablas, void* vw,
                                    void* mask_volume, void* depth_volume, void* rgb_volume,
                                    void* normals_volume, void* samples_cnt, int N, int S,
                                    void* stream) {
  const Inputs p{(const float*)t, (const uint8_t*)mask, (const float*)alpha, nullptr, nullptr,
                 nullptr, (const float*)rgb, (const float*)nablas, N, S, 0.f};
  const FwdOut out{(float*)vw, (float*)mask_volume, (float*)depth_volume, (float*)rgb_volume,
                   (float*)normals_volume, (int*)samples_cnt, nullptr};
  return launch_fwd<false>(p, out, (cudaStream_t)stream);
}

extern "C" int volume_composite_bwd(const void* t, const void* mask, const void* alpha,
                                    const void* rgb, const void* nablas, const void* g_vw,
                                    const void* g_mask, const void* g_depth, const void* g_rgb,
                                    const void* g_nrm, void* d_alpha, void* d_rgb,
                                    void* d_nablas, void* d_t, int N, int S, void* stream) {
  const Inputs p{(const float*)t, (const uint8_t*)mask, (const float*)alpha, nullptr, nullptr,
                 nullptr, (const float*)rgb, (const float*)nablas, N, S, 0.f};
  const BwdIO q{(const float*)g_vw, (const float*)g_mask, (const float*)g_depth,
                (const float*)g_rgb, (const float*)g_nrm, nullptr, (float*)d_alpha, nullptr,
                (float*)d_rgb, (float*)d_nablas, nullptr, (float*)d_t};
  return launch_bwd<false>(p, q, (cudaStream_t)stream);
}

extern "C" int neus_composite_fwd(const void* t, const void* mask, const void* sdf,
                                  const void* nablas, const void* rays_d, const void* inv_s,
                                  const void* rgb, void* vw, void* mask_volume,
                                  void* depth_volume, void* rgb_volume, void* normals_volume,
                                  void* samples_cnt, void* alpha, int N, int S, float anneal,
                                  void* stream) {
  const Inputs p{(const float*)t, (const uint8_t*)mask, nullptr, (const float*)sdf,
                 (const float*)rays_d, (const float*)inv_s, (const float*)rgb,
                 (const float*)nablas, N, S, anneal};
  const FwdOut out{(float*)vw, (float*)mask_volume, (float*)depth_volume, (float*)rgb_volume,
                   (float*)normals_volume, (int*)samples_cnt, (float*)alpha};
  return launch_fwd<true>(p, out, (cudaStream_t)stream);
}

extern "C" int neus_composite_bwd(const void* t, const void* mask, const void* sdf,
                                  const void* nablas, const void* rays_d, const void* inv_s,
                                  const void* rgb, const void* g_vw, const void* g_mask,
                                  const void* g_depth, const void* g_rgb, const void* g_nrm,
                                  const void* g_alpha, void* d_sdf, void* d_nablas, void* d_rgb,
                                  void* d_inv_s, int N, int S, float anneal, void* stream) {
  const Inputs p{(const float*)t, (const uint8_t*)mask, nullptr, (const float*)sdf,
                 (const float*)rays_d, (const float*)inv_s, (const float*)rgb,
                 (const float*)nablas, N, S, anneal};
  const BwdIO q{(const float*)g_vw, (const float*)g_mask, (const float*)g_depth,
                (const float*)g_rgb, (const float*)g_nrm, (const float*)g_alpha, nullptr,
                (float*)d_sdf, (float*)d_rgb, (float*)d_nablas, (float*)d_inv_s, nullptr};
  return launch_bwd<true>(p, q, (cudaStream_t)stream);
}
