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
// gives. With g = dL/dvw:
//   dL/da_k = g_k exp(S_k) + l'_k * sum_{i : (key_k, k) < (key_i, i)} g_i vw_i
//   l'_k    = -1 / (1 - min(a_k, 0.999)) times JAX's gradient of the min
//             (1 below the cap, 1/2 at a tie, 0 above)
//   dL/dalpha_k = mask_k ? dL/da_k times the clip's gradient (1 inside
//             (0, 1), 1/2 at exactly 0 or 1, 0 outside) : 0
// (jnp.clip and jnp.minimum split a tie's gradient in halves, and so do
// torch.maximum and torch.minimum of the plain version). No gradient goes to
// t: the order is not differentiable.
//
// What bounds it on an H100: bytes, 17 a lane in the forward (t, mask,
// alpha in; vw and S out) plus 2 for the rank, 19 in the backward (mask,
// alpha, S, rank, g in; d alpha out). The plain version's O(L^2) compares
// are not needed: the sets "before" and "after" are those of a stable order
// by (key, lane), so each ray sorts its lanes once and scans.
//   Forward: each lane's key is the 64-bit (ordered bits of key_i + 0.0f, i):
//   adding +0.0f makes -0.0 and +0.0 one key, so they tie by lane as the
//   float compare of the plain version has them. A row of up to 32 P lanes
//   (P = 1, 2, 4, 8: L <= 256) is sorted by one warp with a bitonic network
//   in registers, slot s = lane * P + r, pads an all-ones key; partners
//   within a lane are swapped in registers, across lanes by
//   __shfl_xor_sync. Slot s then holds the lane of rank s; each slot reads
//   that lane's log1ma from shared memory, a warp scan (P sequential adds a
//   lane, then shuffles) gives the exclusive sum S in sorted order, and S
//   and the rank go back to the lane through shared memory. The kernel
//   writes vw = a exp(S) and, where the caller asks (the backward will
//   follow), S and each lane's rank as int16 [N, L]. Wider rows (up to
//   16,384 lanes) sort in shared memory, a block a ray, in a kernel of
//   their own (the same keys, the same network, a block scan).
//   Backward: no sort and no O(L^2) loop. u_i = g_i vw_i goes to its rank's
//   slot in shared memory, an exclusive suffix sum over the slots (a warp
//   scan, or a block scan for wide rows) gives sum_{i after k} u_i, and
//   lane k reads it back at its rank; the epilogue is the formula above.
//   The sums run in sorted order and in a fixed tree (no atomics): the same
//   bits on every call; the plain version sums lane by lane.
//   A NaN depth on a lane inside the mask sorts by its bits (after +inf, or
//   before -inf with the sign bit set), where the plain version's compares
//   put no lane before it and it before none: such a ray's weights differ
//   from the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e10f;
constexpr float OCC_CAP = 0.999f;   // 1 - 1e-3, as the plain version rounds it
constexpr u64 PAD = ~0ull;          // after every lane's key
constexpr int WARP_ROWS = 4;        // rays (warps) a block for rows of up to 256 lanes
constexpr int BLOCK = 512;          // threads a ray for wider rows

__device__ __forceinline__ u64 sort_key(float t, bool m, int i) {
  const unsigned b = __float_as_uint(m ? __fadd_rn(t, 0.f) : BIG);
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((u64)o << 32) | (unsigned)i;
}

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

// The gradient of jnp.clip(x, 0, 1) and of jnp.minimum(x, cap): a tie splits it.
__device__ __forceinline__ float clip_grad(float x) {
  return (x > 0.f && x < 1.f) ? 1.f : ((x == 0.f || x == 1.f) ? 0.5f : 0.f);
}

// d alpha_k from the cotangent g_k, exp(S_k) and the sum over the lanes after k.
__device__ __forceinline__ float k8_grad(bool m, float x, float g, float e, float after) {
  if (!m) return 0.f;
  const float a = clip01(x);
  const float cap_grad = a < OCC_CAP ? 1.f : (a == OCC_CAP ? 0.5f : 0.f);
  const float dl = -cap_grad / (1.f - fminf(a, OCC_CAP));
  return (g * e + dl * after) * clip_grad(x);
}

// Ascending bitonic sort of the warp's 32 P keys, slot s = lane * P + r.
// Where the partner s ^ j lies in another lane (j >= P), bits j and size of
// s are the lane's own (r < P), so the direction is one test a lane and step.
template <int P>
__device__ __forceinline__ void warp_sort(u64 (&k)[P], int lane) {
  const int ls = lane * P;
#pragma unroll
  for (int size = 2; size <= 32 * P; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j >= P) {  // the partner is in lane lane ^ (j / P)
        const bool keep_min = ((ls & size) == 0) == ((ls & j) == 0);
#pragma unroll
        for (int r = 0; r < P; ++r) {
          const u64 o = __shfl_xor_sync(FULL, k[r], j / P);
          k[r] = ((o < k[r]) == keep_min) ? o : k[r];  // o == k only between pads
        }
      } else {  // the partner is in this lane's registers
#pragma unroll
        for (int r = 0; r < P; ++r) {
          if ((r & j) == 0) {
            const bool up = ((ls | r) & size) == 0;
            const u64 x = k[r], y = k[r | j];
            const bool swap = (y < x) == up;
            k[r] = swap ? y : x;
            k[r | j] = swap ? x : y;
          }
        }
      }
    }
  }
}

// Exclusive sums over the warp's 32 P slots in slot order (forward) or in
// reverse (suffix), P sequential adds a lane, then a shuffle scan of the
// lanes' totals.
template <int P, bool SUFFIX>
__device__ __forceinline__ void warp_scan(float (&v)[P], int lane) {
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int r = SUFFIX ? P - 1 - q : q;
    const float x = v[r];
    v[r] = acc;
    acc += x;
  }
  float incl = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = SUFFIX ? __shfl_down_sync(FULL, incl, d) : __shfl_up_sync(FULL, incl, d);
    if (SUFFIX ? lane + d < 32 : lane >= d) incl += y;
  }
  float excl = SUFFIX ? __shfl_down_sync(FULL, incl, 1) : __shfl_up_sync(FULL, incl, 1);
  if (lane == (SUFFIX ? 31 : 0)) excl = 0.f;
#pragma unroll
  for (int r = 0; r < P; ++r) v[r] += excl;
}

template <int P>
__global__ void cross_source_vw_kernel(const float* __restrict__ t,      // [N, L]
                                       const uint8_t* __restrict__ mask, // [N, L]
                                       const float* __restrict__ alpha,  // [N, L]
                                       float* __restrict__ vw,           // [N, L]
                                       float* __restrict__ logt,         // [N, L] or null
                                       int16_t* __restrict__ rank,       // [N, L] or null
                                       int N, int L) {
  __shared__ float s_val[WARP_ROWS][32 * P];       // log1ma by lane, then S by lane
  __shared__ int16_t s_rank[WARP_ROWS][32 * P];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARP_ROWS + warp;
  if (r >= N) return;  // whole warps leave together
  const size_t o = (size_t)r * L;
  float* sv = s_val[warp];
  int16_t* sr = s_rank[warp];
  u64 k[P];
  float a_own[P];
#pragma unroll
  for (int g = 0; g < P; ++g) {
    const int i = lane + 32 * g;
    k[g] = PAD;
    a_own[g] = 0.f;
    if (i < L) {
      const bool m = mask[o + i] != 0;
      const float a = m ? clip01(alpha[o + i]) : 0.f;
      sv[i] = log1pf(-fminf(a, OCC_CAP));
      k[g] = sort_key(t[o + i], m, i);
      a_own[g] = a;
    }
  }
  warp_sort<P>(k, lane);
  __syncwarp();
  float v[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const unsigned i = (unsigned)k[q];  // pads: 0xffffffff
    v[q] = i < (unsigned)L ? sv[i] : 0.f;
  }
  warp_scan<P, false>(v, lane);
  __syncwarp();
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const unsigned i = (unsigned)k[q];
    if (i < (unsigned)L) {
      sv[i] = v[q];
      sr[i] = (int16_t)(lane * P + q);
    }
  }
  __syncwarp();
#pragma unroll
  for (int g = 0; g < P; ++g) {
    const int i = lane + 32 * g;
    if (i < L) {
      const float S = sv[i];
      vw[o + i] = a_own[g] * expf(S);
      if (logt != nullptr) logt[o + i] = S;
      if (rank != nullptr) rank[o + i] = sr[i];
    }
  }
}

template <int P>
__global__ void cross_source_vw_bwd_kernel(const uint8_t* __restrict__ mask, // [N, L]
                                           const float* __restrict__ alpha,  // [N, L]
                                           const float* __restrict__ logt,   // [N, L] S
                                           const int16_t* __restrict__ rank, // [N, L]
                                           const float* __restrict__ g_vw,   // [N, L]
                                           float* __restrict__ d_alpha,      // [N, L]
                                           int N, int L) {
  __shared__ float s_u[WARP_ROWS][32 * P];  // g vw by rank, then the sums after
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARP_ROWS + warp;
  if (r >= N) return;
  const size_t o = (size_t)r * L;
  float* su = s_u[warp];
  bool m[P];
  float x[P], gi[P], e[P];
  int rk[P];
#pragma unroll
  for (int g = 0; g < P; ++g) {
    const int i = lane + 32 * g;
    m[g] = false;
    x[g] = gi[g] = e[g] = 0.f;
    rk[g] = 0;
    if (i < L) {
      m[g] = mask[o + i] != 0;
      x[g] = alpha[o + i];
      e[g] = expf(logt[o + i]);
      gi[g] = g_vw[o + i];
      rk[g] = rank[o + i];
      su[rk[g]] = gi[g] * ((m[g] ? clip01(x[g]) : 0.f) * e[g]);  // g_i * vw_i
    }
  }
  __syncwarp();
  float v[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int s = lane * P + q;
    v[q] = s < L ? su[s] : 0.f;
  }
  warp_scan<P, true>(v, lane);
  __syncwarp();
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int s = lane * P + q;
    if (s < L) su[s] = v[q];
  }
  __syncwarp();
#pragma unroll
  for (int g = 0; g < P; ++g) {
    const int i = lane + 32 * g;
    if (i < L) d_alpha[o + i] = k8_grad(m[g], x[g], gi[g], e[g], m[g] ? su[rk[g]] : 0.f);
  }
}

// A block's exclusive sum of x over its threads in thread order;
// s_warp: BLOCK / 32 floats of shared memory.
__device__ __forceinline__ float block_exclusive(float x, float* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float wt = lane < BLOCK / 32 ? s_warp[lane] : 0.f;
    float wi = wt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(FULL, wi, d);
      if (lane >= d) wi += y;
    }
    float we = __shfl_up_sync(FULL, wi, 1);
    if (lane == 0) we = 0.f;
    if (lane < BLOCK / 32) s_warp[lane] = we;
  }
  __syncthreads();
  return s_warp[warp] + excl;
}

// Rows past 256 lanes: a block a ray, the keys sorted in shared memory by the
// same bitonic network over n2 (a power of two >= L) slots.
__global__ void __launch_bounds__(BLOCK)
cross_source_vw_block_kernel(const float* __restrict__ t, const uint8_t* __restrict__ mask,
                             const float* __restrict__ alpha, float* __restrict__ vw,
                             float* __restrict__ logt, int16_t* __restrict__ rank, int N, int L,
                             int n2) {
  extern __shared__ u64 s_key[];                      // [n2]
  float* s_val = reinterpret_cast<float*>(s_key + n2);  // [L]: log1ma, then S
  __shared__ float s_warp[BLOCK / 32];
  const int r = blockIdx.x, tid = threadIdx.x;
  const size_t o = (size_t)r * L;
  for (int i = tid; i < n2; i += BLOCK) {
    u64 key = PAD;
    if (i < L) {
      const bool m = mask[o + i] != 0;
      const float a = m ? clip01(alpha[o + i]) : 0.f;
      s_val[i] = log1pf(-fminf(a, OCC_CAP));
      key = sort_key(t[o + i], m, i);
    }
    s_key[i] = key;
  }
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < n2 / 2; p += BLOCK) {
        const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int hi = lo | j;
        const u64 x = s_key[lo], y = s_key[hi];
        if ((x > y) == ((lo & size) == 0)) {
          s_key[lo] = y;
          s_key[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  // thread tid owns the slots [tid c, tid c + c), c = n2 / BLOCK
  const int c = n2 / BLOCK, s0 = tid * c;
  float sum = 0.f;
  for (int q = 0; q < c; ++q) {
    const unsigned i = (unsigned)s_key[s0 + q];
    if (i < (unsigned)L) sum += s_val[i];
  }
  float run = block_exclusive(sum, s_warp);  // every read of s_val above is done
  for (int q = 0; q < c; ++q) {
    const unsigned i = (unsigned)s_key[s0 + q];
    if (i < (unsigned)L) {
      const float x = s_val[i];
      s_val[i] = run;
      if (rank != nullptr) rank[o + i] = (int16_t)(s0 + q);
      run += x;
    }
  }
  __syncthreads();
  for (int i = tid; i < L; i += BLOCK) {
    const bool m = mask[o + i] != 0;
    const float a = m ? clip01(alpha[o + i]) : 0.f;
    const float S = s_val[i];
    vw[o + i] = a * expf(S);
    if (logt != nullptr) logt[o + i] = S;
  }
}

__global__ void __launch_bounds__(BLOCK)
cross_source_vw_bwd_block_kernel(const uint8_t* __restrict__ mask,
                                 const float* __restrict__ alpha,
                                 const float* __restrict__ logt,
                                 const int16_t* __restrict__ rank,
                                 const float* __restrict__ g_vw, float* __restrict__ d_alpha,
                                 int N, int L) {
  extern __shared__ float s_u[];  // [L]: g vw by rank, then the sums after
  __shared__ float s_warp[BLOCK / 32];
  const int r = blockIdx.x, tid = threadIdx.x;
  const size_t o = (size_t)r * L;
  for (int i = tid; i < L; i += BLOCK) {
    const bool m = mask[o + i] != 0;
    const float a = m ? clip01(alpha[o + i]) : 0.f;
    s_u[rank[o + i]] = g_vw[o + i] * (a * expf(logt[o + i]));
  }
  __syncthreads();
  // thread tid owns the slots of chunk BLOCK - 1 - tid, so that the block's
  // exclusive sum in thread order is the sum over the slots after the chunk
  const int c = (L + BLOCK - 1) / BLOCK;
  const int s0 = (BLOCK - 1 - tid) * c, s1 = min(s0 + c, L);
  float sum = 0.f;
  for (int s = s0; s < s1; ++s) sum += s_u[s];
  float run = block_exclusive(sum, s_warp);
  for (int s = s1 - 1; s >= s0; --s) {
    const float x = s_u[s];
    s_u[s] = run;
    run += x;
  }
  __syncthreads();
  for (int i = tid; i < L; i += BLOCK) {
    const bool m = mask[o + i] != 0;
    d_alpha[o + i] = k8_grad(m, alpha[o + i], g_vw[o + i], expf(logt[o + i]),
                             m ? s_u[rank[o + i]] : 0.f);
  }
}

constexpr int MAX_WIDTH = 16384;  // ranks fit int16; a row's keys and values fit 227 KB

int next_pow2(int L) {
  int n = 1;
  while (n < L) n <<= 1;
  return n;
}

// Opt a kernel into more than 48 KB of shared memory where it needs it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  // the 48 KB default holds the static warp totals too
  if (bytes + BLOCK / 32 * sizeof(float) <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return e;
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int cross_source_vw(const void* t, const void* mask, const void* alpha, void* vw,
                               void* logt, void* rank, int N, int L, void* stream) {
  if (N < 0 || L < 1 || L > MAX_WIDTH) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float* tt = (const float*)t;
  const uint8_t* mm = (const uint8_t*)mask;
  const float* aa = (const float*)alpha;
  float* out = (float*)vw;
  float* lt = (float*)logt;
  int16_t* rk = (int16_t*)rank;
  const int blocks = (N + WARP_ROWS - 1) / WARP_ROWS;
  if (L <= 32)
    cross_source_vw_kernel<1><<<blocks, 32 * WARP_ROWS, 0, st>>>(tt, mm, aa, out, lt, rk, N, L);
  else if (L <= 64)
    cross_source_vw_kernel<2><<<blocks, 32 * WARP_ROWS, 0, st>>>(tt, mm, aa, out, lt, rk, N, L);
  else if (L <= 128)
    cross_source_vw_kernel<4><<<blocks, 32 * WARP_ROWS, 0, st>>>(tt, mm, aa, out, lt, rk, N, L);
  else if (L <= 256)
    cross_source_vw_kernel<8><<<blocks, 32 * WARP_ROWS, 0, st>>>(tt, mm, aa, out, lt, rk, N, L);
  else {
    const int n2 = next_pow2(L);
    const size_t smem = (size_t)n2 * sizeof(u64) + (size_t)L * sizeof(float);
    cudaError_t e = allow_smem(cross_source_vw_block_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    cross_source_vw_block_kernel<<<N, BLOCK, smem, st>>>(tt, mm, aa, out, lt, rk, N, L, n2);
  }
  return (int)cudaGetLastError();
}

extern "C" int cross_source_vw_bwd(const void* mask, const void* alpha, const void* logt,
                                   const void* rank, const void* g_vw, void* d_alpha, int N,
                                   int L, void* stream) {
  if (N < 0 || L < 1 || L > MAX_WIDTH) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* mm = (const uint8_t*)mask;
  const float* aa = (const float*)alpha;
  const float* lt = (const float*)logt;
  const int16_t* rk = (const int16_t*)rank;
  const float* gg = (const float*)g_vw;
  float* da = (float*)d_alpha;
  const int blocks = (N + WARP_ROWS - 1) / WARP_ROWS;
  if (L <= 32)
    cross_source_vw_bwd_kernel<1><<<blocks, 32 * WARP_ROWS, 0, st>>>(mm, aa, lt, rk, gg, da, N, L);
  else if (L <= 64)
    cross_source_vw_bwd_kernel<2><<<blocks, 32 * WARP_ROWS, 0, st>>>(mm, aa, lt, rk, gg, da, N, L);
  else if (L <= 128)
    cross_source_vw_bwd_kernel<4><<<blocks, 32 * WARP_ROWS, 0, st>>>(mm, aa, lt, rk, gg, da, N, L);
  else if (L <= 256)
    cross_source_vw_bwd_kernel<8><<<blocks, 32 * WARP_ROWS, 0, st>>>(mm, aa, lt, rk, gg, da, N, L);
  else {
    const size_t smem = (size_t)L * sizeof(float);
    cudaError_t e = allow_smem(cross_source_vw_bwd_block_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    cross_source_vw_bwd_block_kernel<<<N, BLOCK, smem, st>>>(mm, aa, lt, rk, gg, da, N, L);
  }
  return (int)cudaGetLastError();
}
