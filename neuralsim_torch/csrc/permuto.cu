// K9 permuto: the multi-level permutohedral-lattice hash encoding, its
// analytic jacobian, and its backward.
//
// Replaces: neuralsim_tpu/fields/encodings/permuto.py
//   _hash_keys (line 34), PermutoEncoding._simplex (100-181),
//   _level_features (183-214), reached through __call__ (216) and
//   with_jacobian (232).
//
// Per point n and level l (resolution res, table offset off, F features,
// first output row):
//   pos = x01[n] * res                                   (d coordinates)
//   elevate: sm = 0; for i = d..1: cf = pos[i-1] sf[i-1];
//            elev[i] = sm - i cf; sm += cf;  elev[0] = sm
//   round:   v = elev / (d+1); fl = floor(v)(d+1); ce = ceil(v)(d+1)
//            rem0 = (ce - elev < elev - fl) ? ce : fl
//            sum = (int)(sum_i rem0 / (d+1))
//   rank:    rank[i] = #{j>i: diff_i < diff_j} + #{j<i: diff_i <= diff_j} + sum,
//            diff = elev - rem0, wrapped into [0, d] (rem0 moves by d+1 with it)
//   bary:    diff' = (elev - rem0)/(d+1); with a(r) the index of rank d - r and
//            b(r) the index of rank d + 1 - r (rank 0 for r = 0):
//            bary[r] = diff'[a] - diff'[b]  (r >= 1);  bary[0] = diff'[a] + (1 - diff'[b])
//   keys:    vertex k, coordinate c < d: rem0[c] + (rank[c] >= d+1-k ? k-(d+1) : k)
//   row:     xor_c (uint32)key_c * prime[c % 8], modulo T (uint32 arithmetic)
//   out[row0 + f] = sum_k bary[k] * table[off + f T + row_k]
//   jac[c][row0 + f] = sum_k table[...] * (dbary[k][c] * res), c < 3, with
//            dbary[r][c] = (E[a][c] - E[b][c]) / (d+1) (r = 0: two products summed),
//            E the constant elevation matrix d(elev)/d(pos).
// The lattice part uses explicit _rn operations: the simplex (its vertices,
// hence the rows and the jacobian) depends on exact comparisons, and an FMA
// contraction of "sm - i cf" or "ce - elev" would choose another vertex near
// a face than the plain version does.
//
// The table keeps the JAX layout: a level's slab is [F, T], so a vertex's two
// features are two 4-byte gathers 2^17 floats apart (interleaving is later
// work). Output is feature-major, out [C, N] and jac [3, C, N].
//
// What bounds it on an H100: latency of the scattered row reads. Per point
// and level it reads (d+1) F floats from a level slab of 1 MB (T 2^17, F 2;
// twelve levels, 12.6 MB in all, fit in the 50 MB L2) and does O(d^2)
// compares and selects (ranks, vertex keys, the inverse permutation by
// selects so every array stays in registers). One thread per (point, level)
// in the forward; the level is blockIdx.y, so neighbouring threads take
// neighbouring points of one level and write neighbouring outputs.
//
// Backward (permuto_bwd), one thread per point walking the levels (it sums
// the levels into d x01 without atomics):
//   d table[off + f T + row_k] += bary[k] g_out[f] + res sum_c dbary[k][c] g_jac[c][f]
// as f32 atomicAdd in device memory (hash collisions and neighbouring points
// share rows, so the last bits vary from run to run), and
//   d x01[n][c] = sum_l res_l sum_k G_k dbary[k][c],  G_k = sum_f g_out[f] table[...]
// for all d columns (the latents' gradient of a conditional field comes
// through the columns past 3). The jacobian has no x gradient (the simplex is
// piecewise constant). What bounds it: the atomics' throughput in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ uint32_t kPrimes[8] = {1u, 2654435761u, 805459861u, 3674653429u,
                                    2097192037u, 1434869437u, 2165219737u, 2654435741u};
constexpr int JD = 3;  // jacobian columns (xyz)
constexpr int META = 3;  // table offset, F, first output row

// The lattice of one point at one level: simplex vertices' rows, barycentric
// weights, and the indices a(r), b(r) that give dbary (see the header).
template <int D>
struct Lattice {
  float bary[D + 1];
  uint32_t row[D + 1];
  int ia[D + 1], ib[D + 1];

  __device__ __forceinline__ void build(const float* pos, const float* sf, float down,
                                        uint32_t tmask) {
    const float up = (float)(D + 1);
    float elev[D + 1], rem0[D + 1];
    float sm = 0.f;
#pragma unroll
    for (int i = D; i >= 1; --i) {
      const float cf = __fmul_rn(pos[i - 1], sf[i - 1]);
      elev[i] = __fsub_rn(sm, __fmul_rn((float)i, cf));
      sm = __fadd_rn(sm, cf);
    }
    elev[0] = sm;
    float total = 0.f;
#pragma unroll
    for (int i = 0; i <= D; ++i) {
      const float v = __fmul_rn(elev[i], down);
      const float fl = __fmul_rn(floorf(v), up);
      const float ce = __fmul_rn(ceilf(v), up);
      rem0[i] = __fsub_rn(ce, elev[i]) < __fsub_rn(elev[i], fl) ? ce : fl;
      total = __fadd_rn(total, rem0[i]);  // integers: exact in any order
    }
    const int sum_val = (int)__fmul_rn(total, down);
    int rank[D + 1];
    float diff[D + 1];
#pragma unroll
    for (int i = 0; i <= D; ++i) diff[i] = __fsub_rn(elev[i], rem0[i]);
#pragma unroll
    for (int i = 0; i <= D; ++i) {
      int r = sum_val;
#pragma unroll
      for (int j = 0; j <= D; ++j) {
        if (j > i) r += diff[i] < diff[j];
        if (j < i) r += diff[i] <= diff[j];
      }
      if (r < 0) {
        r += D + 1;
        rem0[i] = __fadd_rn(rem0[i], up);
      } else if (r > D) {
        r -= D + 1;
        rem0[i] = __fsub_rn(rem0[i], up);
      }
      rank[i] = r;
    }
#pragma unroll
    for (int i = 0; i <= D; ++i) diff[i] = __fmul_rn(__fsub_rn(elev[i], rem0[i]), down);
#pragma unroll
    for (int r = 0; r <= D; ++r) {
      int a = 0, b = 0;
      float va = 0.f, vb = 0.f;
#pragma unroll
      for (int i = 0; i <= D; ++i) {
        if (rank[i] == D - r) { a = i; va = diff[i]; }
        if (rank[i] == (r == 0 ? 0 : D + 1 - r)) { b = i; vb = diff[i]; }
      }
      ia[r] = a;
      ib[r] = b;
      bary[r] = r == 0 ? __fadd_rn(va, __fsub_rn(1.f, vb)) : __fsub_rn(va, vb);
      // vertex r: its key, hashed
      uint32_t h = 0u;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const int off = rank[c] >= D + 1 - r ? r - (D + 1) : r;
        const int key = (int)__fadd_rn(rem0[c], (float)off);
        h ^= (uint32_t)key * kPrimes[c % 8];
      }
      row[r] = h & tmask;
    }
  }
};

// E[i][c] of the elevation matrix: sf[c] for c >= i, -(c+1) sf[c] for
// c == i - 1, else 0 (``diag`` holds the f32 values of -(c+1) sf[c]).
__device__ __forceinline__ float elev_entry(int i, int c, const float* sf, const float* diag) {
  return c >= i ? sf[c] : (c == i - 1 ? diag[c] : 0.f);
}

// dbary[r][c] exactly as JAX forms it: down * (E[a][c] - E[b][c]) for r >= 1,
// down * E[a][c] + down * (-E[b][c]) for r = 0.
__device__ __forceinline__ float dbary_entry(int r, int a, int b, int c, float down,
                                             const float* sf, const float* diag) {
  const float ea = elev_entry(a, c, sf, diag), eb = elev_entry(b, c, sf, diag);
  return r == 0 ? __fadd_rn(__fmul_rn(down, ea), __fmul_rn(down, -eb))
                : __fmul_rn(down, __fsub_rn(ea, eb));
}

// lat = sf [D], diag [D], down: the float32 values of the JAX constants
// (sf and diag computed in double, then rounded; down = f32(1 / (d+1))).
template <int D>
__device__ __forceinline__ float load_consts(const float* lat, float* sf, float* diag) {
#pragma unroll
  for (int c = 0; c < D; ++c) {
    sf[c] = __ldg(lat + c);
    diag[c] = __ldg(lat + D + c);
  }
  return __ldg(lat + 2 * D);
}

template <int D>
__global__ void permuto_fwd_kernel(const float* __restrict__ table,
                                   const float* __restrict__ x01,   // [N, D]
                                   const float* __restrict__ res,   // [L]
                                   const int* __restrict__ meta,    // [L, 3]
                                   const float* __restrict__ lat,   // [2 D + 1]
                                   float* __restrict__ out,         // [C, N]
                                   float* __restrict__ jac,         // [3, C, N] or null
                                   int N, int C, int T) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (n >= N) return;
  float sf[D], diag[D];
  const float down = load_consts<D>(lat, sf, diag);
  const float r = __ldg(res + l);
  const int off = __ldg(meta + l * META + 0);
  const int nf = __ldg(meta + l * META + 1);
  const int row0 = __ldg(meta + l * META + 2);
  float pos[D];
#pragma unroll
  for (int c = 0; c < D; ++c) pos[c] = __fmul_rn(__ldg(x01 + (size_t)n * D + c), r);
  Lattice<D> lt;
  lt.build(pos, sf, down, (uint32_t)(T - 1));
  float db[D + 1][JD];
  if (jac != nullptr) {
#pragma unroll
    for (int k = 0; k <= D; ++k)
#pragma unroll
      for (int c = 0; c < JD; ++c)
        db[k][c] = __fmul_rn(dbary_entry(k, lt.ia[k], lt.ib[k], c, down, sf, diag), r);
  }
  const size_t plane = (size_t)C * N;
  for (int f = 0; f < nf; ++f) {
    const float* tf = table + off + (size_t)f * T;
    float acc = 0.f, j0 = 0.f, j1 = 0.f, j2 = 0.f;
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      const float v = __ldg(tf + lt.row[k]);
      acc = __fadd_rn(acc, __fmul_rn(lt.bary[k], v));
      if (jac != nullptr) {
        j0 = __fadd_rn(j0, __fmul_rn(v, db[k][0]));
        j1 = __fadd_rn(j1, __fmul_rn(v, db[k][1]));
        j2 = __fadd_rn(j2, __fmul_rn(v, db[k][2]));
      }
    }
    const size_t o = (size_t)(row0 + f) * N + n;
    out[o] = acc;
    if (jac != nullptr) {
      jac[o] = j0;
      jac[plane + o] = j1;
      jac[2 * plane + o] = j2;
    }
  }
}

template <int D>
__global__ void permuto_bwd_kernel(const float* __restrict__ table,
                                   const float* __restrict__ x01,    // [N, D]
                                   const float* __restrict__ res,    // [L]
                                   const int* __restrict__ meta,     // [L, 3]
                                   const float* __restrict__ lat,    // [2 D + 1]
                                   const float* __restrict__ d_out,  // [C, N] or null
                                   const float* __restrict__ d_jac,  // [3, C, N] or null
                                   float* __restrict__ d_table,      // flat, zeroed
                                   float* __restrict__ d_x,          // [N, D] or null
                                   int N, int L, int C, int T) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float sf[D], diag[D];
  const float down = load_consts<D>(lat, sf, diag);
  const size_t plane = (size_t)C * N;
  float x[D], dx[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    x[c] = __ldg(x01 + (size_t)n * D + c);
    dx[c] = 0.f;
  }
  for (int l = 0; l < L; ++l) {
    const float r = __ldg(res + l);
    const int off = __ldg(meta + l * META + 0);
    const int nf = __ldg(meta + l * META + 1);
    const int row0 = __ldg(meta + l * META + 2);
    float pos[D];
#pragma unroll
    for (int c = 0; c < D; ++c) pos[c] = __fmul_rn(x[c], r);
    Lattice<D> lt;
    lt.build(pos, sf, down, (uint32_t)(T - 1));
    float db[D + 1][JD];
#pragma unroll
    for (int k = 0; k <= D; ++k)
#pragma unroll
      for (int c = 0; c < JD; ++c)
        db[k][c] = __fmul_rn(dbary_entry(k, lt.ia[k], lt.ib[k], c, down, sf, diag), r);
    float G[D + 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) G[k] = 0.f;
    for (int f = 0; f < nf; ++f) {
      const size_t o = (size_t)(row0 + f) * N + n;
      const float go = d_out != nullptr ? __ldg(d_out + o) : 0.f;
      float g0 = 0.f, g1 = 0.f, g2 = 0.f;
      if (d_jac != nullptr) {
        g0 = __ldg(d_jac + o);
        g1 = __ldg(d_jac + plane + o);
        g2 = __ldg(d_jac + 2 * plane + o);
      }
      float* gt = d_table + off + (size_t)f * T;
      const float* tf = table + off + (size_t)f * T;
#pragma unroll
      for (int k = 0; k <= D; ++k) {
        atomicAdd(gt + lt.row[k], lt.bary[k] * go + db[k][0] * g0 + db[k][1] * g1
                                      + db[k][2] * g2);
        if (d_x != nullptr && d_out != nullptr) G[k] += go * __ldg(tf + lt.row[k]);
      }
    }
    if (d_x != nullptr) {
      // d pos[c] = sum_k G_k dbary[k][c] over all d columns; d x01 = res d pos
#pragma unroll
      for (int k = 0; k <= D; ++k) {
        const float g = G[k] * r;
#pragma unroll
        for (int c = 0; c < D; ++c)
          dx[c] += g * dbary_entry(k, lt.ia[k], lt.ib[k], c, down, sf, diag);
      }
    }
  }
  if (d_x != nullptr) {
#pragma unroll
    for (int c = 0; c < D; ++c) d_x[(size_t)n * D + c] = dx[c];
  }
}

template <int D>
int launch_fwd(const float* table, const float* x01, const float* res, const int* meta,
               const float* lat, float* out, float* jac, int N, int L, int C, int T,
               cudaStream_t stream) {
  const int threads = 128;
  dim3 grid((N + threads - 1) / threads, L);
  if (N > 0 && L > 0)
    permuto_fwd_kernel<D><<<grid, threads, 0, stream>>>(table, x01, res, meta, lat, out, jac,
                                                        N, C, T);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const float* table, const float* x01, const float* res, const int* meta,
               const float* lat, const float* d_out, const float* d_jac, float* d_table,
               float* d_x, int N, int L, int C, int T, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (N + threads - 1) / threads;
  if (N > 0)
    permuto_bwd_kernel<D><<<blocks, threads, 0, stream>>>(table, x01, res, meta, lat, d_out,
                                                          d_jac, d_table, d_x, N, L, C, T);
  return (int)cudaGetLastError();
}

}  // namespace

// lat: the lattice constants of width D (see load_consts), float32 [2 D + 1].
extern "C" int permuto_fwd(const void* table, const void* x01, const void* res,
                           const void* meta, const void* lat, void* out, void* jac, int N,
                           int D, int L, int C, int T, void* stream) {
  const auto* t = (const float*)table;
  const auto* x = (const float*)x01;
  const auto* r = (const float*)res;
  const auto* m = (const int*)meta;
  const auto* k = (const float*)lat;
  auto s = (cudaStream_t)stream;
  switch (D) {
    case 3: return launch_fwd<3>(t, x, r, m, k, (float*)out, (float*)jac, N, L, C, T, s);
    case 4: return launch_fwd<4>(t, x, r, m, k, (float*)out, (float*)jac, N, L, C, T, s);
    case 7: return launch_fwd<7>(t, x, r, m, k, (float*)out, (float*)jac, N, L, C, T, s);
    case 11: return launch_fwd<11>(t, x, r, m, k, (float*)out, (float*)jac, N, L, C, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int permuto_bwd(const void* table, const void* x01, const void* res,
                           const void* meta, const void* lat, const void* d_out,
                           const void* d_jac, void* d_table, void* d_x, int N, int D, int L,
                           int C, int T, void* stream) {
  const auto* t = (const float*)table;
  const auto* x = (const float*)x01;
  const auto* r = (const float*)res;
  const auto* m = (const int*)meta;
  const auto* k = (const float*)lat;
  const auto* go = (const float*)d_out;
  const auto* gj = (const float*)d_jac;
  auto s = (cudaStream_t)stream;
  switch (D) {
    case 3: return launch_bwd<3>(t, x, r, m, k, go, gj, (float*)d_table, (float*)d_x, N, L, C,
                                 T, s);
    case 4: return launch_bwd<4>(t, x, r, m, k, go, gj, (float*)d_table, (float*)d_x, N, L, C,
                                 T, s);
    case 7: return launch_bwd<7>(t, x, r, m, k, go, gj, (float*)d_table, (float*)d_x, N, L, C,
                                 T, s);
    case 11: return launch_bwd<11>(t, x, r, m, k, go, gj, (float*)d_table, (float*)d_x, N, L,
                                   C, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
