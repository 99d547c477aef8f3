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
//   bary:    diff' = (elev - rem0)/(d+1), sorted by vertex: s[d - rank[i]] = diff'[i];
//            bary[r] = s[r] - s[r-1] (r >= 1);  bary[0] = s[0] + (1 - s[d])
//   keys:    vertex k, coordinate c < d: rem0[c] + (rank[c] >= d+1-k ? k-(d+1) : k)
//   row:     xor_c (uint32)key_c * prime[c % 8], modulo T (uint32 arithmetic)
//   out[n][row0 + f] = sum_k bary[k] * table[level l, row_k, f]
//   jac[n][row0 + f][c] = sum_k table[...] * (dbary[k][c] * res), c < 3, with
//            dbary[k][c] = (E[a(k)][c] - E[a(k-1)][c]) / (d+1) (k = 0: two products
//            summed, a(-1) = a(d)), a(k) the coordinate of rank d - k and E the
//            constant elevation matrix d(elev)/d(pos); for c < 3 only E's rows
//            0..3 are non-zero, so a vertex's E row is chosen by four compares.
// Every operation that decides a vertex, a row or a weight is an explicit _rn
// operation in the plain version's order (an FMA contraction of "sm - i cf"
// or "ce - elev" would choose another vertex near a face), so the forward is
// bit-equal to the plain version; only integer work and exact float work were
// reordered: the ranks count each pair once (rank[i] += c, rank[j] -= c with
// rank[j] starting at j), the keys are integers from rem0 (an exact integer)
// hashed in uint32, and the weights are read back sorted from a per-lane
// column of shared memory in place of a search over the ranks.
//
// Layouts. The parameter keeps the JAX layout, a level's slab [F, T]. Each
// call first copies it into an interleaved scratch, [T, F] per level
// (permuto_layout_kernel), so a vertex's F = 2 features are one 8-byte load
// in place of two loads 2^17 floats apart. Outputs are point-major, out
// [N, C] and jac [N, C, 3], as the encoding hands them on: a block of 32
// points stages its rows in shared memory and writes them coalesced (above
// kStageMax bytes of staging, a lane writes its rows itself).
//
// What bounds it on an H100. The lattice is O(d^2) compare, integer and
// select work a point and level (ranks, keys, the wrap: ~1,400 instructions
// at d 11, most of them in the half-rate integer/logic pipe; the ranks and
// the jacobian's E rows are counted with FMA-pipe adds to relieve it), and
// the d+1 gathers of a level are issued together (one unrolled batch, no
// branch between them) into a 12.6 MB table that lives in the 50 MB L2.
// On scattered points the gathers are L2 sectors (one 32-byte sector a
// vertex), on a ray's depth-sorted samples mostly L1 hits. The compulsory
// bytes (x01, the table, the outputs) take ~0.03 ms at [196,608, 11]. The
// lattice constants reach the kernels by value (the constant bank, no
// registers). A block is 32 neighbouring points x 4 warps; warp w takes
// levels w, w + 4, ..., so a warp's lanes walk one level over neighbouring
// samples and share rows in L1 at the coarse levels.
//
// Backward (permuto_bwd), the same blocks:
//   d table[level l, row_k, f] += bary[k] g_out[f] + res sum_c dbary[k][c] g_jac[f][c]
// into an interleaved zeroed scratch, then copied back into the JAX layout:
// the lanes of a warp that hold a run of equal rows of a vertex sum their
// values by shuffles (warp_runs.cuh, as K1-K3's backwards do), and the run's
// first lane adds one float2 device atomic (F = 2; one a float otherwise).
// A warp's lanes are neighbouring samples of a ray in training, which share
// rows at the coarse levels: the runs take ~15% off the backward there on
// an H100 and cost nothing measurable on scattered points. The
// jacobian's part is res down (E[a(k)] - E[a(k-1)]) . g_jac[f], from four
// dot products a level (E's rows 0..3). And
//   d pos[c] = (1/(d+1)) sum_i E[i][c] H_i,  H_i = G[v_i] - G[v_i + 1 mod d+1],
//   G_k = sum_f g_out[f] table[...], v_i = d - rank[i]
// (= sum_k G_k dbary[k][c], regrouped by E's rows: E[i][c] = sf[c] for
// i <= c and diag[c] for i = c + 1, a prefix sum), d x01 = res d pos, for
// all d columns (the latents' gradient of a conditional field comes through
// the columns past 3). A lane sums its levels in shared memory (registers
// are scarce), the warps are added in warp order: d x01 is deterministic
// and takes no atomics. The jacobian has no x gradient (the simplex is
// piecewise constant). What bounds it: L2, the gathers for G and the
// atomics (one sector each a vertex on scattered points), beside the
// lattice.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_runs.cuh"

namespace {

constexpr int JD = 3;            // jacobian columns (xyz)
constexpr int META = 3;          // table offset, F, first output row
constexpr int kWarps = 4;        // a block's warps; warp w takes levels w, w + kWarps, ...
constexpr int kThreads = 32 * kWarps;
constexpr int kStageMax = 160 * 1024;  // shared memory for staged rows, at most

__host__ __device__ constexpr uint32_t prime(int c) {
  return c == 0 ? 1u : c == 1 ? 2654435761u : c == 2 ? 805459861u : c == 3 ? 3674653429u
       : c == 4 ? 2097192037u : c == 5 ? 1434869437u : c == 6 ? 2165219737u : 2654435741u;
}

// The lattice constants of width D, as the float32 values of the JAX
// constants: sf and diag computed in double, then rounded; down = f32(1 /
// (d+1)). A kernel takes them by value, so its instructions read them from
// the constant bank and no register holds them.
template <int D>
struct Lat {
  float sf[D], diag[D], down;
};

template <int D>
Lat<D> lattice_consts() {
  Lat<D> k;
  const double inv_std = sqrt(2.0 / 3.0) * (D + 1);
  for (int i = 0; i < D; ++i) {
    const double sf = 1.0 / sqrt((double)((i + 1) * (i + 2))) * inv_std;
    k.sf[i] = (float)sf;
    k.diag[i] = (float)(-(i + 1) * sf);
  }
  k.down = (float)(1.0 / (D + 1));
  return k;
}

// 1.0f where a < b, else 0.0f (FSET: one compare, no select)
__device__ __forceinline__ float lt01(float a, float b) {
  float r;
  asm("set.lt.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The simplex of one point at one level: its vertices' rows and barycentric
// weights, and v[i] = d - rank[i], the vertex at which elevated coordinate i
// enters the weights with a plus sign (the jacobian's and d x01's E rows).
template <int D>
struct Simplex {
  float bary[D + 1];
  uint32_t row[D + 1];
  int v[D + 1];
  float vf[JD + 1];  // v[0..3] as floats (the jacobian's E rows)
};

// sd: this lane's column of a [D+1][32] float scratch in shared memory.
template <int D>
__device__ __forceinline__ void build_simplex(Simplex<D>& s, const float (&x)[D], float res,
                                              const Lat<D>& K, uint32_t tmask, float* sd) {
  const float down = K.down;
  const float up = (float)(D + 1);
  float elev[D + 1];
  float sm = 0.f;
#pragma unroll
  for (int i = D; i >= 1; --i) {
    const float cf = __fmul_rn(__fmul_rn(x[i - 1], res), K.sf[i - 1]);
    elev[i] = __fsub_rn(sm, __fmul_rn((float)i, cf));
    sm = __fadd_rn(sm, cf);
  }
  elev[0] = sm;
  float rem0[D + 1];
  float total = 0.f;
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    const float v = __fmul_rn(elev[i], down);
    const float fl = __fmul_rn(floorf(v), up);
    const float ce = __fmul_rn(ceilf(v), up);
    rem0[i] = __fsub_rn(ce, elev[i]) < __fsub_rn(elev[i], fl) ? ce : fl;
    total = __fadd_rn(total, rem0[i]);  // integers: exact in any order
  }
  // (int) truncates; the sum is a small integer (the elevated point lies on
  // the sum-zero plane), kept as a float
  const float sum_val = truncf(__fmul_rn(total, down));
  // rank[i] = sum + #{j>i: diff_i < diff_j} + #{j<i: diff_i <= diff_j}: one
  // compare a pair, its complement counted for j by starting rank[j] at j;
  // counted in floats (small integers, exact), so that the adds run in the
  // FMA pipe beside the compares
  float diff[D + 1], rk[D + 1];
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    diff[i] = __fsub_rn(elev[i], rem0[i]);
    rk[i] = (float)i;
  }
#pragma unroll
  for (int i = 0; i <= D; ++i)
#pragma unroll
    for (int j = i + 1; j <= D; ++j) {
      const float c = lt01(diff[i], diff[j]);
      rk[i] += c;
      rk[j] -= c;
    }
  // ranks, wrap and vertex indices stay in floats (small integers, exact)
  float rank[D + 1];
  uint32_t base[D];
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    // the wrap by one select (rem0 - up is rem0 + (-up), bit for bit)
    const float r0 = rk[i] + sum_val;
    const float wrap = r0 < 0.f ? up : (r0 > (float)D ? -up : 0.f);
    rank[i] = r0 + wrap;
    const float rm = __fadd_rn(rem0[i], wrap);
    const float vf = (float)D - rank[i];
    if (i <= JD) s.vf[i] = vf;
    // d - rank is in [0, d] for any finite input; clamped so that no input
    // can write past the column (the float's integer by its mantissa bits)
    const int q = (int)min((unsigned)(__float_as_int(vf + 8388608.f) - 0x4B000000), (unsigned)D);
    s.v[i] = q;
    sd[q * 32] = __fmul_rn(__fsub_rn(elev[i], rm), down);
    if (i < D) base[i] = (uint32_t)(int)rm * prime(i % 8);
  }
  // vertex k's key c: rem0[c] + k, less d+1 where rank[c] >= d+1-k; hashed
  // term by term in uint32 (k * prime is a constant)
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    uint32_t h = 0u;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      uint32_t t = base[c] + (uint32_t)k * prime(c % 8);
      if (rank[c] >= (float)(D + 1 - k)) t -= (uint32_t)(D + 1) * prime(c % 8);
      h ^= t;
    }
    s.row[k] = h & tmask;
  }
  float srt[D + 1];
#pragma unroll
  for (int q = 0; q <= D; ++q) srt[q] = sd[q * 32];
  s.bary[0] = __fadd_rn(srt[0], __fsub_rn(1.f, srt[D]));
#pragma unroll
  for (int q = 1; q <= D; ++q) s.bary[q] = __fsub_rn(srt[q], srt[q - 1]);
}

// 1.0f where the small integer v equals k, else 0.0f (two FMA-pipe adds)
__device__ __forceinline__ float eq01(float v, int k) {
  return __saturatef(1.f - fabsf(v - (float)k));
}

// E[a(k)][c], c < 3, for vertex k: E's row 0 is sf, row i has sf[c] for
// c >= i and diag[c] = -(c+1) sf[c] at c = i - 1, so rows past 3 are zero in
// the first three columns. At most one of p0..p3 is 1: each sum below has one
// non-zero term and is exact.
template <int D>
__device__ __forceinline__ void e_row(int k, const Simplex<D>& s, const Lat<D>& K,
                                      float (&e)[JD]) {
  const float p0 = eq01(s.vf[0], k), p1 = eq01(s.vf[1], k), p2 = eq01(s.vf[2], k),
              p3 = eq01(s.vf[3], k);
  const float p01 = p0 + p1;
  e[0] = fmaf(p1, K.diag[0], p0 * K.sf[0]);
  e[1] = fmaf(p2, K.diag[1], p01 * K.sf[1]);
  e[2] = fmaf(p3, K.diag[2], (p01 + p2) * K.sf[2]);
}

// dbary[k][c] * res as the plain version forms it: down * (ea - eb) for
// k >= 1, down * ea + down * (-eb) for k = 0.
__device__ __forceinline__ void dbary_res(int k, const float (&ea)[JD], const float (&eb)[JD],
                                          float down, float res, float (&db)[JD]) {
#pragma unroll
  for (int c = 0; c < JD; ++c) {
    const float v = k == 0 ? __fadd_rn(__fmul_rn(down, ea[c]), __fmul_rn(down, -eb[c]))
                           : __fmul_rn(down, __fsub_rn(ea[c], eb[c]));
    db[c] = __fmul_rn(v, res);
  }
}

// Two features (the second only where ``two``) of every vertex's row, at
// p + row * nf: all d+1 gathers issued before any is used. ``vec``: one
// 8-byte load a vertex (F even, the level 8-byte aligned).
template <int D>
__device__ __forceinline__ void gather(const float* p, const uint32_t (&row)[D + 1], int nf,
                                       bool vec, bool two, float (&a)[D + 1],
                                       float (&b)[D + 1]) {
  if (vec) {
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p + row[k] * nf));
      a[k] = t.x;
      b[k] = t.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      a[k] = __ldg(p + row[k] * nf);
      b[k] = two ? __ldg(p + row[k] * nf + 1) : 0.f;
    }
  }
}

// The point-major row strides of the staged outputs: odd, so the lanes of a
// warp (one point each) write different banks.
__host__ __device__ __forceinline__ int odd(int n) { return n | 1; }

template <int D>
__host__ __device__ constexpr int lattice_floats() {
  return 32 * (D | 1) + kWarps * (D + 1) * 32;  // x01 [32][D|1], sorted weights [W][D+1][32]
}

template <int D, bool JAC>
__global__ void __launch_bounds__(kThreads, 4)
permuto_fwd_kernel(const float* __restrict__ tbl,   // interleaved: [T, F] per level
                   const float* __restrict__ x01,   // [N, D]
                   const float* __restrict__ res,   // [L]
                   const int* __restrict__ meta,    // [L, 3]
                   const Lat<D> K,
                   float* __restrict__ out,         // [N, C]
                   float* __restrict__ jac,         // [N, C, 3] (JAC)
                   int N, int L, int C, int T, int staged) {
  extern __shared__ float smem[];
  constexpr int XS = D | 1;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n0 = blockIdx.x * 32;
  const int np = min(32, N - n0);
  float* s_x = smem;
  float* sd = smem + 32 * XS + w * (D + 1) * 32 + lane;
  float* s_out = smem + lattice_floats<D>();
  const int os = odd(C), js = odd(JD * C);
  float* s_jac = s_out + 32 * os;
  for (int i = threadIdx.x; i < np * D; i += kThreads)
    s_x[(i / D) * XS + i % D] = __ldg(x01 + (size_t)n0 * D + i);
  __syncthreads();
  const bool valid = lane < np;
  float x[D];
#pragma unroll
  for (int c = 0; c < D; ++c) x[c] = valid ? s_x[lane * XS + c] : 0.f;
  float* o = staged ? s_out + lane * os : out + (size_t)(n0 + lane) * C;
  float* oj = staged ? s_jac + lane * js : (JAC ? jac + (size_t)(n0 + lane) * JD * C : nullptr);
  const bool write = staged || valid;
  for (int l = w; l < L; l += kWarps) {
    const float r = __ldg(res + l);
    const int off = __ldg(meta + l * META + 0);
    const int nf = __ldg(meta + l * META + 1);
    const int row0 = __ldg(meta + l * META + 2);
    Simplex<D> s;
    build_simplex<D>(s, x, r, K, (uint32_t)(T - 1), sd);
    const bool vec = ((off | nf) & 1) == 0;
    for (int f0 = 0; f0 < nf; f0 += 2) {
      const bool two = nf - f0 >= 2;
      float va[D + 1], vb[D + 1];
      gather<D>(tbl + off + f0, s.row, nf, vec, two, va, vb);
      float a0 = 0.f, a1 = 0.f, j0[JD], j1[JD], ea[JD], eb[JD], db[JD];
      if (JAC) e_row<D>(D, s, K, eb);
#pragma unroll
      for (int k = 0; k <= D; ++k) {
        const float v0 = va[k], v1 = vb[k];
        const float b0 = __fmul_rn(s.bary[k], v0), b1 = __fmul_rn(s.bary[k], v1);
        a0 = k == 0 ? b0 : __fadd_rn(a0, b0);
        a1 = k == 0 ? b1 : __fadd_rn(a1, b1);
        if (JAC) {
          e_row<D>(k, s, K, ea);
          dbary_res(k, ea, eb, K.down, r, db);
#pragma unroll
          for (int c = 0; c < JD; ++c) {
            const float m0 = __fmul_rn(v0, db[c]), m1 = __fmul_rn(v1, db[c]);
            j0[c] = k == 0 ? m0 : __fadd_rn(j0[c], m0);
            j1[c] = k == 0 ? m1 : __fadd_rn(j1[c], m1);
            eb[c] = ea[c];
          }
        }
      }
      if (write) {
        o[row0 + f0] = a0;
        if (two) o[row0 + f0 + 1] = a1;
        if (JAC) {
#pragma unroll
          for (int c = 0; c < JD; ++c) {
            oj[(row0 + f0) * JD + c] = j0[c];
            if (two) oj[(row0 + f0 + 1) * JD + c] = j1[c];
          }
        }
      }
    }
  }
  if (staged) {
    __syncthreads();
    for (int i = threadIdx.x; i < np * C; i += kThreads)
      out[(size_t)n0 * C + i] = s_out[(i / C) * os + i % C];
    if (JAC)
      for (int i = threadIdx.x; i < np * JD * C; i += kThreads)
        jac[(size_t)n0 * JD * C + i] = s_jac[(i / (JD * C)) * js + i % (JD * C)];
  }
}

// sum_c E[i][c] q[c], c < 3, for E's rows i = 0..3 (the others are zero
// there)
template <int D>
__device__ __forceinline__ void e_dots(const Lat<D>& K, const float (&q)[JD], float (&P)[JD + 1]) {
  const float tail = K.sf[1] * q[1] + K.sf[2] * q[2];
  P[0] = K.sf[0] * q[0] + tail;
  P[1] = K.diag[0] * q[0] + tail;
  P[2] = K.diag[1] * q[1] + K.sf[2] * q[2];
  P[3] = K.diag[2] * q[2];
}

// E[a(k)] . q for vertex k, from e_dots: one of p0..p3 is 1 where a(k) <= 3
template <int D>
__device__ __forceinline__ float e_dot(int k, const Simplex<D>& s, const float (&P)[JD + 1]) {
  return eq01(s.vf[0], k) * P[0] + eq01(s.vf[1], k) * P[1] + eq01(s.vf[2], k) * P[2] +
         eq01(s.vf[3], k) * P[3];
}

// The table's gradient at one level and pair of features, vertex by vertex:
// bary[k] (o0, o1) plus, with the jacobian's cotangent (JAC), res dbary[k]
// . (q0, q1) = res down (E[a(k)] - E[a(k-1)]) . (q0, q1). The lanes of the
// warp holding a run of equal rows sum their values by shuffles, and the
// run's first lane adds them at p + row[k] nf with one float2 device atomic
// (sm_90) where VEC (both features, 8-byte aligned), else one a value. The
// cases are template parameters, so no branch splits the unrolled loop.
// Every lane of the warp takes part.
template <int D, bool JAC, bool VEC>
__device__ __forceinline__ void add_vertices(float* p, const Simplex<D>& s, const Lat<D>& K,
                                             int nf, float r, float o0, float o1,
                                             const float (&q0)[JD], const float (&q1)[JD],
                                             bool valid, bool two, int lane) {
  float P0[JD + 1], P1[JD + 1], b0 = 0.f, b1 = 0.f;
  const float rd = r * K.down;
  if (JAC) {
    e_dots<D>(K, q0, P0);
    e_dots<D>(K, q1, P1);
    b0 = e_dot<D>(D, s, P0);
    b1 = e_dot<D>(D, s, P1);
  }
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    float t0 = s.bary[k] * o0, t1 = s.bary[k] * o1;
    if (JAC) {
      const float a0 = e_dot<D>(k, s, P0), a1 = e_dot<D>(k, s, P1);
      t0 += rd * (a0 - b0);
      t1 += rd * (a1 - b1);
      b0 = a0;
      b1 = a1;
    }
    const Runs runs = warp_runs<1>(valid ? (int)s.row[k] : -1, lane);
    float t[2] = {t0, t1};
    run_sum<1, 2>(runs, t);
    float* dst = p + s.row[k] * nf;
    if (VEC) {
      if (valid && runs.head) atomicAdd(reinterpret_cast<float2*>(dst), make_float2(t[0], t[1]));
    } else {
      if (valid && runs.head) atomicAdd(dst, t[0]);
      if (valid && runs.head && two) atomicAdd(dst + 1, t[1]);
    }
  }
}

template <int D, bool JAC>
__global__ void __launch_bounds__(kThreads, 4)
permuto_bwd_kernel(const float* __restrict__ tbl,    // interleaved, or null (no d x01 from d_out)
                   const float* __restrict__ x01,    // [N, D]
                   const float* __restrict__ res,    // [L]
                   const int* __restrict__ meta,     // [L, 3]
                   const Lat<D> K,
                   const float* __restrict__ d_out,  // [N, C] or null
                   const float* __restrict__ d_jac,  // [N, C, 3] (JAC) or null
                   float* __restrict__ g_tbl,        // interleaved, zeroed
                   float* __restrict__ d_x,          // [N, D] or null
                   int N, int L, int C, int T, int staged) {
  extern __shared__ float smem[];
  constexpr int XS = D | 1;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n0 = blockIdx.x * 32;
  const int np = min(32, N - n0);
  float* s_x = smem;
  float* sd = smem + 32 * XS + w * (D + 1) * 32 + lane;  // this lane's [D+1] column
  float* s_dx = smem + lattice_floats<D>();              // [W][D][32]: d x01 by warp
  float* sdx = s_dx + w * D * 32 + lane;
  float* s_go = s_dx + kWarps * D * 32;
  const int os = odd(C), js = odd(JD * C);
  float* s_gj = s_go + 32 * os;
  for (int i = threadIdx.x; i < np * D; i += kThreads)
    s_x[(i / D) * XS + i % D] = __ldg(x01 + (size_t)n0 * D + i);
  if (staged) {
    if (d_out != nullptr)
      for (int i = threadIdx.x; i < np * C; i += kThreads)
        s_go[(i / C) * os + i % C] = __ldg(d_out + (size_t)n0 * C + i);
    if (JAC)
      for (int i = threadIdx.x; i < np * JD * C; i += kThreads)
        s_gj[(i / (JD * C)) * js + i % (JD * C)] = __ldg(d_jac + (size_t)n0 * JD * C + i);
  }
  __syncthreads();
  const bool valid = lane < np;
  // x01 and the lane's d x01 stay in shared memory (registers are scarce here)
#pragma unroll
  for (int c = 0; c < D; ++c) sdx[c * 32] = 0.f;
  // this lane's cotangent rows (read only where valid)
  const float* go = d_out == nullptr ? nullptr
                    : staged         ? s_go + lane * os
                                     : d_out + (size_t)(n0 + lane) * C;
  const float* gj = !JAC ? nullptr : staged ? s_gj + lane * js
                                           : d_jac + (size_t)(n0 + lane) * JD * C;
  const bool need_g = d_x != nullptr && go != nullptr && tbl != nullptr;
  for (int l = w; l < L; l += kWarps) {
    const float r = __ldg(res + l);
    const int off = __ldg(meta + l * META + 0);
    const int nf = __ldg(meta + l * META + 1);
    const int row0 = __ldg(meta + l * META + 2);
    float x[D];
#pragma unroll
    for (int c = 0; c < D; ++c) x[c] = valid ? s_x[lane * XS + c] : 0.f;
    Simplex<D> s;
    build_simplex<D>(s, x, r, K, (uint32_t)(T - 1), sd);
    const bool vec = ((off | nf) & 1) == 0;
    float G[D + 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) G[k] = 0.f;
    for (int f0 = 0; f0 < nf; f0 += 2) {
      const bool two = nf - f0 >= 2;
      float o0 = 0.f, o1 = 0.f, q0[JD] = {0.f, 0.f, 0.f}, q1[JD] = {0.f, 0.f, 0.f};
      if (valid && go != nullptr) {
        o0 = go[row0 + f0];
        o1 = two ? go[row0 + f0 + 1] : 0.f;
      }
      if (JAC && valid) {
#pragma unroll
        for (int c = 0; c < JD; ++c) {
          q0[c] = gj[(row0 + f0) * JD + c];
          q1[c] = two ? gj[(row0 + f0 + 1) * JD + c] : 0.f;
        }
      }
      if (need_g) {
        float va[D + 1], vb[D + 1];
        gather<D>(tbl + off + f0, s.row, nf, vec, two, va, vb);
#pragma unroll
        for (int k = 0; k <= D; ++k) G[k] += o0 * va[k] + o1 * vb[k];
      }
      float* p = g_tbl + off + f0;
      if (vec) add_vertices<D, JAC, true>(p, s, K, nf, r, o0, o1, q0, q1, valid, two, lane);
      else add_vertices<D, JAC, false>(p, s, K, nf, r, o0, o1, q0, q1, valid, two, lane);
    }
    if (d_x != nullptr) {
      // H_i = G[v_i] - G[v_i + 1], by a column of differences in the scratch
      // (the sorted weights were read back already)
#pragma unroll
      for (int q = 0; q <= D; ++q) sd[q * 32] = G[q] - G[q == D ? 0 : q + 1];
      float H[D + 1];
#pragma unroll
      for (int i = 0; i <= D; ++i) H[i] = sd[s.v[i] * 32];
      const float rd = r * K.down;
      float S = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        S += H[c];
        sdx[c * 32] += rd * (K.sf[c] * S + K.diag[c] * H[c + 1]);
      }
    }
  }
  if (d_x != nullptr) {
    // the warps' sums added in warp order: deterministic
    __syncthreads();
    for (int i = threadIdx.x; i < np * D; i += kThreads) {
      const int p = i / D, c = i % D;
      float acc = 0.f;
      for (int v = 0; v < kWarps; ++v) acc += s_dx[v * D * 32 + c * 32 + p];
      d_x[(size_t)n0 * D + i] = acc;
    }
  }
}

// Level slabs between the JAX layout [F, T] and the interleaved [T, F]
// (to_i: JAX -> interleaved). One thread a row of a level.
__global__ void permuto_layout_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                      const int* __restrict__ meta, int T, int to_i) {
  const int l = blockIdx.y;
  const int off = __ldg(meta + l * META + 0);
  const int nf = __ldg(meta + l * META + 1);
  const bool pair = nf == 2 && (off & 1) == 0;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < T; t += gridDim.x * blockDim.x) {
    if (pair && to_i) {
      *reinterpret_cast<float2*>(dst + off + 2 * t) =
          make_float2(__ldg(src + off + t), __ldg(src + off + T + t));
    } else if (pair) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(src + off + 2 * t));
      dst[off + t] = v.x;
      dst[off + T + t] = v.y;
    } else {
      for (int f = 0; f < nf; ++f) {
        if (to_i) dst[off + t * nf + f] = __ldg(src + off + f * T + t);
        else dst[off + f * T + t] = __ldg(src + off + t * nf + f);
      }
    }
  }
}

int launch_layout(const float* src, float* dst, const int* meta, int L, int T, int to_i,
                  cudaStream_t stream) {
  const int threads = 256;
  dim3 grid(min((T + threads - 1) / threads, 1024), L);
  permuto_layout_kernel<<<grid, threads, 0, stream>>>(src, dst, meta, T, to_i);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a launch: the lattice scratch, and the staged
// rows where they fit under kStageMax (staged = 1). Above 48 KB the kernel
// is given the opt-in size first.
template <typename K>
int smem_for(K kernel, int base_floats, int stage_floats, int& staged) {
  const int stage = (base_floats + stage_floats) * (int)sizeof(float);
  staged = stage <= kStageMax;
  const int bytes = staged ? stage : base_floats * (int)sizeof(float);
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return bytes;
}

template <int D>
int launch_fwd(const float* table, const float* x01, const float* res, const int* meta,
               float* scratch, float* out, float* jac, int N, int L, int C,
               int T, cudaStream_t stream) {
  if (N <= 0 || L <= 0) return (int)cudaGetLastError();
  int rc = launch_layout(table, scratch, meta, L, T, 1, stream);
  if (rc != 0) return rc;
  const int blocks = (N + 31) / 32;
  int staged = 0;
  if (jac != nullptr) {
    auto k = permuto_fwd_kernel<D, true>;
    const int bytes = smem_for(k, lattice_floats<D>(), 32 * (odd(C) + odd(JD * C)), staged);
    k<<<blocks, kThreads, bytes, stream>>>(scratch, x01, res, meta, lattice_consts<D>(), out,
                                           jac, N, L, C, T, staged);
  } else {
    auto k = permuto_fwd_kernel<D, false>;
    const int bytes = smem_for(k, lattice_floats<D>(), 32 * odd(C), staged);
    k<<<blocks, kThreads, bytes, stream>>>(scratch, x01, res, meta, lattice_consts<D>(), out,
                                           jac, N, L, C, T, staged);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const float* table, const float* x01, const float* res, const int* meta,
               const float* d_out, const float* d_jac, float* scratch_t,
               float* scratch_g, float* d_table, float* d_x, int N, int L, int C, int T,
               cudaStream_t stream) {
  if (L <= 0) return (int)cudaGetLastError();
  if (N > 0) {
    if (scratch_t != nullptr) {
      const int rc = launch_layout(table, scratch_t, meta, L, T, 1, stream);
      if (rc != 0) return rc;
    }
    int staged = 0;
    auto k = d_jac != nullptr ? permuto_bwd_kernel<D, true> : permuto_bwd_kernel<D, false>;
    const int bytes = smem_for(k, lattice_floats<D>() + kWarps * D * 32,
                               32 * (odd(C) + odd(JD * C)), staged);
    k<<<(N + 31) / 32, kThreads, bytes, stream>>>(scratch_t, x01, res, meta, lattice_consts<D>(),
                                                  d_out, d_jac, scratch_g, d_x, N, L, C, T,
                                                  staged);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return launch_layout(scratch_g, d_table, meta, L, T, 0, stream);
}

}  // namespace

// table: the JAX layout; scratch: a buffer of the table's size that receives
// the interleaved copy. The lattice constants of width D are formed on the
// host (lattice_consts) and passed by value.
extern "C" int permuto_fwd(const void* table, const void* x01, const void* res,
                           const void* meta, void* scratch, void* out, void* jac, int N, int D,
                           int L, int C, int T, void* stream) {
  const auto* t = (const float*)table;
  const auto* x = (const float*)x01;
  const auto* r = (const float*)res;
  const auto* m = (const int*)meta;
  auto* sc = (float*)scratch;
  auto s = (cudaStream_t)stream;
  switch (D) {
    case 3: return launch_fwd<3>(t, x, r, m, sc, (float*)out, (float*)jac, N, L, C, T, s);
    case 4: return launch_fwd<4>(t, x, r, m, sc, (float*)out, (float*)jac, N, L, C, T, s);
    case 7: return launch_fwd<7>(t, x, r, m, sc, (float*)out, (float*)jac, N, L, C, T, s);
    case 11: return launch_fwd<11>(t, x, r, m, sc, (float*)out, (float*)jac, N, L, C, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// scratch_t: the interleaved copy of the table, or null where no d x01 is
// asked from d_out; scratch_g: the interleaved gradient, zeroed, copied back
// into d_table (the JAX layout; every level slab written).
extern "C" int permuto_bwd(const void* table, const void* x01, const void* res,
                           const void* meta, const void* d_out, const void* d_jac,
                           void* scratch_t, void* scratch_g, void* d_table, void* d_x, int N,
                           int D, int L, int C, int T, void* stream) {
  const auto* t = (const float*)table;
  const auto* x = (const float*)x01;
  const auto* r = (const float*)res;
  const auto* m = (const int*)meta;
  const auto* go = (const float*)d_out;
  const auto* gj = (const float*)d_jac;
  auto* st = (float*)scratch_t;
  auto* sg = (float*)scratch_g;
  auto* dt = (float*)d_table;
  auto* dx = (float*)d_x;
  auto s = (cudaStream_t)stream;
  switch (D) {
    case 3: return launch_bwd<3>(t, x, r, m, go, gj, st, sg, dt, dx, N, L, C, T, s);
    case 4: return launch_bwd<4>(t, x, r, m, go, gj, st, sg, dt, dx, N, L, C, T, s);
    case 7: return launch_bwd<7>(t, x, r, m, go, gj, st, sg, dt, dx, N, L, C, T, s);
    case 11: return launch_bwd<11>(t, x, r, m, go, gj, st, sg, dt, dx, N, L, C, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
