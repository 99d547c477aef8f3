// K14 lotd_cp_lines: the stacked CP lines of the LoTD encoding, every CP
// level's lines resampled onto the largest CP resolution by a static two-tap
// lerp and stacked along features, and its backward into the table.
//
// Replaces: neuralsim_tpu/fields/encodings/lotd.py
//   LoTDEncoding._cp_stacked_lines (lines 322-344), and its autodiff.
//
// Level k (R rows, F features, table offset; its lines the segment viewed as
// [3, R, F]) fills the stacked features [col, col + F) of out [3, F_cp, R_max]:
//   out[a, col + f, j] = l0 * (1 - w) + l1 * w,
//   l0 = seg[a, lo[k, j], f], l1 = seg[a, min(lo[k, j] + 1, R - 1), f]
// with lo and w the encoding's float64 plan (JAX's), built once. The lerp
// uses __fsub_rn / __fmul_rn / __fadd_rn, so no FMA contraction: the result
// is bit-equal to the plain l0 * (1 - w) + l1 * w. The same launch writes the
// lines K1 reads, out16 [3, F_cp, R_max] bf16, each value rounded to nearest
// even (__float2bfloat16_rn): bit-equal to the plain lines cast to bf16.
//
// Forward: a block per (tile of R_max, level, axis) of 64 threads; a thread
// takes P = 4 neighbouring positions (1 where R_max % 4 != 0) and every
// feature of each. Its one dependent round of loads: the level's metadata,
// its int32 taps and weights (one 16-byte load each), then the two table rows
// of each position, F contiguous floats each (F 2, 4, 8 unrolled and read as
// float2s or float4s where the segment is aligned, other F a float at a
// time), all issued before the first store; the stores are coalesced along
// R_max, a float4 and four packed bf16 a feature.
//
// Backward, in gather form: lo and w are static, so the build lists for each
// source row r of each level the taps that read it (a CSR over the levels'
// rows: position j and weight 1 - w[j] for a lower tap, w[j] for an upper
// one, the clamped upper tap included), and each (axis, row, feature) of the
// table's CP segments sums its list:
//   d_table[offset + (a R + r) F + f] = sum over (j, wt) of d_lines[a, col + f, j] wt
// A coarse level's row has ~2 (R_max - 1) / (R - 1) taps (~136 at R 16 of
// 1,024, all 2,048 at R 1), a fine level's 1-2. So the plan (cp_lines_work)
// gives each level G lanes an entry, G a power of two with at most a few taps
// a lane (1 to 16: as few as keep the work list within the warps the card
// holds at once), and lists the work as warp items: (level, first entry, G) covers 32 /
// G consecutive entries of one level, a row's features side by side, so that
// the lanes of one tap read neighbouring features (K1's backward leaves
// d_lines a [3, R, F] buffer seen as [3, F, R]: f is the contiguous axis).
// Lane (g, e) sums taps g, g + G, ... of entry e; the G partial sums are
// added by a fixed shuffle tree. No atomics and no order that depends on
// timing: the same bits on every call (another order than the plain
// version's, held at GRAD_REL). Items of level -1 write the zeros of the
// table outside the CP segments, so the kernel writes the whole gradient and
// no zero-fill precedes it.
//
// What bounds it on an H100: bytes, and those are few (the street's stacked
// lines are 3 x 40 x 1,024 floats, 0.5 MB); what it replaces is launches:
// per level two row gathers, a clamp, a lerp, then a cat and a transposed
// copy, and in the backward two sort-based index_put accumulations a level
// and a zero-filled gradient of the whole table for each level's slice, and
// the separate bf16 cast that followed every use of the lines. The forward
// is bound by its dependent loads (one round, then the stores); the
// encoding keeps its lines until the table changes, so a render launches it
// once a table version. The backward is bound by its longest tap walks,
// which the split shortens.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 64;

// P values of one stacked feature at positions o.., as f32 and bf16 (a float4
// and four packed bf16 where P = 4)
template <int P>
__device__ __forceinline__ void store_lines(const float* v, float* __restrict__ out,
                                            __nv_bfloat16* __restrict__ out16, size_t o) {
  if constexpr (P == 4) {
    *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
    const __nv_bfloat162 b01 = __halves2bfloat162(__float2bfloat16_rn(v[0]),
                                                  __float2bfloat16_rn(v[1]));
    const __nv_bfloat162 b23 = __halves2bfloat162(__float2bfloat16_rn(v[2]),
                                                  __float2bfloat16_rn(v[3]));
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&b01);
    u.y = *reinterpret_cast<const unsigned*>(&b23);
    *reinterpret_cast<uint2*>(out16 + o) = u;
  } else {
    out[o] = v[0];
    out16[o] = __float2bfloat16_rn(v[0]);
  }
}

// a table row of F_T floats into v, as float4s or float2s where ``vec``
// (the row 16- or 8-byte aligned)
template <int F_T>
__device__ __forceinline__ void load_row(const float* __restrict__ r, bool vec, float* v) {
  if (vec && F_T % 4 == 0) {
#pragma unroll
    for (int f = 0; f < F_T; f += 4) {
      const float4 q = *reinterpret_cast<const float4*>(r + f);
      v[f] = q.x, v[f + 1] = q.y, v[f + 2] = q.z, v[f + 3] = q.w;
    }
  } else if (vec && F_T % 2 == 0) {
#pragma unroll
    for (int f = 0; f < F_T; f += 2) {
      const float2 q = *reinterpret_cast<const float2*>(r + f);
      v[f] = q.x, v[f + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int f = 0; f < F_T; ++f) v[f] = r[f];
  }
}

// The lerp of P positions of a thread on one axis of one level, F_T features
// (every row's loads issued before the first store), stored as f32 and bf16
// at ``at`` + f R_max. ``vec``: the level's rows are aligned to their width.
template <int F_T, int P>
__device__ __forceinline__ void lines_at(const float* __restrict__ seg, bool vec, const int* l,
                                         const float* ww, int R, float* __restrict__ out,
                                         __nv_bfloat16* __restrict__ out16, size_t at,
                                         int Rmax) {
  float l0[P][F_T], l1[P][F_T];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    load_row<F_T>(seg + l[p] * F_T, vec, l0[p]);
    load_row<F_T>(seg + min(l[p] + 1, R - 1) * F_T, vec, l1[p]);
  }
#pragma unroll
  for (int f = 0; f < F_T; ++f) {
    float v[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
      v[p] = __fadd_rn(__fmul_rn(l0[p][f], __fsub_rn(1.f, ww[p])), __fmul_rn(l1[p][f], ww[p]));
    store_lines<P>(v, out, out16, at + (size_t)f * Rmax);
  }
}

// the same for F at run time, a feature at a time
template <int P>
__device__ __forceinline__ void lines_at_f(const float* __restrict__ seg, const int* l,
                                           const float* ww, int R, int F,
                                           float* __restrict__ out,
                                           __nv_bfloat16* __restrict__ out16, size_t at,
                                           int Rmax) {
  for (int f = 0; f < F; ++f) {
    float v[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float a = seg[l[p] * F + f], b = seg[min(l[p] + 1, R - 1) * F + f];
      v[p] = __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, ww[p])), __fmul_rn(b, ww[p]));
    }
    store_lines<P>(v, out, out16, at + (size_t)f * Rmax);
  }
}

// levels [L, 6]: (first CP entry, table offset, R, F, first stacked column,
// first CSR row); lo [L, R_max] int32; w [L, R_max] f32. P = 4 needs R_max
// % 4 == 0, lo, w and out 16-byte aligned and out16 8-byte aligned.
template <int P>
__global__ void __launch_bounds__(kFwdThreads)
cp_lines_kernel(const float* __restrict__ table, const int* __restrict__ levels,
                const int* __restrict__ lo, const float* __restrict__ w,
                float* __restrict__ out, __nv_bfloat16* __restrict__ out16, int Fcp, int Rmax) {
  const int k = blockIdx.y, a = blockIdx.z;
  const int j0 = (blockIdx.x * kFwdThreads + threadIdx.x) * P;
  if (j0 >= Rmax) return;
  const int* m = levels + 6 * k;
  const int offset = m[1], R = m[2], F = m[3], col = m[4];
  const size_t tap = (size_t)k * Rmax + j0;
  int l[P];
  float ww[P];
  if constexpr (P == 4) {
    const int4 li = *reinterpret_cast<const int4*>(lo + tap);
    const float4 wi = *reinterpret_cast<const float4*>(w + tap);
    l[0] = li.x, l[1] = li.y, l[2] = li.z, l[3] = li.w;
    ww[0] = wi.x, ww[1] = wi.y, ww[2] = wi.z, ww[3] = wi.w;
  } else {
    l[0] = lo[tap];
    ww[0] = w[tap];
  }
  const float* seg = table + offset + (size_t)a * R * F;
  // rows of F = 2 (4, 8) floats 8- (16-) byte aligned: the segment is
  const bool vec = ((uintptr_t)seg & (F == 2 ? 7 : 15)) == 0;
  const size_t at = ((size_t)a * Fcp + col) * Rmax + j0;
  switch (F) {  // one level a block: the same case for all its threads
    case 2: lines_at<2, P>(seg, vec, l, ww, R, out, out16, at, Rmax); break;
    case 4: lines_at<4, P>(seg, vec, l, ww, R, out, out16, at, Rmax); break;
    case 8: lines_at<8, P>(seg, vec, l, ww, R, out, out16, at, Rmax); break;
    default: lines_at_f<P>(seg, l, ww, R, F, out, out16, at, Rmax);
  }
}

// levels [L, 6]: (first CP entry, table offset, R, F, first stacked column,
// first CSR row); items [n_items, 4]: (level, first local entry of the level
// (its order: a, r, f), G lanes an entry, 0), or (-1, first float, count, 0)
// for zeros. rowptr [sum R + 1], tap_j / tap_w: the CSR.
constexpr int kBwdWarps = 8;  // items a block

__global__ void __launch_bounds__(32 * kBwdWarps)
cp_lines_bwd_kernel(const float* __restrict__ d_lines, const int* __restrict__ levels,
                    const int4* __restrict__ items, const int* __restrict__ rowptr,
                    const int* __restrict__ tap_j, const float* __restrict__ tap_w,
                    float* __restrict__ d_table, long long s0, long long s1, long long s2,
                    int n_items) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kBwdWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;  // the whole warp
  const int4 it = items[item];
  if (it.x < 0) {
    for (int i = lane; i < it.z; i += 32) d_table[it.y + i] = 0.f;
    return;
  }
  const int* m = levels + 6 * it.x;
  const int R = m[2], F = m[3];
  const int G = it.z, E = 32 / G;
  const int g = lane / E, local = it.y + (lane - g * E);
  const bool valid = local < 3 * R * F;
  float s = 0.f;
  if (valid) {
    const int f = local % F;
    const int r = (local / F) % R;
    const int a = local / (F * R);
    const float* gp = d_lines + a * s0 + (m[4] + f) * s1;
    const int end = rowptr[m[5] + r + 1];
#pragma unroll 8
    for (int t = rowptr[m[5] + r] + g; t < end; t += G) s += gp[tap_j[t] * s2] * tap_w[t];
  }
  // lane g E + e adds lane (g + G / 2) E + e's sum, and so on down to g = 0
  for (int d = 16; d >= E; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  if (g == 0 && valid) d_table[m[1] + local] = s;
}

}  // namespace

// table: the flat f32 table; out [3, F_cp, R_max] f32 and out16 the same in
// bf16, both written whole by one launch.
extern "C" int lotd_cp_lines_fwd(const void* table, const void* levels, const void* lo,
                                 const void* w, void* out, void* out16, int L, int Fcp, int Rmax,
                                 void* stream) {
  if (L < 1 || Fcp < 1 || Rmax < 1) return (int)cudaErrorInvalidValue;
  const bool wide = Rmax % 4 == 0 &&
                    (((uintptr_t)lo | (uintptr_t)w | (uintptr_t)out) & 15) == 0 &&
                    ((uintptr_t)out16 & 7) == 0;
  const int P = wide ? 4 : 1;
  const dim3 grid((Rmax / P + kFwdThreads - 1) / kFwdThreads, L, 3);
  if (wide)
    cp_lines_kernel<4><<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const int*)levels, (const int*)lo, (const float*)w, (float*)out,
        (__nv_bfloat16*)out16, Fcp, Rmax);
  else
    cp_lines_kernel<1><<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const int*)levels, (const int*)lo, (const float*)w, (float*)out,
        (__nv_bfloat16*)out16, Fcp, Rmax);
  return (int)cudaGetLastError();
}

// d_lines [3, F_cp, R_max] f32 at strides (s0, s1, s2) in floats; d_table:
// the flat f32 gradient, every float of which the n_items items write.
extern "C" int lotd_cp_lines_bwd(const void* d_lines, const void* levels, const void* items,
                                 const void* rowptr, const void* tap_j, const void* tap_w,
                                 void* d_table, int s0, int s1, int s2, int n_items,
                                 void* stream) {
  if (n_items < 1) return (int)cudaErrorInvalidValue;
  cp_lines_bwd_kernel<<<(n_items + kBwdWarps - 1) / kBwdWarps, 32 * kBwdWarps, 0,
                        (cudaStream_t)stream>>>(
      (const float*)d_lines, (const int*)levels, (const int4*)items, (const int*)rowptr,
      (const int*)tap_j, (const float*)tap_w, (float*)d_table, s0, s1, s2, n_items);
  return (int)cudaGetLastError();
}
