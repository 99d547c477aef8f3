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
// is bit-equal to the plain l0 * (1 - w) + l1 * w.
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
// and a zero-filled gradient of the whole table for each level's slice. The
// forward has a thread an output (coalesced writes along R_max); the
// backward is bound by its longest tap walks, which the split shortens.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// cols [F_cp, 4]: (table offset of the column's feature f = offset + f, R, F,
// level k); lo [L, R_max] int64; w [L, R_max] f32.
__global__ void cp_lines_kernel(const float* __restrict__ table, const int* __restrict__ cols,
                                const long long* __restrict__ lo, const float* __restrict__ w,
                                float* __restrict__ out, int Fcp, int Rmax) {
  const int total = 3 * Fcp * Rmax;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x) {
    const int j = e % Rmax;
    const int c = (e / Rmax) % Fcp;
    const int a = e / (Rmax * Fcp);
    const int base = cols[4 * c], R = cols[4 * c + 1], F = cols[4 * c + 2], k = cols[4 * c + 3];
    const int l = (int)lo[(size_t)k * Rmax + j];
    const int h = min(l + 1, R - 1);
    const float ww = w[(size_t)k * Rmax + j];
    const float l0 = table[base + (a * R + l) * F];
    const float l1 = table[base + (a * R + h) * F];
    out[e] = __fadd_rn(__fmul_rn(l0, __fsub_rn(1.f, ww)), __fmul_rn(l1, ww));
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

int grid_for(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return (int)(want < 1 ? 1 : (want > 132 * 16 ? 132 * 16 : want));
}

}  // namespace

// table: the flat f32 table; out [3, F_cp, R_max] f32.
extern "C" int lotd_cp_lines_fwd(const void* table, const void* cols, const void* lo,
                                 const void* w, void* out, int Fcp, int Rmax, void* stream) {
  if (Fcp < 1 || Rmax < 1) return (int)cudaErrorInvalidValue;
  cp_lines_kernel<<<grid_for(3LL * Fcp * Rmax), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)cols, (const long long*)lo, (const float*)w,
      (float*)out, Fcp, Rmax);
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
