// K3 lotd_grid: the dense and hash (Instant-NGP) levels of the LoTD encoding,
// the 2^D-corner multilinear gather in D = 3 (8 corners, with the optional
// analytic jacobian: the NeuS fields) or D = 4 (16 corners, no jacobian: the
// 4-D distant field's (unit shell, 1 / rho) input), all gather levels in one
// launch. D is a template parameter of every kernel here.
//
// Replaces: neuralsim_tpu/fields/encodings/lotd.py
//   LoTDEncoding._level_features + _corner_rows_weight (lines 219-248,
//   410-456) and neuralsim_tpu/ops/gather.py gather_cols (lines 28-41).
//
// Per level (res, size rows, table offset, F features, dense|hash, out row):
//   pos = x01 * res, cell = min(floor(pos), res-1), frac = pos - cell
//   corner c (bit i = axis i): w = prod_i (bit ? frac_i : 1-frac_i)  (in axis order)
//   row = dense: sum_i (cell_i+bit_i) (res+1)^i
//         hash:  xor_i ((cell_i+bit_i) * prime_i) in uint32, mod size
//                (primes 1, 2654435761, 805459861, 3674653429)
//   feats[f] = sum_c w * table[offset + f*size + row]   (corners 0..2^D-1 in order)
//   jac[i][f] = res * sum_c (+-1) * prod_{j != i} w_j * table[...]   (D = 3)
// The table keeps the JAX layout: each level's segment viewed as [F, size].
// Rows are clamped into the level (gather_cols' mode="clip"). Feature f of a
// level goes to row (out row + f) of the encoding's feature-major output
// out [C, N] (and jac [3, C, N]), which the stacked-CP kernel fills too;
// the points are pos01 [N, D].
//
// What bounds it on an H100: the writes (4 bytes a feature, 16 with the
// jacobian: 8.2 us for the vehicles' 196,608 points with it) and, on hash
// levels, the gathers: 8 corners a point and level scattered over a table in
// L2 (synthetic_object's two hash levels are 256 KB each, F 2).
// The forward's design:
//  * each level is read as a [size, F] copy, so a corner's F features take
//    one load (8 bytes at F 2; the wide kernel's 16 at F 4, two at F 8; a
//    float a feature at any other F). The launch names levels to stage
//    (stage_mask, n_shared floats): those that fit n_shared, in level order,
//    are copied into each block's dynamic shared memory at its start (past
//    48 KB as opt-in; the vehicles' two dense levels, 55.6 KB), with a
//    persistent grid; the other levels are interleaved into the `inter`
//    scratch (n_inter floats; synthetic_object's hash levels, 256 KB each),
//    which a first kernel of the same call fills unless the caller's copy
//    of this table version is given, and read through L1; a level that fits
//    neither is read from the table in its own layout, a float at a time. So
//    a plan that does not match the meta costs speed, never correctness;
//  * the levels are walked one after another by the whole grid (a thread a
//    point), so a hash level's copy competes alone for L1; within a point's
//    level the 8 corners' loads are issued together;
//  * F 1, 2 (4 and 8 in the wide kernel) and the jacobian are template
//    parameters; a launch of F <= 2 only takes the narrow kernel, whose 64
//    registers hold 4 blocks a SM, for the latency of the hash gathers
//    (FwdShape; at D = 4, 16 corners' loads in flight, 128 registers and 2
//    blocks a SM); the sums are the parent kernel's, operation by operation
//    (corner order, _rn), so the outputs keep its bits.
//  * D = 4 (the distant field: a dense level of 17^4 rows, 668 KB at F 2, and
//    hash levels of 2^17 rows, 1 MB each) stages nothing in 96 KB: every level
//    goes through the interleaved scratch, each level's copy from a 32-byte
//    boundary (the 668 KB dense copy left every hash level after it 16 bytes
//    into a sector, and a point's corners touched 11% more sectors: 0.386 ->
//    0.340 ms at a pixel step's 524,288 points on an H100). Loading a
//    corner's axis-0 neighbour with it (one 16-byte load a pair of rows r,
//    r ^ 1) asked for 16-28% fewer sectors but was 1-6% slower, also with 8
//    or 4 corners in flight and more blocks a SM: the sums' loads stay one a
//    corner.
// Sums use explicit _rn operations so no FMA changes the JAX rounding.
//
// Backward (lotd_grid_bwd), the gradient of both outputs into the table: the
// same corners, weights, hash and clamp as the forward, and per point, level,
// corner and feature
//   d table[offset + f*size + row] += w * d_out[f] + res * sum_i dw_i * d_jac[i][f]
// What bounds it: by bytes it reads 12 + 16 F bytes a point and level (the
// cotangents) and writes the levels' gradients once. What held it back was
// contention: a dense level of a vehicle (R 8, 13: 729 and 2,744 rows) takes
// ~900 float atomics on each address, and the lanes of a warp (neighbouring
// samples of one ray) hit the same few rows, so their atomics serialise in L2.
// The design:
//  * before any add, the lanes of a warp that hold a run of equal rows of a
//    level (a ray's samples in one cell) sum their values by shuffles, and
//    only the run's first lane adds: one add for the run;
//  * the caller may name private levels (dense levels whose segments fit a
//    shared-memory budget together: `private_mask`, `n_private` floats), for
//    launches with enough points to pay for them; then the grid is
//    persistent, one block a SM, and each block sums its own copy of those
//    levels in dynamic shared memory. A named level whose segment does not
//    fit what is left of the `n_private` floats takes device atomics, so a
//    plan that does not match the meta costs speed, never correctness;
//  * each block stores its copy in `scratch` [blocks, n_private], and a
//    second kernel sums every column over the blocks in block order into the
//    table: no device atomic on a private level, and a sum over blocks that is
//    the same from run to run (within a block the shared float atomics still
//    vary the last bits). The other levels take device atomics.
//  * at D = 4 (grid4_bwd_kernel, below) no level is private: the distant
//    field's gradient goes to an interleaved scratch by vector atomics, with
//    the runs of a warp found once a level (see there), and no d_jac is read.
//
// Backward to the positions (lotd_grid_bwd_x, D = 3, the features' cotangent
// alone): JAX's autodiff of _level_features with respect to pos01 (pose
// refinement moves the rays, and so every sample). Per point and axis i
//   d pos01_i = g_i * sum_l res_l * sum_c (dw_c / dfrac_i) * sum_f d_out[f] table[row_c, f]
// where dw_c/dfrac_i is the product of the other axes' factors, signed by
// corner c's bit i (corner_weights' JAC factors), frac = x res - cell with
// the cell held constant (floor and the clamp of the top cell pass nothing),
// and g_i the gradient of jnp.clip(pos01_i, 0, 1): 1 inside, 0 outside, 1/2
// at x == 0 or 1 (a tie of its maximum or minimum). What bounds it: bytes,
// the cotangent (4 C bytes a point) above all, then the points, the output
// and the table once. The design: a thread a point walks the levels in
// order, reading each level where the forward does (its [size, F] copy in
// the interleaved scratch, one load a corner at F 2, the scratch filled by
// the same first kernel where the caller's copy is stale; a level the
// forward stages in shared memory, or that fits neither, from the table),
// the cotangent's F entries once a level (coalesced, feature-major), and
// owns its three outputs: no atomics, the same bits every call.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_runs.cuh"

namespace {

constexpr int META = 6;  // res, size, offset, F, is_hash, out row
__constant__ uint32_t kPrimes[4] = {1u, 2654435761u, 805459861u, 3674653429u};

// A launch whose levels all have F <= 2 takes the narrow kernel: a corner's
// features 2 at a time (kGroup), blocks of 256 threads with registers for 4
// blocks a SM (3 with the jacobian, where 64 registers spilled), 2 a SM where
// levels are staged; any other launch the wide kernel: 4 at a time, blocks
// of 512 with up to 128 registers, 1 a SM where levels are staged (each
// block stages them all). Where nothing is staged, up to 2,048 threads a SM.
// At D = 4 the narrow kernel keeps 16 corners' loads in flight: registers for
// 2 blocks a SM.
template <int D, bool WIDE, bool JAC>
struct FwdShape {
  static constexpr int kGroup = WIDE ? 4 : 2;
  static constexpr int kThreads = WIDE ? 512 : 256;
  static constexpr int kMinBlocks = WIDE ? 1 : (D == 4 ? 2 : (JAC ? 3 : 4));
  static constexpr int kStagedBlocks = WIDE ? 1 : 2;
};

__host__ __device__ __forceinline__ int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int align8(int n) { return (n + 7) & ~7; }

// Where the forward reads level l: its [size, F] copy in the block's shared
// memory (1) or in the scratch (2) at *off, or the table in its own layout
// (0). Every thread walks the meta in the same order, so all agree. A shared
// copy starts on 16 bytes, a scratch copy on 32 (a sector: at F 2 an aligned
// group of 4 rows is one sector). The D = 4 backward walks its gradient
// scratch the same way (no shared copy).
struct Place {
  int soff = 0, ioff = 0;  // floats taken so far in each
  __device__ __forceinline__ int next(unsigned mask, int l, int seg, int n_shared, int n_inter,
                                      int* off) {
    if (l < 31 && ((mask >> l) & 1u) && soff + align4(seg) <= n_shared) {
      *off = soff;
      soff += align4(seg);
      return 1;
    }
    if (ioff + align8(seg) <= n_inter) {
      *off = ioff;
      ioff += align8(seg);
      return 2;
    }
    return 0;
  }
};

// A level's [F, size] segment into [size, F] rows at dst: a thread a row.
__device__ __forceinline__ void interleave(const float* __restrict__ seg, float* dst, int size,
                                           int nf, int first, int stride) {
  for (int r = first; r < size; r += stride)
    for (int f = 0; f < nf; ++f) dst[(size_t)r * nf + f] = __ldg(seg + (size_t)f * size + r);
}

__global__ void grid_interleave_kernel(const float* __restrict__ table,
                                       const int* __restrict__ meta, float* __restrict__ inter,
                                       int L, unsigned stage_mask, int n_shared, int n_inter) {
  Place place;
  for (int l = 0; l < L; ++l) {
    const int size = __ldg(meta + l * META + 1), nf = __ldg(meta + l * META + 3);
    int off;
    if (place.next(stage_mask, l, nf * size, n_shared, n_inter, &off) == 2)
      interleave(table + __ldg(meta + l * META + 2), inter + off, size, nf,
                 blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
  }
}

// A point's cell, fractions and its 2^D corners' rows on one level.
template <int D>
struct Cell {
  int cell[D];
  float frac[D], om[D];  // om = 1 - frac, rounded as the parent kernel rounds it
};

template <int D>
__device__ __forceinline__ Cell<D> cell_of(const float (&x)[D], int res) {
  Cell<D> c;
  const float fres = (float)res;
#pragma unroll
  for (int ax = 0; ax < D; ++ax) {
    const float pos = __fmul_rn(x[ax], fres);
    const float cf = fminf(floorf(pos), (float)(res - 1));
    c.cell[ax] = (int)cf;
    c.frac[ax] = __fsub_rn(pos, cf);
    c.om[ax] = __fsub_rn(1.f, c.frac[ax]);
  }
  return c;
}

// Corner c's row from the cell ci[i] + bit i (the dense stride (res+1)^i,
// or the hash), clamped into the level.
template <int D>
__device__ __forceinline__ int row_of(const int (&ci)[D], int res, int size, int is_hash) {
  int row;
  if (is_hash) {
    uint32_t h = (uint32_t)ci[0] * kPrimes[0];
#pragma unroll
    for (int ax = 1; ax < D; ++ax) h ^= (uint32_t)ci[ax] * kPrimes[ax];
    row = (int)(h % (uint32_t)size);
  } else {
    row = ci[0];
    int stride = res + 1;
#pragma unroll
    for (int ax = 1; ax < D; ++ax, stride *= res + 1) row += ci[ax] * stride;
  }
  return min(max(row, 0), size - 1);
}

template <int D>
__device__ __forceinline__ int corner_row(const Cell<D>& c, int corner, int res, int size,
                                          int is_hash) {
  int ci[D];
#pragma unroll
  for (int ax = 0; ax < D; ++ax) ci[ax] = c.cell[ax] + ((corner >> ax) & 1);
  return row_of<D>(ci, res, size, is_hash);
}

// A corner's weight (the axis factors multiplied in axis order) and, with
// the jacobian, its D derivative factors, as the parent forms them.
template <int D, bool JAC>
__device__ __forceinline__ void corner_weights(const Cell<D>& c, int corner, float& w,
                                               float (&dw)[D]) {
  float aw[D];
#pragma unroll
  for (int ax = 0; ax < D; ++ax) aw[ax] = ((corner >> ax) & 1) ? c.frac[ax] : c.om[ax];
  w = aw[0];
#pragma unroll
  for (int ax = 1; ax < D; ++ax) w = __fmul_rn(w, aw[ax]);
  if constexpr (!JAC) return;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float v = ((corner >> i) & 1) ? 1.f : -1.f;
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (j != i) v = __fmul_rn(v, aw[j]);
    dw[i] = v;
  }
}

template <int G>
__device__ __forceinline__ void load_corner(float (&v)[G], const float* p) {
  if constexpr (G == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (G == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// The output rows of features f0 .. f0 + G - 1 of a level at column col.
template <int D, int G, bool JAC>
__device__ __forceinline__ void store(const float (&acc)[G], const float (&j)[D][G], float fres,
                                      float* out, float* jac, size_t o, size_t N,
                                      size_t plane) {
#pragma unroll
  for (int f = 0; f < G; ++f) {
    out[o + f * N] = acc[f];
    if constexpr (JAC) {
#pragma unroll
      for (int i = 0; i < D; ++i) jac[i * plane + o + f * N] = __fmul_rn(j[i][f], fres);
    }
  }
}

// One level of F features (1, 2, 4 or 8; in groups of G <= GMAX) over the
// grid's points, read from a [size, F] copy at src (shared or global).
template <int D, int F, int GMAX, bool JAC>
__device__ __forceinline__ void walk_level(const float* src, const float* __restrict__ pos01,
                                           int res, int size, int is_hash, int col,
                                           float* __restrict__ out, float* __restrict__ jac,
                                           int N, int C) {
  constexpr int G = F > GMAX ? GMAX : F;
  constexpr int K = 1 << D;  // corners
  const size_t plane = (size_t)C * N;
  const float fres = (float)res;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N; n += gridDim.x * blockDim.x) {
    float x[D];
#pragma unroll
    for (int ax = 0; ax < D; ++ax)
      x[ax] = fminf(fmaxf(__ldg(pos01 + (size_t)n * D + ax), 0.f), 1.f);
    const Cell<D> c = cell_of<D>(x, res);
    int rows[K];
#pragma unroll
    for (int corner = 0; corner < K; ++corner)
      rows[corner] = corner_row<D>(c, corner, res, size, is_hash);
#pragma unroll
    for (int g = 0; g < F; g += G) {
      float v[K][G];
#pragma unroll
      for (int corner = 0; corner < K; ++corner)  // every load first
        load_corner<G>(v[corner], src + (size_t)rows[corner] * F + g);
      float acc[G], j[D][G];
#pragma unroll
      for (int f = 0; f < G; ++f) {
        acc[f] = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) j[i][f] = 0.f;
      }
#pragma unroll
      for (int corner = 0; corner < K; ++corner) {
        float w, dw[D];
        corner_weights<D, JAC>(c, corner, w, dw);
#pragma unroll
        for (int f = 0; f < G; ++f) {
          acc[f] = __fadd_rn(acc[f], __fmul_rn(w, v[corner][f]));
          if constexpr (JAC) {
#pragma unroll
            for (int i = 0; i < D; ++i) j[i][f] = __fadd_rn(j[i][f], __fmul_rn(dw[i], v[corner][f]));
          }
        }
      }
      store<D, G, JAC>(acc, j, fres, out, jac, (size_t)(col + g) * N + n, N, plane);
    }
  }
}

// Any F, a float at a time: feature f of row r at src[r * rs + f * fs] (a
// [size, F] copy: rs F, fs 1; the table's own [F, size]: rs 1, fs size).
template <int D, bool JAC>
__device__ __forceinline__ void walk_level_any(const float* src, size_t rs, size_t fs,
                                               const float* __restrict__ pos01, int res,
                                               int size, int nf, int is_hash, int col,
                                               float* __restrict__ out, float* __restrict__ jac,
                                               int N, int C) {
  const size_t plane = (size_t)C * N;
  const float fres = (float)res;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N; n += gridDim.x * blockDim.x) {
    float x[D];
#pragma unroll
    for (int ax = 0; ax < D; ++ax)
      x[ax] = fminf(fmaxf(__ldg(pos01 + (size_t)n * D + ax), 0.f), 1.f);
    constexpr int K = 1 << D;
    const Cell<D> c = cell_of<D>(x, res);
    int rows[K];
#pragma unroll
    for (int corner = 0; corner < K; ++corner)
      rows[corner] = corner_row<D>(c, corner, res, size, is_hash);
    for (int f = 0; f < nf; ++f) {
      float v[K];
#pragma unroll
      for (int corner = 0; corner < K; ++corner) v[corner] = src[rows[corner] * rs + f * fs];
      float acc[1] = {0.f}, j[D][1];
#pragma unroll
      for (int i = 0; i < D; ++i) j[i][0] = 0.f;
#pragma unroll
      for (int corner = 0; corner < K; ++corner) {
        float w, dw[D];
        corner_weights<D, JAC>(c, corner, w, dw);
        acc[0] = __fadd_rn(acc[0], __fmul_rn(w, v[corner]));
        if constexpr (JAC) {
#pragma unroll
          for (int i = 0; i < D; ++i) j[i][0] = __fadd_rn(j[i][0], __fmul_rn(dw[i], v[corner]));
        }
      }
      store<D, 1, JAC>(acc, j, fres, out, jac, (size_t)(col + f) * N + n, N, plane);
    }
  }
}

// A level's [size, F] copy: F 1 and 2 (and, in the wide kernel, 4 and 8)
// templated, any other F a float at a time.
template <int D, bool JAC, bool WIDE>
__device__ __forceinline__ void walk_copy(const float* src, const float* __restrict__ pos01,
                                          int res, int size, int nf, int is_hash, int col,
                                          float* __restrict__ out, float* __restrict__ jac,
                                          int N, int C) {
  constexpr int GM = FwdShape<D, WIDE, JAC>::kGroup;
  if (nf == 1)
    return walk_level<D, 1, GM, JAC>(src, pos01, res, size, is_hash, col, out, jac, N, C);
  if (nf == 2)
    return walk_level<D, 2, GM, JAC>(src, pos01, res, size, is_hash, col, out, jac, N, C);
  if constexpr (WIDE) {
    if (nf == 4)
      return walk_level<D, 4, GM, JAC>(src, pos01, res, size, is_hash, col, out, jac, N, C);
    if (nf == 8)
      return walk_level<D, 8, GM, JAC>(src, pos01, res, size, is_hash, col, out, jac, N, C);
  }
  walk_level_any<D, JAC>(src, nf, 1, pos01, res, size, nf, is_hash, col, out, jac, N, C);
}

template <int D, bool JAC, bool WIDE>
__global__ void __launch_bounds__(FwdShape<D, WIDE, JAC>::kThreads,
                                  FwdShape<D, WIDE, JAC>::kMinBlocks)
grid_kernel(const float* __restrict__ table,
            const float* __restrict__ pos01,  // [N, D]
            const int* __restrict__ meta,     // [L, 6]
            const float* __restrict__ inter,  // the interleaved levels, or null
            float* __restrict__ out,          // [C, N]
            float* __restrict__ jac,          // [3, C, N] or null (D = 3 only)
            int N, int C, int L, unsigned stage_mask, int n_shared, int n_inter) {
  extern __shared__ float4 staged4[];
  float* staged = reinterpret_cast<float*>(staged4);
  if (n_shared > 0) {  // the same in every block
    Place place;
    for (int l = 0; l < L; ++l) {
      const int size = __ldg(meta + l * META + 1), nf = __ldg(meta + l * META + 3);
      int off;
      if (place.next(stage_mask, l, nf * size, n_shared, n_inter, &off) == 1)
        interleave(table + __ldg(meta + l * META + 2), staged + off, size, nf, threadIdx.x,
                   blockDim.x);
    }
    __syncthreads();
  }
  Place place;
  for (int l = 0; l < L; ++l) {
    const int res = __ldg(meta + l * META + 0);
    const int size = __ldg(meta + l * META + 1);
    const int offset = __ldg(meta + l * META + 2);
    const int nf = __ldg(meta + l * META + 3);
    const int is_hash = __ldg(meta + l * META + 4);
    const int col = __ldg(meta + l * META + 5);
    int off;
    const int where = place.next(stage_mask, l, nf * size, n_shared, n_inter, &off);
    if (where == 1)
      walk_copy<D, JAC, WIDE>(staged + off, pos01, res, size, nf, is_hash, col, out, jac, N, C);
    else if (where == 2)
      walk_copy<D, JAC, WIDE>(inter + off, pos01, res, size, nf, is_hash, col, out, jac, N, C);
    else
      walk_level_any<D, JAC>(table + offset, 1, size, pos01, res, size, nf, is_hash, col, out,
                             jac, N, C);
  }
}

struct GridArgs {
  const float* table;
  const float* pos01;
  const int* meta;
  const float* inter;
  float* out;
  float* jac;
  int N, C, L;
  unsigned stage_mask;
  int n_shared, n_inter;
};

template <int D, bool JAC, bool WIDE>
cudaError_t launch_grid(const GridArgs& a, size_t smem, int sms, cudaStream_t stream) {
  using Sh = FwdShape<D, WIDE, JAC>;
  const int cap = sms * (smem > 0 ? Sh::kStagedBlocks : 2048 / Sh::kThreads);
  int blocks = (a.N + Sh::kThreads - 1) / Sh::kThreads;
  blocks = blocks < 1 ? 1 : (blocks > cap ? cap : blocks);
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(grid_kernel<D, JAC, WIDE>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return e;
  grid_kernel<D, JAC, WIDE><<<blocks, Sh::kThreads, smem, stream>>>(
      a.table, a.pos01, a.meta, a.inter, a.out, a.jac, a.N, a.C, a.L, a.stage_mask, a.n_shared,
      a.n_inter);
  return cudaGetLastError();
}

constexpr int kBwdThreads = 256;         // a block of the atomics-only grid
constexpr int kBwdPrivateThreads = 512;  // a block of the persistent grid

// Level l, of seg floats, goes to the shared copy at soff where the mask names
// it and it fits the copy's n_private floats.
__device__ __forceinline__ bool is_private(unsigned mask, int l, int soff, int seg,
                                           int n_private) {
  return l < 31 && ((mask >> l) & 1u) && soff + seg <= n_private;
}

// Either cotangent may be null. D = 3 (the 4-D points take grid4_bwd_kernel).
template <int D>
__global__ void __launch_bounds__(kBwdPrivateThreads)
grid_bwd_kernel(const float* __restrict__ pos01,  // [N, D]
                const int* __restrict__ meta,     // [L, 6]
                const float* __restrict__ d_out,  // [C, N] or null
                const float* __restrict__ d_jac,  // [D, C, N] or null
                float* __restrict__ d_table,      // flat, zeroed
                float* __restrict__ scratch,      // [gridDim.x, n_private] or null
                int N, int C, int L, unsigned private_mask, int n_private) {
  constexpr int K = 1 << D;  // corners
  extern __shared__ float priv[];  // this block's copy of the private levels
  for (int i = threadIdx.x; i < n_private; i += blockDim.x) priv[i] = 0.f;
  __syncthreads();

  const size_t plane = (size_t)C * N;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  // whole warps walk the points, so every lane reaches the warp intrinsics
  for (int base = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32; base < N;
       base += warps * 32) {
    const int n = base + lane;
    const bool valid = n < N;
    float x[D];
#pragma unroll
    for (int ax = 0; ax < D; ++ax)
      x[ax] = valid ? fminf(fmaxf(pos01[(size_t)n * D + ax], 0.f), 1.f) : 0.f;
    int soff = 0;  // the level's offset in the shared copy
    for (int l = 0; l < L; ++l) {
      const int res = meta[l * META + 0];
      const int size = meta[l * META + 1];
      const int offset = meta[l * META + 2];
      const int nf = meta[l * META + 3];
      const int is_hash = meta[l * META + 4];
      const int col = meta[l * META + 5];
      const bool in_shared = is_private(private_mask, l, soff, nf * size, n_private);
      const float fres = (float)res;
      int cell[D];
      float frac[D];
#pragma unroll
      for (int ax = 0; ax < D; ++ax) {
        float pos = __fmul_rn(x[ax], fres);
        float c = fminf(floorf(pos), (float)(res - 1));
        cell[ax] = (int)c;
        frac[ax] = __fsub_rn(pos, c);
      }
      float* seg = in_shared ? priv + soff : d_table + offset;
      for (int f0 = 0; f0 < nf; f0 += 4) {  // features in groups of four
        float go[4], gj[D][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool has = valid && f0 + k < nf;
          const size_t o = (size_t)(col + f0 + k) * N + n;
          go[k] = has && d_out != nullptr ? d_out[o] : 0.f;
#pragma unroll
          for (int i = 0; i < D; ++i)
            gj[i][k] = has && d_jac != nullptr ? d_jac[i * plane + o] : 0.f;
        }
#pragma unroll
        for (int corner = 0; corner < K; ++corner) {
          float aw[D];
          int ci[D];
#pragma unroll
          for (int ax = 0; ax < D; ++ax) {
            int b = (corner >> ax) & 1;
            aw[ax] = b ? frac[ax] : 1.f - frac[ax];
            ci[ax] = cell[ax] + b;
          }
          float w = aw[0];
#pragma unroll
          for (int ax = 1; ax < D; ++ax) w *= aw[ax];
          const int row = row_of<D>(ci, res, size, is_hash);
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = w * go[k];
#pragma unroll
          for (int i = 0; i < D; ++i) {
            float dw = ((corner >> i) & 1) ? fres : -fres;
#pragma unroll
            for (int j = 0; j < D; ++j)
              if (j != i) dw *= aw[j];
#pragma unroll
            for (int k = 0; k < 4; ++k) v[k] += dw * gj[i][k];
          }
          // a lane past N keys -1, so it never joins a real row's run
          if (sum_over_run(valid ? row : -1, lane, v) && valid) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (f0 + k < nf) atomicAdd(seg + (size_t)(f0 + k) * size + row, v[k]);
          }
        }
      }
      if (in_shared) soff += nf * size;
    }
  }

  if (n_private > 0) {
    __syncthreads();
    float* dst = scratch + (size_t)blockIdx.x * n_private;
    for (int i = threadIdx.x; i < n_private; i += blockDim.x) dst[i] = priv[i];
  }
}

// d_table[the private entry of column c] += sum over blocks b, in order, of
// scratch[b, c]: one thread a column, so nothing collides.
__global__ void grid_bwd_flush_kernel(const float* __restrict__ scratch,
                                      const int* __restrict__ meta,
                                      float* __restrict__ d_table, int n_private, int blocks,
                                      int L, unsigned private_mask) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_private) return;
  float acc = 0.f;
#pragma unroll 32  // loads in flight: the column's blocks are far apart
  for (int b = 0; b < blocks; ++b) acc += scratch[(size_t)b * n_private + c];
  int soff = 0;
  for (int l = 0; l < L; ++l) {
    const int seg = meta[l * META + 3] * meta[l * META + 1];
    if (!is_private(private_mask, l, soff, seg, n_private)) continue;
    if (c < soff + seg) {
      d_table[meta[l * META + 2] + (c - soff)] += acc;
      return;
    }
    soff += seg;
  }
}

// ---------------------------------------------------------------------------
// The D = 4 backward (lotd_grid4.bwd): d_out only, F a template parameter of
// the level's body, no level in shared memory. The levels that fit the
// n_inter floats of the gradient scratch (the forward's [size, F] layout and
// places, Place with nothing staged) take vector atomics there: a corner's F
// features one float2 (F 2; a float4 at F 4), an axis-0 pair of corners whose
// rows are r and r ^ 1 one float4 (F 2; a float2 at F 1): on axis 0 the
// hash's prime is 1 and a power-of-two size keeps the low bits, so where
// cell_0 is even the pair's rows are r, r ^ 1 (dense: r, r + 1, r even half
// the time), one aligned 16 bytes of the [size, 2] rows. A second kernel
// writes the scratch into d_table's [F, size] segments. A level past the
// scratch takes a float atomic a feature in d_table.
// Runs: the renderer flattens [rays, samples], so the lanes of a warp hold
// neighbouring samples of a distant ray, which share a 4-D cell at the coarse
// levels and step along axis 3 (the inverse radius). The runs of equal cells
// are found once a level (the 16 corners' rows are functions of the cell),
// each run's corners summed by shuffles into its first lane, and where the
// next run's cell is this one's plus one on axis 3 alone, this run's eight
// corners with bit 3 set are the next run's eight with bit 3 clear (the same
// rows; along a ray axis 3 falls, and then this run's corners with bit 3
// clear are the next run's with it set): the next run's first lane adds
// them with its own.
// What bounds it on an H100: the device atomics' rate. At a pixel step's
// 524,288 distant samples it issues 48 M float2 / float4 atomics (0.61 ms),
// where a float atomic a feature for each run of equal rows of a corner
// would issue 135 M (2.18 ms); its bytes' bound is 0.018 ms.
constexpr int kBwd4Threads = 256;
constexpr int kBwd4MinBlocks = 2;  // up to 128 registers a thread

// The runs of equal cells of the warp's points, and their neighbours on axis 3.
struct CellRuns {
  Runs r;
  bool give_up;    // head: the next run's cell is ours + e3; it adds our bit-3 corners
  bool give_down;  // head: the next run's cell is ours - e3; it adds our bit-3-clear corners
  bool take_lo;    // head: add the previous run's bit-3 corners to our bit-3-clear ones
  bool take_hi;    // head: add the previous run's bit-3-clear corners to our bit-3 ones
  int prev_head;   // head: the previous run's first lane
  bool any_take;   // some lane of the warp takes
};

// cell: the lane's cell, -2 on every axis for a lane with no point (past N),
// which is never a real cell (>= 0) nor next to one. A run never gives the
// half of its corners that it may take into (a ray's cell steps one way), so
// what it gives is its own sum. Every lane takes part.
__device__ __forceinline__ CellRuns cell_runs(const int (&cell)[4], int lane) {
  bool same_prev = true, prev_lo = true, prev_hi = true;
#pragma unroll
  for (int ax = 0; ax < 4; ++ax) {
    const int p = __shfl_up_sync(kFullWarp, cell[ax], 1);
    same_prev = same_prev && p == cell[ax];
    prev_lo = prev_lo && p == cell[ax] - (ax == 3 ? 1 : 0);
    prev_hi = prev_hi && p == cell[ax] + (ax == 3 ? 1 : 0);
  }
  CellRuns c;
  c.r.head = lane == 0 || !same_prev;
  c.r.heads = __ballot_sync(kFullWarp, c.r.head);
  c.r.steps = 0;
  c.r.same = 0u;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int off = 1 << s;
    // lane + off is in this lane's run iff no run starts in (lane, lane + off]
    const bool same = lane + off < 32 && ((c.r.heads >> (lane + 1)) & ((1u << off) - 1u)) == 0u;
    if (!__any_sync(kFullWarp, same)) break;
    c.r.same |= (unsigned)same << s;
    c.r.steps = s + 1;
  }
  const unsigned after = lane < 31 ? c.r.heads >> (lane + 1) : 0u;
  const int next_first = after ? lane + __ffs((int)after) : 32;
  bool next_up = next_first < 32, next_down = next_first < 32;
#pragma unroll
  for (int ax = 0; ax < 4; ++ax) {
    const int nc = __shfl_sync(kFullWarp, cell[ax], next_first & 31);
    next_up = next_up && nc == cell[ax] + (ax == 3 ? 1 : 0);
    next_down = next_down && nc == cell[ax] - (ax == 3 ? 1 : 0);
  }
  const bool may_lo = c.r.head && lane > 0 && cell[3] >= 0 && prev_lo;
  const bool may_hi = c.r.head && lane > 0 && cell[3] >= 0 && prev_hi;
  c.give_up = c.r.head && cell[3] >= 0 && next_up && !may_hi;
  c.give_down = c.r.head && cell[3] >= 0 && next_down && !may_lo;
  const unsigned before = c.r.heads & ((1u << lane) - 1u);
  c.prev_head = before ? 31 - __clz((int)before) : 0;
  const int gives = __shfl_sync(kFullWarp, (int)c.give_up | ((int)c.give_down << 1), c.prev_head);
  c.take_lo = may_lo && (gives & 1);
  c.take_hi = may_hi && (gives & 2);
  c.any_take = __any_sync(kFullWarp, c.take_lo || c.take_hi);
  return c;
}

template <int G>
__device__ __forceinline__ void add_vec(float* p, const float* v) {
  if constexpr (G == 4)
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else if constexpr (G == 2)
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  else
    atomicAdd(p, v[0]);
}

// Adds a (row r0) and b (row r1), features f0 .. f0 + G - 1 of a level of nf:
// into its [size, nf] rows at seg (rows), else its [nf, size] segment of
// d_table, a float at a time.
template <int G>
__device__ __forceinline__ void add_pair(float* seg, bool rows, int size, int nf, int f0, int r0,
                                         int r1, const float* a, const float* b) {
  if (!rows) {
#pragma unroll
    for (int k = 0; k < G; ++k) {
      atomicAdd(seg + (size_t)(f0 + k) * size + r0, a[k]);
      atomicAdd(seg + (size_t)(f0 + k) * size + r1, b[k]);
    }
    return;
  }
  if constexpr (G <= 2) {
    if (nf == G && (r0 ^ r1) == 1) {  // one aligned pair of rows
      float v[2 * G];
      const bool odd = r0 & 1;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        v[k] = odd ? b[k] : a[k];
        v[G + k] = odd ? a[k] : b[k];
      }
      add_vec<2 * G>(seg + (size_t)(r0 & ~1) * G, v);
      return;
    }
  }
  add_vec<G>(seg + (size_t)r0 * nf + f0, a);
  add_vec<G>(seg + (size_t)r1 * nf + f0, b);
}

// One level, features in groups of G (nf a multiple of G), corners in four
// groups of two axis-0 pairs: q, q | 1 (bit 3 clear) and q | 8, q | 9.
template <int G>
__device__ __forceinline__ void level_bwd4(const CellRuns& cr, const int (&cell)[4],
                                           const float (&frac)[4], bool valid, int n, int N,
                                           int res, int size, int nf, int is_hash, int col,
                                           const float* __restrict__ d_out, float* seg,
                                           bool rows) {
  for (int f0 = 0; f0 < nf; f0 += G) {
    float go[G];
#pragma unroll
    for (int k = 0; k < G; ++k) go[k] = valid ? __ldg(d_out + (size_t)(col + f0 + k) * N + n) : 0.f;
#pragma unroll
    for (int q = 0; q < 8; q += 2) {  // bits 1 and 2
      const int corners[4] = {q, q | 1, q | 8, q | 9};
      float v[4 * G];
      int r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int ci[4];
        float w = 1.f;
#pragma unroll
        for (int ax = 0; ax < 4; ++ax) {
          const int b = (corners[i] >> ax) & 1;
          ci[ax] = cell[ax] + b;
          const float a = b ? frac[ax] : 1.f - frac[ax];
          w = ax == 0 ? a : w * a;
        }
        r[i] = row_of<4>(ci, res, size, is_hash);
#pragma unroll
        for (int k = 0; k < G; ++k) v[i * G + k] = w * go[k];
      }
      run_sum<1, 4 * G>(cr.r, v);
      if (cr.any_take) {
#pragma unroll
        for (int k = 0; k < 2 * G; ++k) {
          const float got = __shfl_sync(kFullWarp, cr.give_up ? v[2 * G + k] : v[k], cr.prev_head);
          if (cr.take_lo) v[k] += got;
          if (cr.take_hi) v[2 * G + k] += got;
        }
      }
      if (valid && cr.r.head) {
        if (!cr.give_down) add_pair<G>(seg, rows, size, nf, f0, r[0], r[1], v, v + G);
        if (!cr.give_up) add_pair<G>(seg, rows, size, nf, f0, r[2], r[3], v + 2 * G, v + 3 * G);
      }
    }
  }
}

__global__ void __launch_bounds__(kBwd4Threads, kBwd4MinBlocks)
grid4_bwd_kernel(const float* __restrict__ pos01,  // [N, 4]
                 const int* __restrict__ meta,     // [L, 6]
                 const float* __restrict__ d_out,  // [C, N]
                 float* __restrict__ d_table,      // flat, zeroed
                 float* __restrict__ inter,        // [n_inter], zeroed, or null
                 int N, int L, int n_inter) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  // whole warps walk the points, so every lane reaches the warp intrinsics
  for (int base = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32; base < N;
       base += warps * 32) {
    const int n = base + lane;
    const bool valid = n < N;
    float x[4];
#pragma unroll
    for (int ax = 0; ax < 4; ++ax)
      x[ax] = valid ? fminf(fmaxf(__ldg(pos01 + (size_t)n * 4 + ax), 0.f), 1.f) : 0.f;
    Place place;
    for (int l = 0; l < L; ++l) {
      const int res = __ldg(meta + l * META + 0);
      const int size = __ldg(meta + l * META + 1);
      const int offset = __ldg(meta + l * META + 2);
      const int nf = __ldg(meta + l * META + 3);
      const int is_hash = __ldg(meta + l * META + 4);
      const int col = __ldg(meta + l * META + 5);
      int off;
      const bool rows = place.next(0u, l, nf * size, 0, n_inter, &off) == 2;
      float* seg = rows ? inter + off : d_table + offset;
      const float fres = (float)res;
      int cell[4];
      float frac[4];
#pragma unroll
      for (int ax = 0; ax < 4; ++ax) {
        const float pos = __fmul_rn(x[ax], fres);
        const float c = fminf(floorf(pos), (float)(res - 1));
        cell[ax] = valid ? (int)c : -2;
        frac[ax] = __fsub_rn(pos, c);
      }
      const CellRuns cr = cell_runs(cell, lane);
      if (nf % 4 == 0)
        level_bwd4<4>(cr, cell, frac, valid, n, N, res, size, nf, is_hash, col, d_out, seg, rows);
      else if (nf % 2 == 0)
        level_bwd4<2>(cr, cell, frac, valid, n, N, res, size, nf, is_hash, col, d_out, seg, rows);
      else
        level_bwd4<1>(cr, cell, frac, valid, n, N, res, size, nf, is_hash, col, d_out, seg, rows);
    }
  }
}

// d_table's [F, size] segment of each level in the gradient scratch, from its
// [size, F] rows: a thread a row, a grid row of blocks a level.
__global__ void grid4_bwd_flush_kernel(const float* __restrict__ inter,
                                       const int* __restrict__ meta,
                                       float* __restrict__ d_table, int L, int n_inter) {
  Place place;
  for (int l = 0; l < L; ++l) {
    const int size = __ldg(meta + l * META + 1), offset = __ldg(meta + l * META + 2),
              nf = __ldg(meta + l * META + 3);
    int off;
    if (place.next(0u, l, nf * size, 0, n_inter, &off) != 2 || (int)blockIdx.y != l) continue;
    for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < size; r += gridDim.x * blockDim.x)
      for (int f = 0; f < nf; ++f)
        d_table[offset + (size_t)f * size + r] = inter[off + (size_t)r * nf + f];
  }
}

// K3's backward to the positions: one level's sum_c dw_c * (sum_f d_out[f]
// v_c[f]) into lj, for F features read together (F 2, EmerNeRF's static
// field; level_dx_any takes any other F): from a [size, F] copy (COPY, one
// load a corner) or the table's [F, size] segment. gp: the point's cotangent
// of the level's first feature (feature f at gp[f N]).
template <int F, bool COPY>
__device__ __forceinline__ void level_dx(const float* src, int size, const Cell<3>& c,
                                         const int (&rows)[8], const float* __restrict__ gp,
                                         size_t N, float (&lj)[3]) {
  float v[8][F], g[F];
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    if constexpr (COPY) {
      load_corner<F>(v[corner], src + (size_t)rows[corner] * F);
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) v[corner][f] = __ldg(src + (size_t)f * size + rows[corner]);
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) g[f] = __ldg(gp + f * N);
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    float w, dw[3];
    corner_weights<3, true>(c, corner, w, dw);
    float s = 0.f;
#pragma unroll
    for (int f = 0; f < F; ++f) s = __fadd_rn(s, __fmul_rn(v[corner][f], g[f]));
#pragma unroll
    for (int i = 0; i < 3; ++i) lj[i] = __fadd_rn(lj[i], __fmul_rn(dw[i], s));
  }
}

// The same for any F, a float at a time: feature f of row r at
// src[r * rs + f * fs] (a [size, F] copy: rs F, fs 1; the table: rs 1, fs size).
__device__ __forceinline__ void level_dx_any(const float* src, size_t rs, size_t fs, int nf,
                                             const Cell<3>& c, const int (&rows)[8],
                                             const float* __restrict__ gp, size_t N,
                                             float (&lj)[3]) {
  float s[8];
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) s[corner] = 0.f;
  for (int f = 0; f < nf; ++f) {
    const float g = __ldg(gp + f * N);
#pragma unroll
    for (int corner = 0; corner < 8; ++corner)
      s[corner] = __fadd_rn(s[corner], __fmul_rn(src[rows[corner] * rs + f * fs], g));
  }
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    float w, dw[3];
    corner_weights<3, true>(c, corner, w, dw);
#pragma unroll
    for (int i = 0; i < 3; ++i) lj[i] = __fadd_rn(lj[i], __fmul_rn(dw[i], s[corner]));
  }
}

constexpr int kBwdXThreads = 256;

__global__ void __launch_bounds__(kBwdXThreads)
grid_bwd_x_kernel(const float* __restrict__ table,
                  const float* __restrict__ pos01,  // [N, 3]
                  const int* __restrict__ meta,     // [L, 6]
                  const float* __restrict__ inter,  // the forward's interleaved levels, or null
                  const float* __restrict__ d_out,  // [C, N]
                  float* __restrict__ d_x,          // [N, 3]
                  int N, int L, unsigned stage_mask, int n_shared, int n_inter) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float x[3], gate[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float raw = __ldg(pos01 + (size_t)n * 3 + ax);
    x[ax] = fminf(fmaxf(raw, 0.f), 1.f);
    gate[ax] = (raw > 0.f && raw < 1.f) ? 1.f : ((raw == 0.f || raw == 1.f) ? 0.5f : 0.f);
  }
  float acc[3] = {0.f, 0.f, 0.f};
  Place place;  // the forward's walk: where each level's copy is
  for (int l = 0; l < L; ++l) {
    const int res = __ldg(meta + l * META + 0);
    const int size = __ldg(meta + l * META + 1);
    const int offset = __ldg(meta + l * META + 2);
    const int nf = __ldg(meta + l * META + 3);
    const int is_hash = __ldg(meta + l * META + 4);
    const int col = __ldg(meta + l * META + 5);
    int off;
    const int where = place.next(stage_mask, l, nf * size, n_shared, n_inter, &off);
    const Cell<3> c = cell_of<3>(x, res);
    int rows[8];
#pragma unroll
    for (int corner = 0; corner < 8; ++corner)
      rows[corner] = corner_row<3>(c, corner, res, size, is_hash);
    const float* gp = d_out + (size_t)col * N + n;
    const float* cp = where == 2 ? inter + off : nullptr;
    const float* tp = table + offset;
    float lj[3] = {0.f, 0.f, 0.f};
    if (where == 2 && nf == 2)
      level_dx<2, true>(cp, size, c, rows, gp, N, lj);
    else if (where != 2 && nf == 2)
      level_dx<2, false>(tp, size, c, rows, gp, N, lj);
    else if (where == 2)
      level_dx_any(cp, nf, 1, nf, c, rows, gp, N, lj);
    else
      level_dx_any(tp, 1, size, nf, c, rows, gp, N, lj);
    const float fres = (float)res;
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(lj[i], fres));
  }
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) d_x[(size_t)n * 3 + ax] = __fmul_rn(acc[ax], gate[ax]);
}

}  // namespace

// stage_mask: bit l set where level l may be staged in shared memory (l <
// 31); n_shared: the floats a block stages (those levels' F x size each,
// rounded up to 4, in level order, while they fit); inter: n_inter floats
// into which the other levels are interleaved the same way, while they fit
// (null if n_inter is 0), by a first kernel where fill_inter (else the
// caller's copy of the same table is used as it is); a level that fits
// neither is read from the table. max_f: the widest level's F (the narrow
// kernel where it is at most 2; a wider level there is read a float at a
// time, so a wrong max_f costs speed only). D: the points' dimension, 3 or 4
// (pos01 [N, D]; a jacobian at D = 3 only).
// The grid: a thread a point, in blocks of FwdShape's threads, persistent
// where n_shared > 0 (FwdShape's staged blocks a SM).
extern "C" int lotd_grid_fwd(const void* table, const void* pos01, const void* meta,
                             void* out, void* jac, void* inter, int fill_inter, int N, int C,
                             int L, int stage_mask, int n_shared, int n_inter, int max_f, int D,
                             void* stream) {
  if (n_shared < 0 || n_inter < 0 || (n_inter > 0 && inter == nullptr) || N < 0 ||
      (D != 3 && D != 4) || (D == 4 && jac != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const GridArgs a{(const float*)table, (const float*)pos01, (const int*)meta,
                   (const float*)inter, (float*)out, (float*)jac, N, C, L,
                   (unsigned)stage_mask, n_shared, n_inter};
  if (n_inter > 0 && fill_inter) {
    int blocks = (n_inter + 4 * 256 - 1) / (4 * 256);
    blocks = blocks > 16 * sms ? 16 * sms : blocks;
    grid_interleave_kernel<<<blocks, 256, 0, s>>>((const float*)table, (const int*)meta,
                                                   (float*)inter, L, (unsigned)stage_mask,
                                                   n_shared, n_inter);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const size_t smem = (size_t)n_shared * sizeof(float);
  const bool wide = max_f > 2;
  if (D == 4)
    return (int)(wide ? launch_grid<4, false, true>(a, smem, sms, s)
                      : launch_grid<4, false, false>(a, smem, sms, s));
  return (int)(jac != nullptr
                   ? (wide ? launch_grid<3, true, true>(a, smem, sms, s)
                           : launch_grid<3, true, false>(a, smem, sms, s))
                   : (wide ? launch_grid<3, false, true>(a, smem, sms, s)
                           : launch_grid<3, false, false>(a, smem, sms, s)));
}

// D 3: private_mask: bit l set where level l is summed in shared memory (l <
// 31); n_private: those levels' floats (F x size each, in level order), and
// the columns of scratch [SMs, n_private] (null if n_private is 0); inter
// null, n_inter 0. The grid: a thread a point in blocks of kBwdThreads, up to
// 16 blocks a SM, where n_private is 0; else persistent, one block of
// kBwdPrivateThreads a SM.
// D 4 (no d_jac): inter, the zeroed gradient scratch of n_inter floats (each
// level's [size, F] rows at the forward's places, while they fit; null if
// n_inter is 0), which a second kernel writes into d_table; no level private
// (private_mask, n_private and scratch are not read). The grid: whole warps
// of points in blocks of kBwd4Threads, up to 8 blocks a SM.
extern "C" int lotd_grid_bwd(const void* pos01, const void* meta, const void* d_out,
                             const void* d_jac, void* d_table, void* scratch, void* inter, int N,
                             int C, int L, int private_mask, int n_private, int n_inter, int D,
                             void* stream) {
  if (n_private < 0 || (n_private > 0 && scratch == nullptr) || (D != 3 && D != 4) ||
      (D == 4 && (d_jac != nullptr || d_out == nullptr)) || n_inter < 0 ||
      (n_inter > 0 && (inter == nullptr || D != 4)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if (D == 4) {
    const cudaStream_t s = (cudaStream_t)stream;
    int blocks = (N + kBwd4Threads - 1) / kBwd4Threads;
    blocks = blocks < 1 ? 1 : (blocks > 8 * sms ? 8 * sms : blocks);
    grid4_bwd_kernel<<<blocks, kBwd4Threads, 0, s>>>(
        (const float*)pos01, (const int*)meta, (const float*)d_out, (float*)d_table,
        (float*)inter, N, L, n_inter);
    if ((e = cudaGetLastError()) != cudaSuccess || n_inter == 0) return (int)e;
    grid4_bwd_flush_kernel<<<dim3(4 * sms, L), 256, 0, s>>>((const float*)inter,
                                                            (const int*)meta, (float*)d_table,
                                                            L, n_inter);
    return (int)cudaGetLastError();
  }
  const int threads = n_private > 0 ? kBwdPrivateThreads : kBwdThreads;
  const int cap = n_private > 0 ? sms : 16 * sms;
  int blocks = (N + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : (blocks > cap ? cap : blocks);
  const size_t smem = (size_t)n_private * sizeof(float);
  auto kernel = grid_bwd_kernel<3>;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos01, (const int*)meta, (const float*)d_out, (const float*)d_jac,
      (float*)d_table, (float*)scratch, N, C, L, (unsigned)private_mask, n_private);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_private == 0) return (int)e;
  grid_bwd_flush_kernel<<<(n_private + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)scratch, (const int*)meta, (float*)d_table, n_private, blocks, L,
      (unsigned)private_mask);
  return (int)cudaGetLastError();
}

// K3's backward to the positions, 3-D points: table, pos01 [N, 3], meta [L,
// 6], d_out [C, N], d_x [N, 3] written; stage_mask,
// n_shared, n_inter: the forward's plan (a level the forward stages in shared
// memory is read from the table here), inter its interleaved scratch (null if
// n_inter is 0), filled first where fill_inter. A thread a point.
extern "C" int lotd_grid_bwd_x(const void* table, const void* pos01, const void* meta,
                               const void* d_out, void* d_x, void* inter, int fill_inter, int N,
                               int L, int stage_mask, int n_shared, int n_inter, void* stream) {
  if (n_shared < 0 || n_inter < 0 || (n_inter > 0 && inter == nullptr) || N < 0 || L < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (n_inter > 0 && fill_inter) {
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    int blocks = (n_inter + 4 * 256 - 1) / (4 * 256);
    blocks = blocks > 16 * sms ? 16 * sms : blocks;
    grid_interleave_kernel<<<blocks, 256, 0, s>>>((const float*)table, (const int*)meta,
                                                   (float*)inter, L, (unsigned)stage_mask,
                                                   n_shared, n_inter);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (N == 0) return (int)cudaSuccess;
  grid_bwd_x_kernel<<<(N + kBwdXThreads - 1) / kBwdXThreads, kBwdXThreads, 0, s>>>(
      (const float*)table, (const float*)pos01, (const int*)meta, (const float*)inter,
      (const float*)d_out, (float*)d_x, N, L, (unsigned)stage_mask, n_shared, n_inter);
  return (int)cudaGetLastError();
}
