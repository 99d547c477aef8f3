// K11 pair_compact: the pair-budget compaction of a shared model's group.
//
// Replaces neuralsim_tpu/renderers/buffer_compose.py BufferComposeRenderer.
// ray_query, pair mode (lines 181-207 and 291-320): of the K x N (instance,
// ray) pairs of a group, select Bg in round-robin order (the j-th hit of
// instance k sorts with key j*K + k, every miss with key K*N; a stable argsort
// of the keys, the first Bg), and, on the training path, give each selected
// hit its slot among its ray's M = max_hits_per_ray lanes (argsort of the
// rows' rays, then searchsorted: the selected hits of a ray in selection
// order; the slot M and beyond, and every miss, go to the sink N*M that the
// scatter drops).
//
// No sort: every pair's place in the sorted order has a closed form. With
// rank[k, r] the 0-based hit index of ray r in instance k, H_k the hits of
// instance k and T their sum,
//   a hit (k, r) of rank j sits at  sum_k' min(H_k', j) + #{k' < k : H_k' > j},
//   a miss (k, r) sits at           T + #{misses before it in flat order k*N + r}
// (every miss has the same key, and the stable sort keeps them in flat order;
// misses fill the budget when T < Bg, and those rows are queried too). The
// selected hits of a ray are in (rank, k) order, so a selected hit's slot is
// the number of hits of the same ray with a smaller (rank, k).
//
// One launch of a thread-block cluster of C CTAs (C <= 16, past the portable
// 8 with cudaFuncAttributeNonPortableClusterSizeAllowed: the pairs' work is
// spread over the cluster's SMs only, and twice the SMs halve it; C = 1 where
// N is 32 rays or fewer). The rays are cut into words of 32, and CTA c takes
// WC consecutive words of every instance:
//   1. a warp turns an (instance, word) into one word of hit bits with
//      __ballot_sync, kept in shared memory with its popcount (a warp issues
//      the loads of 8 items before their ballots: the hit mask's one round
//      trip to device memory);
//   2. a warp an instance scans its words' counts: each word's hits before it
//      in the tile, and the instance's hits in the tile;
//   3. after cluster.sync(), each CTA reads the other CTAs' counts from their
//      shared memory (distributed shared memory): each instance's hits in the
//      earlier CTAs, and H_k; a second cluster barrier, its arrival after the
//      reads and its wait before the CTA exits, keeps every CTA's shared
//      memory alive while another may still read it;
//   4. a warp an (instance, word) again, skipping a word with no hit whose
//      misses all fall past the budget: a lane's rank is the word's prefix +
//      __popc(word & lanemask_lt); its place and slot follow the closed form
//      from H and, for the slot, the other instances' words at the same 32
//      rays, all in shared memory.
// No global scratch, no second launch, no serial prefix.
// What bounds it on an H100: neither bytes (K N hit bytes read, 8 + 1 (+ 8)
// bytes written a selected row) nor the K compare-adds a pair: it is bound by
// its dependent rounds (the hit mask's load, a block scan, two cluster
// barriers, the stores), which the design keeps to one launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCluster = 16;
// the opt-in shared memory of a block on an H100; a larger layout is refused
constexpr int kMaxSmem = 232448;

// Words of 32 rays and their split over the cluster: WC words a CTA, C CTAs
// (mirrored by ops/pair_compact.py pair_cluster_layout).
struct Layout {
  int C, WC;
  size_t smem;
};

Layout layout_for(int K, int N) {
  const int NW = (N + 31) / 32;
  const int per = NW < kMaxCluster ? NW : kMaxCluster;
  Layout l;
  l.WC = (NW + per - 1) / per;
  l.C = (NW + l.WC - 1) / l.WC;
  l.smem = (2 * (size_t)K * l.WC + 4 * (size_t)K + 1) * sizeof(int);
  return l;
}

// inclusive sum over the warp's lanes
__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// the (instance, word) items a warp loads before their ballots
constexpr int kBatch = 8;

// smem: words [K, WC] (the ballot words of the tile), pre [K, WC] (each
// word's hits, then the hits of its instance before it in the tile), cnt
// [K] (the tile's hits an instance, read by the cluster), base [K] (hits in
// the earlier CTAs), H [K], before [K + 1] (the hits of the instances before
// k; before[K] = T).
__global__ void __launch_bounds__(kThreads)
pair_compact_kernel(const uint8_t* __restrict__ hit,   // [K, N] bool
                    int64_t* __restrict__ order,       // [Bg]
                    uint8_t* __restrict__ hit_c,       // [Bg] bool
                    int64_t* __restrict__ slot_idx,    // [Bg] or null
                    int K, int N, int Bg, int M, int WC) {
  extern __shared__ int smem[];
  unsigned* words = reinterpret_cast<unsigned*>(smem);
  int* pre = smem + (size_t)K * WC;
  int* cnt = pre + (size_t)K * WC;
  int* base = cnt + K;
  int* H = base + K;
  int* before = H + K;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int NW = (N + 31) >> 5, w0 = c * WC;
  const int nw = max(0, min(WC, NW - w0));   // this CTA's words
  const int items = K * nw;

  // 1. each (instance, word) of the tile: one ballot, its word and hits
  for (int i0 = warp; i0 < items; i0 += warps * kBatch) {
    bool h[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * warps;
      const int k = i / nw, lw = i - k * nw;
      const int r = ((w0 + lw) << 5) + lane;
      h[b] = i < items && r < N && hit[(size_t)k * N + r] != 0;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * warps;
      const int k = i / nw, lw = i - k * nw;
      const unsigned word = __ballot_sync(0xffffffffu, h[b]);
      if (lane == 0 && i < items) {
        words[k * WC + lw] = word;
        pre[k * WC + lw] = __popc(word);
      }
    }
  }
  __syncthreads();
  // 2. a warp an instance: each word's hits before it in the tile
  for (int k = warp; k < K; k += warps) {
    int run = 0;
    for (int lw0 = 0; lw0 < nw; lw0 += 32) {
      const int lw = lw0 + lane;
      const int v = lw < nw ? pre[k * WC + lw] : 0;
      const int s = warp_inclusive(v, lane);
      if (lw < nw) pre[k * WC + lw] = run + s - v;
      run += __shfl_sync(0xffffffffu, s, 31);
    }
    if (lane == 0) cnt[k] = run;
  }
  cluster.sync();
  // 3. each instance's hits in the earlier CTAs and in all, from their
  // shared memory
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    int b = 0, t = 0;
#pragma unroll 8
    for (int q = 0; q < C; ++q) {
      const int v = cluster.map_shared_rank(cnt, q)[k];
      b += q < c ? v : 0;
      t += v;
    }
    base[k] = b;
    H[k] = t;
  }
  // this CTA's remote reads are done; the wait, before it exits, holds its
  // own shared memory until every CTA's are
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
  __syncthreads();
  // the hits of the instances before each, one warp
  if (warp == 0) {
    int run = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const int v = k < K ? H[k] : 0;
      const int s = warp_inclusive(v, lane);
      if (k < K) before[k] = run + s - v;
      run += __shfl_sync(0xffffffffu, s, 31);
    }
    if (lane == 0) before[K] = run;
  }
  __syncthreads();
  const long long T = before[K];
  const long long sink = (long long)N * M;

  // 4. every pair of the tile: its place and, where selected, its row, flag
  // and slot
  for (int i = warp; i < items; i += warps) {
    const int k = i / nw, lw = i - k * nw;
    const int r = ((w0 + lw) << 5) + lane;
    const bool in = r < N;
    const unsigned word = words[k * WC + lw];
    const int j0 = base[k] + pre[k * WC + lw];                // hits before the word
    if (word == 0 && T + (long long)k * N + r - lane - before[k] - j0 >= Bg) continue;
    const bool h = (word >> lane) & 1u;
    // the hits of instance k before ray r: a hit's rank
    const int j = j0 + __popc(word & below);
    long long pos;
    if (h) {
      pos = 0;
#pragma unroll 8
      for (int q = 0; q < K; ++q) {
        const int Hq = H[q];
        pos += min(Hq, j) + (q < k && Hq > j ? 1 : 0);
      }
    } else {
      pos = T + (long long)k * N + r - before[k] - j;
    }
    const bool sel = in && pos < Bg;
    if (sel) {
      order[pos] = (long long)k * N + r;
      hit_c[pos] = h ? 1 : 0;
    }
    if (slot_idx == nullptr) continue;
    if (sel && !h) slot_idx[pos] = sink;
    const bool want = sel && h;
    if (!want) continue;
    // the hits of ray r with a smaller (rank, instance): each instance's word
    int slot = 0;
#pragma unroll 8
    for (int q = 0; q < K; ++q) {
      const unsigned wq = words[q * WC + lw];
      const int jq = base[q] + pre[q * WC + lw] + __popc(wq & below);
      slot += (wq >> lane) & 1u && (jq < j || (jq == j && q < k)) ? 1 : 0;
    }
    slot_idx[pos] = slot < M ? (long long)r * M + slot : sink;
  }
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

}  // namespace

// hit [K, N] bool -> order [Bg] int64, hit_c [Bg] bool and, where slot_idx is
// not null, the slot index [Bg] int64 of each row among M lanes a ray. One
// launch, one cluster; refused (cudaErrorInvalidValue) where the layout's
// shared memory passes the card's 227 KB.
extern "C" int pair_compact(const void* hit, void* order, void* hit_c, void* slot_idx, int K,
                            int N, int Bg, int M, void* stream) {
  if (K < 1 || N < 1 || Bg < 1 || (long long)Bg > (long long)K * N || K > 4096 ||
      (slot_idx && M < 1))
    return (int)cudaErrorInvalidValue;
  const Layout l = layout_for(K, N);
  if (l.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (l.C > 8 && (e = cudaFuncSetAttribute(pair_compact_kernel,
                                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
                     cudaSuccess)
    return (int)e;
  if (l.smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(pair_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)l.smem)) != cudaSuccess)
    return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, pair_compact_kernel, (const uint8_t*)hit, (int64_t*)order,
                              (uint8_t*)hit_c, (int64_t*)slot_idx, K, N, Bg, M, l.WC)) !=
      cudaSuccess)
    return (int)e;
  return (int)cudaGetLastError();
}
