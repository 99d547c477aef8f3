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
// Two launches: one block per instance scans its hit row (rank and H_k); one
// thread per ray walks its K pairs, writes order[pos] = k*N + r and
// hit_c[pos] for pos < Bg, and the slot index r*M + slot (or the sink).
// Indices only: the gradients flow through the values that the caller
// gathers and scatters with them.
// What bounds it on an H100: bytes (K*N hit bytes read; 8 + 1 (+ 8) bytes
// written a selected row) against K*N*K compare-and-adds: neither comes near
// a microsecond at the group's sizes, so it is bound by launch latency; the
// design keeps it to two launches and no sort.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 1024;

// One block per instance: rank[k, r] = (inclusive count of hits up to r) - 1,
// count[k] = H_k. Each thread counts a contiguous run of the row, the block
// scans the runs' counts, then each thread writes its run's ranks.
__global__ void pair_rank_kernel(const uint8_t* __restrict__ hit,   // [K, N] bool
                                 int32_t* __restrict__ rank,        // [K, N]
                                 int32_t* __restrict__ count,       // [K]
                                 int N) {
  __shared__ int sums[kScanThreads];
  const int k = blockIdx.x, t = threadIdx.x;
  const uint8_t* h = hit + (size_t)k * N;
  const int per = (N + blockDim.x - 1) / blockDim.x;
  const int lo = min(t * per, N), hi = min(lo + per, N);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += h[i] != 0;
  sums[t] = c;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {   // inclusive scan of the runs
    const int v = t >= off ? sums[t - off] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  int run = sums[t] - c;                              // hits before this run
  for (int i = lo; i < hi; ++i) {
    run += h[i] != 0;
    rank[(size_t)k * N + i] = run - 1;
  }
  if (t == blockDim.x - 1) count[k] = sums[t];
}

// One thread per ray. smem: H_k, then the hits of the instances before k.
__global__ void pair_select_kernel(const uint8_t* __restrict__ hit,     // [K, N] bool
                                   const int32_t* __restrict__ rank,    // [K, N]
                                   const int32_t* __restrict__ count,   // [K]
                                   int64_t* __restrict__ order,         // [Bg]
                                   uint8_t* __restrict__ hit_c,         // [Bg] bool
                                   int64_t* __restrict__ slot_idx,      // [Bg] or null
                                   int K, int N, int Bg, int M) {
  extern __shared__ int smem[];
  int* H = smem;
  int* before = smem + K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) H[i] = count[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int i = 0; i < K; ++i) { before[i] = acc; acc += H[i]; }
    before[K] = acc;                                    // T
  }
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const long long T = before[K];
  const long long sink = (long long)N * M;
  for (int k = 0; k < K; ++k) {
    const size_t at = (size_t)k * N + r;
    const bool h = hit[at] != 0;
    const int j = rank[at];
    long long pos;
    if (h) {
      pos = 0;
      for (int q = 0; q < K; ++q) pos += min(H[q], j) + (q < k && H[q] > j ? 1 : 0);
    } else {
      // the misses of earlier rows, and this row's misses before r
      pos = T + (long long)k * N + r - ((long long)before[k] + j + 1);
    }
    if (pos >= Bg) continue;
    order[pos] = (long long)k * N + r;
    hit_c[pos] = h ? 1 : 0;
    if (slot_idx == nullptr) continue;
    if (!h) {
      slot_idx[pos] = sink;
      continue;
    }
    int slot = 0;      // the hits of ray r selected before this one
    for (int q = 0; q < K; ++q) {
      const size_t aq = (size_t)q * N + r;
      if (q != k && hit[aq] && (rank[aq] < j || (rank[aq] == j && q < k))) ++slot;
    }
    slot_idx[pos] = slot < M ? (long long)r * M + slot : sink;
  }
}

}  // namespace

// hit [K, N] bool -> order [Bg] int64, hit_c [Bg] bool and, where slot_idx is
// not null, the slot index [Bg] int64 of each row among M lanes a ray.
// rank [K, N] and count [K] int32 are scratch.
extern "C" int pair_compact(const void* hit, void* rank, void* count, void* order, void* hit_c,
                            void* slot_idx, int K, int N, int Bg, int M, void* stream) {
  if (K < 1 || N < 1 || Bg < 1 || Bg > K * N || K > 4096 || (slot_idx && M < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  pair_rank_kernel<<<K, kScanThreads, 0, s>>>((const uint8_t*)hit, (int32_t*)rank,
                                              (int32_t*)count, N);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int threads = 128;
  pair_select_kernel<<<(N + threads - 1) / threads, threads, (2 * K + 1) * sizeof(int), s>>>(
      (const uint8_t*)hit, (const int32_t*)rank, (const int32_t*)count, (int64_t*)order,
      (uint8_t*)hit_c, (int64_t*)slot_idx, K, N, Bg, M);
  return (int)cudaGetLastError();
}
