// Exact dedup of coordinate rows in first-appearance order: the unique
// rows and each row's index among them, the function of ops/dedup.py ::
// unique_points(order_by="first"), bit for bit.
//
// Replaces no TPU kernel: the JAX package groups a target mesh's slots on
// the host (np.lexsort over [N, d] f64 and an argsort for the order of
// first appearance), and so did the port before this kernel.  On the
// mesh path that host sort was most of a job while the card waited.
//
// Contract: points [N, d] f64, d = 2 or 3, N < 2^31.  Rows are equal when
// every coordinate compares equal with `==`, the host path's own test:
// -0.0 equals +0.0 (the unique row then carries the first row's bits) and
// a row with a NaN equals no row, itself a group.  The unique rows come in
// the order of their first appearance; recon[i] is row i's unique id.
//
// Design: hash grouping, O(N), no sort.
// 1. dedup_insert_kernel: open addressing with linear probing in a table
//    of T >= 2N int32 slots (a power of two, all -1 on entry; the entry
//    point fills it).  A row hashes its key's bits (-0.0 taken as +0.0),
//    claims an empty slot with atomicCAS or, finding its key there, takes
//    atomicMin of its index into it; the probe stops at its key's slot, so
//    every slot ends at the FIRST appearance of its key whatever order the
//    threads ran in.  Each row notes its slot.
// 2. dedup_rank_tiles_kernel: first[i] = table[slot of i]; row i is a
//    first appearance iff first[i] == i; an exclusive scan of those flags
//    within tiles of kTile rows, one block a tile, and each tile's total.
// 3. dedup_scan_totals_kernel: the tiles' totals scanned by one block; the
//    grand total, the number of unique rows U, after them.
// 4. (second entry point, once the caller has sized unique [U, d])
//    dedup_emit_kernel: recon[i] = rank of first[i]; a first appearance j
//    copies its row to unique[rank of j].
// Nothing depends on the order threads ran in: the outputs are the same
// bits on every run.
//
// What bounds it on Hopper: bytes, and their scatter.  The coordinates
// are read once in full (and again only for the U first appearances), the
// int32 scratch twice, recon (int64) and unique written once; the rest is
// random: a probe's 4-byte slot, and a matching row's coordinates, each
// cost a 32-byte sector.  The design keeps the random part to about one
// sector a row: the table stays at most half full (U <= N <= T / 2), so a
// probe ends after ~1.5 slots, a row already holding the first index of
// its slot skips the atomicMin, and the second pass reads its slot from
// the note instead of probing again.  For the mesh path's 1M rows the
// table (8 MB) and the scratch sit in the 50 MB L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;  // consecutive rows of a thread in the scan
constexpr int kTile = kThreads * kPer;
constexpr int kEmpty = -1;

__device__ __forceinline__ uint64_t mix(uint64_t z) {  // splitmix64
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

template <int DIM>
__device__ __forceinline__ uint32_t hash_row(const double (&x)[DIM]) {
  uint64_t h = 0x9e3779b97f4a7c15ull;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    // -0.0 == +0.0, so both hash as +0.0's bits
    const uint64_t bits =
        x[a] == 0.0 ? 0ull : (uint64_t)__double_as_longlong(x[a]);
    h = mix(h ^ bits);
  }
  return (uint32_t)h;
}

template <int DIM>
__global__ void __launch_bounds__(kThreads)
dedup_insert_kernel(const double* __restrict__ pts, int n,
                    int* __restrict__ table, uint32_t mask,
                    uint32_t* __restrict__ slot_of) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  double x[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) x[a] = pts[(int64_t)i * DIM + a];
  uint32_t s = hash_row<DIM>(x) & mask;
  while (true) {
    const int prev = atomicCAS(table + s, kEmpty, i);
    if (prev == kEmpty) break;
    bool same = true;
#pragma unroll
    for (int a = 0; a < DIM; ++a)
      same = same && pts[(int64_t)prev * DIM + a] == x[a];
    if (same) {
      if (prev > i) atomicMin(table + s, i);
      break;
    }
    s = (s + 1) & mask;
  }
  slot_of[i] = s;
}

// work[i]: in, row i's slot; out, first[i].  rank[i]: the number of first
// appearances before row i within its tile.  tile_sums[b]: tile b's total.
__global__ void __launch_bounds__(kThreads)
dedup_rank_tiles_kernel(const int* __restrict__ table, int n,
                        int* __restrict__ work, int* __restrict__ rank,
                        int* __restrict__ tile_sums) {
  __shared__ int warp_sums[kThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t base = (int64_t)blockIdx.x * kTile + t * kPer;
  int flag[kPer];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t r = base + k;
    flag[k] = 0;
    if (r < n) {
      const int f = table[(uint32_t)work[r]];
      work[r] = f;
      flag[k] = f == (int)r;
    }
    sum += flag[k];
  }
  int x = sum;  // inclusive scan of the threads' sums, warp then block
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w)
    before += w < warp ? warp_sums[w] : 0;
  int run = before + x - sum;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (base + k < n) rank[base + k] = run;
    run += flag[k];
  }
  if (t == kThreads - 1) tile_sums[blockIdx.x] = run;
}

// tile_sums[0..tiles) -> their exclusive prefix sums, in place, by one
// block; tile_sums[tiles] = the total (U)
__global__ void __launch_bounds__(1024)
dedup_scan_totals_kernel(int* __restrict__ tile_sums, int tiles) {
  __shared__ int warp_sums[32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int per = (tiles + 1023) / 1024;
  const int lo = t * per < tiles ? t * per : tiles;
  const int hi = lo + per < tiles ? lo + per : tiles;
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += tile_sums[i];
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = tile_sums[i];
    tile_sums[i] = run;
    run += c;
  }
  if (t == 1023) tile_sums[tiles] = run;
}

template <int DIM>
__global__ void __launch_bounds__(kThreads)
dedup_emit_kernel(const double* __restrict__ pts, int n,
                  const int* __restrict__ first, const int* __restrict__ rank,
                  const int* __restrict__ tile_start,
                  int64_t* __restrict__ recon, double* __restrict__ unique) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int f = first[i];
  const int g = rank[f] + tile_start[f / kTile];
  recon[i] = g;
  if (f == i) {
#pragma unroll
    for (int a = 0; a < DIM; ++a)
      unique[(int64_t)g * DIM + a] = pts[(int64_t)i * DIM + a];
  }
}

}  // namespace

// Rows of one tile of the scan: the caller sizes tile_sums by it.
extern "C" int mmt_dedup_tile() { return kTile; }

// Passes 1-3.  table: T int32 slots, T a power of two with 2N <= T <=
// 2^32, filled here; work, rank: N int32 each (work ends as first[]);
// tile_sums: n_tiles + 1 ints, n_tiles >= ceil(N / mmt_dedup_tile()), the
// number of unique rows last.
extern "C" int mmt_dedup_rank(const void* points, int64_t N, int dim,
                              void* table, int64_t T, void* work, void* rank,
                              void* tile_sums, int64_t n_tiles,
                              void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  const int64_t tiles = (N + kTile - 1) / kTile;
  if (N > 0x7fffffff || T < 2 * N || T > (int64_t(1) << 32) ||
      (T & (T - 1)) != 0 || n_tiles < tiles || (dim != 2 && dim != 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* p = static_cast<const double*>(points);
  int* tab = static_cast<int*>(table);
  int* w = static_cast<int*>(work);
  int* ts = static_cast<int*>(tile_sums);
  const int n = (int)N;
  const uint32_t mask = (uint32_t)(T - 1);
  const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
  cudaError_t err = cudaMemsetAsync(tab, 0xff, T * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  uint32_t* slot = reinterpret_cast<uint32_t*>(w);
  if (dim == 3)
    dedup_insert_kernel<3><<<blocks, kThreads, 0, s>>>(p, n, tab, mask, slot);
  else
    dedup_insert_kernel<2><<<blocks, kThreads, 0, s>>>(p, n, tab, mask, slot);
  dedup_rank_tiles_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      tab, n, w, static_cast<int*>(rank), ts);
  dedup_scan_totals_kernel<<<1, 1024, 0, s>>>(ts, (int)tiles);
  return (int)cudaGetLastError();
}

// Pass 4, after mmt_dedup_rank on the same arrays: recon [N] int64 and
// unique [U, dim] f64.
extern "C" int mmt_dedup_emit(const void* points, int64_t N, int dim,
                              const void* work, const void* rank,
                              const void* tile_sums, void* recon,
                              void* unique, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (N > 0x7fffffff || (dim != 2 && dim != 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* p = static_cast<const double*>(points);
  const int* f = static_cast<const int*>(work);
  const int* r = static_cast<const int*>(rank);
  const int* ts = static_cast<const int*>(tile_sums);
  int64_t* rc = static_cast<int64_t*>(recon);
  double* u = static_cast<double*>(unique);
  const int n = (int)N;
  const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
  if (dim == 3)
    dedup_emit_kernel<3><<<blocks, kThreads, 0, s>>>(p, n, f, r, ts, rc, u);
  else
    dedup_emit_kernel<2><<<blocks, kThreads, 0, s>>>(p, n, f, r, ts, rc, u);
  return (int)cudaGetLastError();
}
