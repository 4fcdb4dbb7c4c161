// Layer 1 of hashing.content_hash on the card: the four wrapping uint32
// sums of a [R, 4096] matrix of words.
//
// Replaces no TPU kernel: both packages hash on the host
// (hashing.py :: content_hash).  It was added because the mesh path
// (engine.transfer_arrays) hashed every target on the host at ~1 GB/s
// before any card work of a job, and then uploaded the same bytes for
// the dedup; here the uploaded bytes are summed where they already are.
//
// Contract, every operation on uint32 and wrapping mod 2^32, as numpy's
// dtype=uint32 sums:
//   col[c]  = sum_r x[r, c]
//   colw[c] = sum_r (r * 2654435761 + 1) * x[r, c]
//   row[r]  = sum_c x[r, c]
//   roww[r] = sum_c (c * 40503 + 1) * x[r, c]
// colw is the closed form of content_hash's two-level fold
// (q * iw + col).  col and colw must be zero on entry (the blocks add
// into them); row and roww are written.  Sums mod 2^32 are associative
// and commutative, so any order of the additions gives the host's bits.
//
// What bounds it on Hopper: bytes, each word read once (16 KB a row,
// 238 MB for the 9,925,250-slot f64 target: 71 us at 3.35 TB/s).  The
// design: 1,024 threads a block, thread t owning columns 4t..4t+3, so a
// row is one coalesced 16-byte load a thread; a block walks a band of
// rows with kRows rows in flight, keeps its columns' two sums in
// registers across the band and adds them into col / colw with one
// atomicAdd a word at the end.  Each row's two sums are reduced by warp
// shuffles and then across the 32 warps through a double-buffered
// shared table, one __syncthreads every kRows rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4096;           // content_hash's row width, in words
constexpr int kThreads = kCols / 4;   // one uint4 of a row a thread
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;              // rows in flight a thread
constexpr uint32_t kRowMul = 2654435761u;
constexpr uint32_t kColMul = 40503u;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
content_sums_kernel(const uint4* __restrict__ x, int64_t R, int64_t band,
                    uint32_t* __restrict__ col, uint32_t* __restrict__ colw,
                    uint32_t* __restrict__ row, uint32_t* __restrict__ roww) {
  __shared__ uint32_t part[2][kWarps][2 * kRows];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * band;
  const int64_t r1 = r0 + band < R ? r0 + band : R;
  const uint32_t w0 = (uint32_t)(4 * t) * kColMul + 1u;
  const uint32_t w1 = w0 + kColMul, w2 = w1 + kColMul, w3 = w2 + kColMul;
  uint32_t c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  uint32_t cw0 = 0, cw1 = 0, cw2 = 0, cw3 = 0;
  int buf = 0;
  for (int64_t r = r0; r < r1; r += kRows) {
    uint4 v[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      v[u] = r + u < r1 ? x[(r + u) * kThreads + t] : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const uint32_t rw = (uint32_t)(r + u) * kRowMul + 1u;
      c0 += v[u].x;
      c1 += v[u].y;
      c2 += v[u].z;
      c3 += v[u].w;
      cw0 += rw * v[u].x;
      cw1 += rw * v[u].y;
      cw2 += rw * v[u].z;
      cw3 += rw * v[u].w;
      const uint32_t s = warp_sum(v[u].x + v[u].y + v[u].z + v[u].w);
      const uint32_t sw =
          warp_sum(w0 * v[u].x + w1 * v[u].y + w2 * v[u].z + w3 * v[u].w);
      if (lane == 0) {
        part[buf][warp][2 * u] = s;
        part[buf][warp][2 * u + 1] = sw;
      }
    }
    __syncthreads();
    // thread 2u sums row r + u, thread 2u + 1 its weighted sum; the other
    // buffer takes the next rows, so one barrier a round suffices
    if (t < 2 * kRows && r + t / 2 < r1) {
      uint32_t sum = 0;
#pragma unroll 8
      for (int k = 0; k < kWarps; ++k) sum += part[buf][k][t];
      (t & 1 ? roww : row)[r + t / 2] = sum;
    }
    buf ^= 1;
  }
  atomicAdd(col + 4 * t, c0);
  atomicAdd(col + 4 * t + 1, c1);
  atomicAdd(col + 4 * t + 2, c2);
  atomicAdd(col + 4 * t + 3, c3);
  atomicAdd(colw + 4 * t, cw0);
  atomicAdd(colw + 4 * t + 1, cw1);
  atomicAdd(colw + 4 * t + 2, cw2);
  atomicAdd(colw + 4 * t + 3, cw3);
}

}  // namespace

// words: R x 4096 uint32, 16-byte aligned; out: [col 4096 | colw 4096 |
// row R | roww R] uint32, its first 8,192 words zero; each block sums
// `band` rows.
extern "C" int mmt_content_sums(const void* words, int64_t R, int64_t band,
                                void* out, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  if (band <= 0 || ((uintptr_t)words & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (R + band - 1) / band;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  uint32_t* o = static_cast<uint32_t*>(out);
  content_sums_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(words), R, band, o, o + kCols, o + 2 * kCols,
      o + 2 * kCols + R);
  return (int)cudaGetLastError();
}
