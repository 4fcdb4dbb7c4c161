// K2: index of the nearest centroid for each query, one thread per query.
//
// Replaces the Pallas TPU kernel of the JAX package,
// search/pallas_argmin.py :: _nearest_pallas_jit (the round-1 candidate of
// the locate ladder).
//
// Contract, as the TPU kernel's: queries [C, d] and centroids [E, d] come
// in f32, centred jointly in f64 by the caller; the score of centroid j is
// |c_j|^2 - 2 q.c_j (|q|^2 is constant per query), the lowest score wins
// and on an exact tie the lower index wins.  Scores are never stored.
//
// What bounds it on Hopper: arithmetic issue, ~6 instructions per
// (query, centroid) pair -- 262,144 x 4,096 pairs per chunk of the main
// path.  The inner product has K = d = 3, far too small for tensor cores,
// so it runs as FMAs on the CUDA cores.  Design: the block streams the
// centroids through shared memory in tiles of kTile (x, y, z, |c|^2)
// float4s, each read as one broadcast load by all threads; each thread
// keeps a running (min, index) in registers.  Memory stays bounded for any
// E (the TPU kernel held a [P, E] score block in VMEM).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // centroids per shared-memory tile (32 KB)

template <int DIM>
__global__ void __launch_bounds__(kThreads)
nearest_centroid_kernel(const float* __restrict__ q,
                        const float* __restrict__ c, int64_t C, int64_t E,
                        int* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const int64_t row = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  float qv[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) qv[a] = row < C ? q[row * DIM + a] : 0.0f;
  float best = INFINITY;
  int64_t best_i = 0;
  for (int64_t t0 = 0; t0 < E; t0 += kTile) {
    const int n = (int)(E - t0 < kTile ? E - t0 : kTile);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* cj = c + (t0 + j) * DIM;
      float4 v;
      v.x = cj[0];
      v.y = cj[1];
      v.z = DIM == 3 ? cj[2] : 0.0f;
      v.w = v.x * v.x + v.y * v.y + v.z * v.z;
      tile[j] = v;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 v = tile[j];
      float dot = qv[0] * v.x + qv[1] * v.y;
      if constexpr (DIM == 3) dot += qv[2] * v.z;
      const float score = v.w - 2.0f * dot;
      if (score < best) {  // strict: the lowest index keeps a tie
        best = score;
        best_i = t0 + j;
      }
    }
    __syncthreads();
  }
  if (row < C) out[row] = (int)best_i;
}

}  // namespace

extern "C" int mmt_nearest_centroid(const void* queries, const void* centroids,
                                    int64_t C, int64_t E, int dim, void* out,
                                    void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (E <= 0 || E > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (C + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  const float* c = static_cast<const float*>(centroids);
  int* o = static_cast<int*>(out);
  if (dim == 3) {
    nearest_centroid_kernel<3>
        <<<(unsigned)blocks, kThreads, 0, s>>>(q, c, C, E, o);
  } else if (dim == 2) {
    nearest_centroid_kernel<2>
        <<<(unsigned)blocks, kThreads, 0, s>>>(q, c, C, E, o);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
