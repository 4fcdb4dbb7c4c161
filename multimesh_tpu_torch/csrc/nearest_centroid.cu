// K2: index of the nearest centroid for each query, kQ queries per thread.
//
// Replaces the Pallas TPU kernel of the JAX package,
// search/pallas_argmin.py :: _nearest_pallas_jit (the round-1 candidate of
// the locate ladder).
//
// Contract, as the TPU kernel's: queries [C, d] and centroids [E, d] are
// centred jointly on `center` (the centroids' mean) in f64 and ranked in
// f32 -- here the kernel centres them as it loads them, (float)(x -
// center), so no centred copies reach device memory; the score of
// centroid j is |c_j|^2 - 2 q.c_j (|q|^2 is constant per query), the
// lowest score wins and on an exact tie the lower index wins.  Scores are
// never stored.
//
// What bounds it on Hopper: arithmetic issue -- 262,144 x 4,096 pairs per
// chunk of the main path.  The inner product has K = d = 3, far too small
// for tensor cores, so it runs as FMAs on the CUDA cores.  Design: the
// block streams centroids through shared memory in tiles of kTile
// (x, y, z, |c|^2) float4s; each thread holds kQ queries in registers,
// pre-scaled by -2, so one broadcast LDS.128 feeds kQ scores of three FMAs
// each (fma(-2qx, cx, fma(-2qy, cy, fma(-2qz, cz, |c|^2)))).  A pair then
// costs 4 instructions: the 3 FFMA and an fminf into the minimum of its
// group of kGroup consecutive centroids; only once a group does each
// query compare that minimum with its best (strict <, so an earlier group
// keeps a tie) and note the group.  At the end each query scores its best
// group again, with the same operations on the same floats, and takes the
// first centroid whose score equals its best: the lowest index among the
// minima, as a running (score, index) with a strict < would give, at two
// thirds of its instructions.  A 262,144-query chunk makes 512 blocks of
// 4 warps, all resident at once on 132 SMs.  (Splitting the centroids
// into spans across more blocks, with a merge of the spans' best pairs,
// was tried and only added time at that shape, more with every cut.)
// Memory stays bounded for any E (the TPU kernel held a [P, E] score
// block in VMEM).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 4;        // queries per thread
constexpr int kTile = 1024;  // centroids per shared-memory tile (16 KB)
constexpr int kGroup = 16;   // centroids per running minimum

// (x, y, z, |c|^2) of centroid j centred on m, the same operations
// wherever it is scored
template <int DIM>
__device__ __forceinline__ float4 centroid(const double* __restrict__ c,
                                           const double (&m)[3], int64_t j) {
  float4 v;
  v.x = (float)(c[j * DIM] - m[0]);
  v.y = (float)(c[j * DIM + 1] - m[1]);
  v.z = DIM == 3 ? (float)(c[j * DIM + 2] - m[2]) : 0.0f;
  v.w = fmaf(v.z, v.z, fmaf(v.y, v.y, v.x * v.x));
  return v;
}

template <int DIM>
__device__ __forceinline__ float score(float qx, float qy, float qz,
                                       const float4& v) {
  float s = v.w;
  if constexpr (DIM == 3) s = fmaf(qz, v.z, s);
  s = fmaf(qy, v.y, s);
  return fmaf(qx, v.x, s);
}

template <int DIM>
__global__ void __launch_bounds__(kThreads)
nearest_centroid_kernel(const double* __restrict__ q,
                        const double* __restrict__ c,
                        const double* __restrict__ center, int64_t C,
                        int64_t E, int* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const int64_t base = blockIdx.x * (int64_t)(kThreads * kQ) + threadIdx.x;
  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int best_g[kQ];  // first centroid of the group holding the best score
  const double m[3] = {center[0], center[1], DIM == 3 ? center[2] : 0.0};
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int64_t row = base + u * kThreads;
    const bool in = row < C;
    qx[u] = in ? -2.0f * (float)(q[row * DIM] - m[0]) : 0.0f;
    qy[u] = in ? -2.0f * (float)(q[row * DIM + 1] - m[1]) : 0.0f;
    qz[u] = in && DIM == 3 ? -2.0f * (float)(q[row * DIM + 2] - m[2]) : 0.0f;
    best[u] = INFINITY;
    best_g[u] = 0;
  }
  for (int64_t t0 = 0; t0 < E; t0 += kTile) {
    const int n = (int)(E - t0 < kTile ? E - t0 : kTile);
    for (int j = threadIdx.x; j < n; j += kThreads)
      tile[j] = centroid<DIM>(c, m, t0 + j);
    __syncthreads();
    for (int g = 0; g < n; g += kGroup) {
      float gmin[kQ];
#pragma unroll
      for (int u = 0; u < kQ; ++u) gmin[u] = INFINITY;
      if (g + kGroup <= n) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const float4 v = tile[g + j];
#pragma unroll
          for (int u = 0; u < kQ; ++u)
            gmin[u] = fminf(gmin[u], score<DIM>(qx[u], qy[u], qz[u], v));
        }
      } else {  // the ragged end of the centroids
        for (int j = g; j < n; ++j) {
          const float4 v = tile[j];
#pragma unroll
          for (int u = 0; u < kQ; ++u)
            gmin[u] = fminf(gmin[u], score<DIM>(qx[u], qy[u], qz[u], v));
        }
      }
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        const bool lt = gmin[u] < best[u];  // strict: earlier group keeps
        best[u] = lt ? gmin[u] : best[u];
        best_g[u] = lt ? (int)t0 + g : best_g[u];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int64_t row = base + u * kThreads;
    if (row >= C) continue;
    // the first centroid of the best group that scores the best score
    // (none if every score was NaN: the group's first stands)
    const int g1 = best_g[u] + kGroup < E ? best_g[u] + kGroup : (int)E;
    int idx = best_g[u];
    for (int j = g1 - 1; j >= best_g[u]; --j)
      if (score<DIM>(qx[u], qy[u], qz[u], centroid<DIM>(c, m, j)) == best[u])
        idx = j;
    out[row] = idx;
  }
}

}  // namespace

extern "C" int mmt_nearest_centroid(const void* queries, const void* centroids,
                                    const void* center, int64_t C, int64_t E,
                                    int dim, void* out, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (E <= 0 || E > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (C + kThreads * kQ - 1) / (kThreads * kQ);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* q = static_cast<const double*>(queries);
  const double* c = static_cast<const double*>(centroids);
  const double* m = static_cast<const double*>(center);
  int* o = static_cast<int*>(out);
  if (dim == 3) {
    nearest_centroid_kernel<3><<<(unsigned)blocks, kThreads, 0, s>>>(
        q, c, m, C, E, o);
  } else if (dim == 2) {
    nearest_centroid_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(
        q, c, m, C, E, o);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
