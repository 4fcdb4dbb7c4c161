// K5: f64 tensor-basis interpolation at (hi, lo) pair refs, one thread per
// output row.
//
// Replaces the Pallas TPU kernel of the JAX package,
// search/pallas_df32.py :: apply_refs_rows (wrapper apply_pairs), which
// evaluates the basis in double-f32 and dots it with split-f32 field rows
// under compensated sums because the TPU has no f64.  Here the basis and
// the dot run in native f64 on the f64 fields themselves, so the TPU's
// split, 128-padded field row tables are not needed.
//
// Contract: for row r with element e = elements[r] and ref = hi + lo
// (summed in f64), out[r, f] = sum_m N_m(ref) * fields[f, e, m] over the
// (p+1)^d lattice nodes, for every parameter f < F; element -1 (not found)
// gives 0, as the transfer operator's zero-fill; an element id >= E gives
// NaN instead of reading out of bounds.  The [M, (p+1)^d] weights never
// reach device memory.
//
// What bounds it on Hopper: the field reads, F rows of (p+1)^d doubles
// (1 KB each at order 4, 3-D) per output row against 2 FMAs per value.
// The fields of the main path (3 x 4,096 x 125 doubles, 12 MB) sit in L2;
// a thread reads its row's contiguous run, so loads are uncoalesced across
// a warp but cached.  Weights are rebuilt per parameter from the 1-D
// cardinals (two multiplies per node) rather than held as (p+1)^d live
// registers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gll64.cuh"

namespace {

using mmt_gll64::lagrange;
using mmt_gll64::pick;

template <int ORDER, int DIM>
__global__ void __launch_bounds__(128)
apply_pairs_kernel(const float* __restrict__ ref_hi,
                   const float* __restrict__ ref_lo,
                   const int* __restrict__ elements,
                   const double* __restrict__ fields, int64_t M, int64_t E,
                   int F, double* __restrict__ out) {
  constexpr int N1 = ORDER + 1;
  constexpr int NN = DIM == 3 ? N1 * N1 * N1 : N1 * N1;
  const int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (row >= M) return;
  const int e = elements[row];
  if (e < 0 || e >= E) {
    const double fill = e < 0 ? 0.0 : NAN;
    for (int f = 0; f < F; ++f) out[row * F + f] = fill;
    return;
  }
  double l[DIM][N1], unused[N1];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const double t =
        (double)ref_hi[row * DIM + a] + (double)ref_lo[row * DIM + a];
    lagrange<ORDER, false>(t, l[a], unused);
  }
  for (int f = 0; f < F; ++f) {
    const double* fr = fields + ((int64_t)f * E + e) * NN;
    double acc = 0.0;
#pragma unroll 1
    for (int i = 0; i < N1; ++i) {
      const double l0 = pick(l[0], i);
      if constexpr (DIM == 3) {
#pragma unroll
        for (int j = 0; j < N1; ++j) {
          const double l01 = l0 * l[1][j];
#pragma unroll
          for (int k = 0; k < N1; ++k)
            acc = fma(l01 * l[2][k], __ldg(fr + (i * N1 + j) * N1 + k), acc);
        }
      } else {
#pragma unroll
        for (int j = 0; j < N1; ++j)
          acc = fma(l0 * l[1][j], __ldg(fr + i * N1 + j), acc);
      }
    }
    out[row * F + f] = acc;
  }
}

template <int ORDER, int DIM>
cudaError_t launch(const void* ref_hi, const void* ref_lo,
                   const void* elements, const void* fields, int64_t M,
                   int64_t E, int F, void* out, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  apply_pairs_kernel<ORDER, DIM><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(ref_hi), static_cast<const float*>(ref_lo),
      static_cast<const int*>(elements), static_cast<const double*>(fields),
      M, E, F, static_cast<double*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int mmt_apply_pairs(const void* ref_hi, const void* ref_lo,
                               const void* elements, const void* fields,
                               int64_t M, int64_t E, int F, int order,
                               int dim, void* out, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  if (M > (int64_t)0x7fffffff * 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (order * 10 + dim) {
    case 12: return (int)launch<1, 2>(ref_hi, ref_lo, elements, fields, M, E,
                                      F, out, s);
    case 13: return (int)launch<1, 3>(ref_hi, ref_lo, elements, fields, M, E,
                                      F, out, s);
    case 22: return (int)launch<2, 2>(ref_hi, ref_lo, elements, fields, M, E,
                                      F, out, s);
    case 23: return (int)launch<2, 3>(ref_hi, ref_lo, elements, fields, M, E,
                                      F, out, s);
    case 42: return (int)launch<4, 2>(ref_hi, ref_lo, elements, fields, M, E,
                                      F, out, s);
    case 43: return (int)launch<4, 3>(ref_hi, ref_lo, elements, fields, M, E,
                                      F, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
