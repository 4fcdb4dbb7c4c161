// K5: f64 tensor-basis interpolation at (hi, lo) pair refs over output rows
// grouped by element, one thread per row, the block's element field values
// staged in shared memory.
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
// Rows are visited in the order `perm` gives (mmt_group_rows of
// newton_rows.cu); thread t of block b evaluates row perm[b * 128 + t] and
// writes out[row, :] at that row, so the caller's order is kept.  Any
// permutation gives the same results, bit for bit; grouping only makes
// them cheap.
//
// What bounds it on Hopper: with one thread per row in target order, a
// warp's 32 rows read 32 elements' 1 KB field rows, every load 32 sectors,
// ~0.8 GB of L2 traffic per 262,144 rows x 3 parameters.  Grouped, the
// 128 rows of a block share a few elements (~3 at 64 rows per element), so
// for each parameter the block copies those elements' 125-double rows once
// into shared memory, coalesced, and every read in the dot is a
// warp-uniform LDS.64 broadcast (grouping.cuh assigns the slots; a row
// whose element found none reads global memory with the same arithmetic,
// so its results are bit for bit those of a slot).  The 1-D cardinals are
// computed once per row and kept in registers for all F parameters; the
// dot is sum-factorised (over k, then j, then i: 155 FMAs a parameter at
// order 4, 3-D, where rebuilding each weight took 375 operations).  What
// remains is small: the grouping pass, the staging copies and the
// scattered 8-byte writes of the output rows.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gll64.cuh"
#include "grouping.cuh"

namespace {

using mmt_gll64::eval_nodes;
using mmt_gll64::GlobalNodes;
using mmt_gll64::lagrange;
using mmt_gll64::SharedNodes;
using mmt_grouping::kBlockRows;

constexpr int kSlotBytes = 32768;  // shared memory for staged field rows

template <int ORDER, int DIM>
__global__ void __launch_bounds__(kBlockRows)
apply_pairs_kernel(const float* __restrict__ ref_hi,
                   const float* __restrict__ ref_lo,
                   const int* __restrict__ elements,
                   const int* __restrict__ perm,
                   const double* __restrict__ fields, int64_t M, int64_t E,
                   int F, double* __restrict__ out) {
  constexpr int N1 = ORDER + 1;
  constexpr int NN = DIM == 3 ? N1 * N1 * N1 : N1 * N1;
  constexpr int kSlots =
      mmt_grouping::slots_for(kSlotBytes, NN * (int)sizeof(double));
  static_assert(kSlots >= 1, "one element field row must fit in kSlotBytes");
  __shared__ double rows[kSlots * NN];
  __shared__ mmt_grouping::SlotTable<kSlots> tab;

  const int t = threadIdx.x;
  const int64_t pos = blockIdx.x * (int64_t)kBlockRows + t;
  int64_t row = 0;
  int e = -1;
  if (pos < M) {
    row = perm[pos];
    e = elements[row];
  }
  const bool ok = pos < M && e >= 0 && e < E;
  int staged;
  const int slot = mmt_grouping::assign_slots(tab, e, ok, staged);

  double l[DIM][N1];
  if (ok) {
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      const double r =
          (double)ref_hi[row * DIM + a] + (double)ref_lo[row * DIM + a];
      lagrange<ORDER, false>(r, l[a], l[a]);
    }
  }
  const double fill = e < 0 ? 0.0 : NAN;

  // F is set at run time: one parameter's rows staged at a time
  for (int f = 0; f < F; ++f) {
    const double* fp = fields + (int64_t)f * E * NN;
    for (int q = t; q < staged * NN; q += kBlockRows) {
      const int s = q / NN;
      rows[q] = __ldg(fp + (int64_t)tab.elem[s] * NN + (q - s * NN));
    }
    __syncthreads();
    if (pos < M) {
      double v[1], unused[1][DIM];
      if (!ok) {
        v[0] = fill;
      } else if (slot < kSlots) {
        eval_nodes<ORDER, DIM, 1, false>(SharedNodes<1, NN>{rows + slot * NN},
                                         l, l, v, unused);
      } else {
        eval_nodes<ORDER, DIM, 1, false>(GlobalNodes<1>{fp + (int64_t)e * NN},
                                         l, l, v, unused);
      }
      out[row * F + f] = v[0];
    }
    __syncthreads();  // before the next parameter overwrites the slots
  }
}

template <int ORDER, int DIM>
cudaError_t launch(const void* ref_hi, const void* ref_lo,
                   const void* elements, const void* perm, const void* fields,
                   int64_t M, int64_t E, int F, void* out,
                   cudaStream_t stream) {
  const int64_t blocks = (M + kBlockRows - 1) / kBlockRows;
  apply_pairs_kernel<ORDER, DIM><<<(unsigned)blocks, kBlockRows, 0, stream>>>(
      static_cast<const float*>(ref_hi), static_cast<const float*>(ref_lo),
      static_cast<const int*>(elements), static_cast<const int*>(perm),
      static_cast<const double*>(fields), M, E, F, static_cast<double*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int mmt_apply_pairs(const void* ref_hi, const void* ref_lo,
                               const void* elements, const void* perm,
                               const void* fields, int64_t M, int64_t E,
                               int F, int order, int dim, void* out,
                               void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  if (M > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (order * 10 + dim) {
#define MMT_CASE(O, D) \
    case O * 10 + D: \
      return (int)launch<O, D>(ref_hi, ref_lo, elements, perm, fields, M, \
                               E, F, out, s);
    MMT_CASE(1, 2) MMT_CASE(1, 3) MMT_CASE(2, 2) MMT_CASE(2, 3)
    MMT_CASE(3, 2) MMT_CASE(3, 3) MMT_CASE(4, 2) MMT_CASE(4, 3)
    MMT_CASE(5, 2) MMT_CASE(5, 3) MMT_CASE(6, 2) MMT_CASE(6, 3)
    MMT_CASE(7, 2) MMT_CASE(7, 3)
#undef MMT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
