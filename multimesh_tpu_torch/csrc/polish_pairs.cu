// K4: warm-started f64 Newton polish of accepted (point, element) pairs
// over rows grouped by element, one thread per row, the block's element
// lattices staged in shared memory.
//
// Replaces the Pallas TPU kernel of the JAX package,
// search/pallas_df32.py :: polish_refs_rows (wrapper polish_pairs), which
// runs the same step in double-f32 (hi, lo) pair arithmetic because the TPU
// has no f64.  The card has native f64, so this kernel runs the step in
// f64 and only its output keeps the pair form the operator stores:
// hi = (float)ref, lo = (float)(ref - hi).
//
// Contract, as the TPU kernel's: the point is centred and scaled into the
// element's unit frame in f64, p_c = (p - ctr[e]) * inv_scale[e]; the
// element's f64 unit-frame lattice row is read by id; `iters` Newton steps
// from the f32 warm start ref0 evaluate the residual, the Jacobian and a
// 3x3 / 2x2 adjugate solve (det == 0 gives a zero step).  ok is true only
// if every |step| < 0.05, judged before a non-finite step is zeroed (so NaN
// is not ok); no clamp.  An out-of-range element id writes NaN refs and
// ok = false instead of reading out of bounds.
//
// Rows are visited in the order `perm` gives (mmt_group_rows of
// newton_rows.cu); thread t of block b polishes row perm[b * 128 + t] and
// writes its refs and ok back at that row, so the caller's order is kept.
// Any permutation gives the same results, bit for bit; grouping only makes
// them cheap.
//
// What bounds it on Hopper: with one thread per row in target order, a
// warp's 32 rows read 32 elements' 3 KB lattice rows (order 4, 3-D), every
// load 32 sectors, ~0.8 GB of L2 traffic per 262,144 rows.  Grouped, the
// 128 rows of a block share a few elements, so the block copies their
// lattices once into shared memory, coalesced, as three planes of 125
// doubles (3,000 B a slot, 10 slots in 32 KB, against ~3 elements a block
// at 64 rows per element), and every node read in the step is a
// warp-uniform LDS.64 broadcast (grouping.cuh assigns the slots; a row
// whose element found none reads global memory with the same arithmetic,
// so its results are bit for bit those of a slot).  x and J are evaluated
// by sum factorisation in f64 (gll64.cuh :: eval_nodes, 1,035 FMAs a step
// at order 4, 3-D, where the direct form took ~1,700) from prefix/suffix
// Lagrange products.  What remains is the f64 arithmetic, the grouping
// pass and the rows' scattered reads and writes.
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

constexpr int kSlotBytes = 32768;  // shared memory for staged lattices

// `iters` Newton steps from ref for the unit-frame point p; returns ok.
template <int ORDER, int DIM, class Nodes>
__device__ __forceinline__ bool polish(const Nodes& nodes,
                                       const double (&p)[DIM], int iters,
                                       double (&ref)[DIM]) {
  constexpr int N1 = ORDER + 1;
  bool ok = true;
  double l[DIM][N1], dl[DIM][N1], x[DIM], J[DIM][DIM];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int a = 0; a < DIM; ++a) lagrange<ORDER, true>(ref[a], l[a], dl[a]);
    eval_nodes<ORDER, DIM, DIM, true>(nodes, l, dl, x, J);
    double r[DIM], step[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) r[a] = p[a] - x[a];
    if constexpr (DIM == 3) {
      const double c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
      const double c01 = J[0][2] * J[2][1] - J[0][1] * J[2][2];
      const double c02 = J[0][1] * J[1][2] - J[0][2] * J[1][1];
      const double c10 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
      const double c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0];
      const double c12 = J[0][2] * J[1][0] - J[0][0] * J[1][2];
      const double c20 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
      const double c21 = J[0][1] * J[2][0] - J[0][0] * J[2][1];
      const double c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0];
      const double det = J[0][0] * c00 + J[0][1] * c10 + J[0][2] * c20;
      const double inv = det == 0.0 ? 0.0 : 1.0 / det;
      step[0] = (c00 * r[0] + c01 * r[1] + c02 * r[2]) * inv;
      step[1] = (c10 * r[0] + c11 * r[1] + c12 * r[2]) * inv;
      step[2] = (c20 * r[0] + c21 * r[1] + c22 * r[2]) * inv;
    } else {
      const double det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
      const double inv = det == 0.0 ? 0.0 : 1.0 / det;
      step[0] = (J[1][1] * r[0] - J[0][1] * r[1]) * inv;
      step[1] = (J[0][0] * r[1] - J[1][0] * r[0]) * inv;
    }
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      ok = ok && fabs(step[a]) < 0.05;  // NaN compares false: not ok
      ref[a] += isfinite(step[a]) ? step[a] : 0.0;
    }
  }
  return ok;
}

template <int ORDER, int DIM>
__global__ void __launch_bounds__(kBlockRows)
polish_pairs_kernel(const double* __restrict__ points,
                    const int* __restrict__ ids,
                    const int* __restrict__ perm,
                    const float* __restrict__ ref0,
                    const double* __restrict__ ctr,
                    const double* __restrict__ inv_scale,
                    const double* __restrict__ nodes, int64_t M, int64_t E,
                    int iters, float* __restrict__ ref_hi,
                    float* __restrict__ ref_lo, uint8_t* __restrict__ ok_out) {
  constexpr int N1 = ORDER + 1;
  constexpr int NN = DIM == 3 ? N1 * N1 * N1 : N1 * N1;
  constexpr int kSlots =
      mmt_grouping::slots_for(kSlotBytes, NN * DIM * (int)sizeof(double));
  static_assert(kSlots >= 1, "one element lattice must fit in kSlotBytes");
  __shared__ double lat[kSlots * DIM * NN];  // slot s, plane a: (s*DIM+a)*NN
  __shared__ mmt_grouping::SlotTable<kSlots> tab;

  const int t = threadIdx.x;
  const int64_t pos = blockIdx.x * (int64_t)kBlockRows + t;
  int64_t row = 0;
  int e = -1;
  if (pos < M) {
    row = perm[pos];
    e = ids[row];
  }
  const bool valid = pos < M && e >= 0 && e < E;
  int staged;
  const int slot = mmt_grouping::assign_slots(tab, e, valid, staged);

  // Stage the slotted lattices: consecutive threads read consecutive
  // doubles of an element's row (layout m * DIM + a) into its planes.
  for (int q = t; q < staged * NN * DIM; q += kBlockRows) {
    const int s = q / (NN * DIM);
    const int r = q - s * (NN * DIM);
    const int m = r / DIM;
    lat[(s * DIM + (r - m * DIM)) * NN + m] =
        __ldg(nodes + (int64_t)tab.elem[s] * (NN * DIM) + r);
  }
  __syncthreads();

  if (pos >= M) return;
  if (!valid) {
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      ref_hi[row * DIM + a] = NAN;
      ref_lo[row * DIM + a] = NAN;
    }
    ok_out[row] = 0;
    return;
  }
  const double sc = inv_scale[e];
  double p[DIM], ref[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    p[a] = (points[row * DIM + a] - ctr[(int64_t)e * DIM + a]) * sc;
    ref[a] = (double)ref0[row * DIM + a];
  }
  const bool ok =
      slot < kSlots
          ? polish<ORDER, DIM>(SharedNodes<DIM, NN>{lat + slot * DIM * NN},
                               p, iters, ref)
          : polish<ORDER, DIM>(
                GlobalNodes<DIM>{nodes + (int64_t)e * (NN * DIM)}, p, iters,
                ref);
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const float hi = (float)ref[a];
    ref_hi[row * DIM + a] = hi;
    ref_lo[row * DIM + a] = (float)(ref[a] - (double)hi);
  }
  ok_out[row] = ok ? 1 : 0;
}

template <int ORDER, int DIM>
cudaError_t launch(const void* points, const void* ids, const void* perm,
                   const void* ref0, const void* ctr, const void* inv_scale,
                   const void* nodes, int64_t M, int64_t E, int iters,
                   void* ref_hi, void* ref_lo, void* ok,
                   cudaStream_t stream) {
  const int64_t blocks = (M + kBlockRows - 1) / kBlockRows;
  polish_pairs_kernel<ORDER, DIM><<<(unsigned)blocks, kBlockRows, 0, stream>>>(
      static_cast<const double*>(points), static_cast<const int*>(ids),
      static_cast<const int*>(perm), static_cast<const float*>(ref0),
      static_cast<const double*>(ctr),
      static_cast<const double*>(inv_scale),
      static_cast<const double*>(nodes), M, E, iters,
      static_cast<float*>(ref_hi), static_cast<float*>(ref_lo),
      static_cast<uint8_t*>(ok));
  return cudaGetLastError();
}

}  // namespace

extern "C" int mmt_polish_pairs(const void* points, const void* ids,
                                const void* perm, const void* ref0,
                                const void* ctr, const void* inv_scale,
                                const void* nodes, int64_t M, int64_t E,
                                int order, int dim, int iters, void* ref_hi,
                                void* ref_lo, void* ok, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  if (M > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (order * 10 + dim) {
#define MMT_CASE(O, D) \
    case O * 10 + D: \
      return (int)launch<O, D>(points, ids, perm, ref0, ctr, inv_scale, \
                               nodes, M, E, iters, ref_hi, ref_lo, ok, s);
    MMT_CASE(1, 2) MMT_CASE(1, 3) MMT_CASE(2, 2) MMT_CASE(2, 3)
    MMT_CASE(3, 2) MMT_CASE(3, 3) MMT_CASE(4, 2) MMT_CASE(4, 3)
    MMT_CASE(5, 2) MMT_CASE(5, 3) MMT_CASE(6, 2) MMT_CASE(6, 3)
    MMT_CASE(7, 2) MMT_CASE(7, 3)
#undef MMT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
