// K4: warm-started f64 Newton polish of accepted (point, element) pairs,
// one thread per row.
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
// What bounds it on Hopper: neither bytes nor FLOPs at the main path's
// size -- one step reads a 3 KB lattice row (order 4, 3-D; the 12 MB f64
// lattice of E = 4,096 sits in L2) against ~1,700 f64 FMAs, a few
// milliseconds' worth of f64 work per million rows at the card's f64 rate.
// The design keeps K1's: lattice gathered by id inside the kernel, product
// form Lagrange values with compile-time GLL constants, the outer node axis
// rolled to hold registers down.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gll64.cuh"

namespace {

using mmt_gll64::lagrange;
using mmt_gll64::pick;

// x(ref) and J[a][b] = dx_a/dref_b over the f64 lattice row nd (layout
// m * DIM + a, canonical row-major node order).
template <int ORDER, int DIM>
__device__ __forceinline__ void eval_map(const double* __restrict__ nd,
                                         const double (&l)[DIM][ORDER + 1],
                                         const double (&dl)[DIM][ORDER + 1],
                                         double (&x)[DIM],
                                         double (&J)[DIM][DIM]) {
  constexpr int N1 = ORDER + 1;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    x[a] = 0.0;
#pragma unroll
    for (int b = 0; b < DIM; ++b) J[a][b] = 0.0;
  }
#pragma unroll 1
  for (int i = 0; i < N1; ++i) {
    const double l0 = pick(l[0], i);
    const double d0 = pick(dl[0], i);
    if constexpr (DIM == 3) {
#pragma unroll
      for (int j = 0; j < N1; ++j) {
        const double l01 = l0 * l[1][j];
        const double d0l1 = d0 * l[1][j];
        const double l0d1 = l0 * dl[1][j];
#pragma unroll
        for (int k = 0; k < N1; ++k) {
          const double* v = nd + ((i * N1 + j) * N1 + k) * 3;
          const double N = l01 * l[2][k];
          const double g0 = d0l1 * l[2][k];
          const double g1 = l0d1 * l[2][k];
          const double g2 = l01 * dl[2][k];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const double va = __ldg(v + a);
            x[a] = fma(N, va, x[a]);
            J[a][0] = fma(g0, va, J[a][0]);
            J[a][1] = fma(g1, va, J[a][1]);
            J[a][2] = fma(g2, va, J[a][2]);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < N1; ++j) {
        const double* v = nd + (i * N1 + j) * 2;
        const double N = l0 * l[1][j];
        const double g0 = d0 * l[1][j];
        const double g1 = l0 * dl[1][j];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const double va = __ldg(v + a);
          x[a] = fma(N, va, x[a]);
          J[a][0] = fma(g0, va, J[a][0]);
          J[a][1] = fma(g1, va, J[a][1]);
        }
      }
    }
  }
}

template <int ORDER, int DIM>
__global__ void __launch_bounds__(128)
polish_pairs_kernel(const double* __restrict__ points,
                    const int* __restrict__ ids,
                    const float* __restrict__ ref0,
                    const double* __restrict__ ctr,
                    const double* __restrict__ inv_scale,
                    const double* __restrict__ nodes, int64_t M, int64_t E,
                    int iters, float* __restrict__ ref_hi,
                    float* __restrict__ ref_lo, uint8_t* __restrict__ ok_out) {
  constexpr int N1 = ORDER + 1;
  constexpr int NN = DIM == 3 ? N1 * N1 * N1 : N1 * N1;
  const int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (row >= M) return;
  const int e = ids[row];
  if (e < 0 || e >= E) {
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      ref_hi[row * DIM + a] = NAN;
      ref_lo[row * DIM + a] = NAN;
    }
    ok_out[row] = 0;
    return;
  }
  const double* nd = nodes + (int64_t)e * (NN * DIM);
  const double s = inv_scale[e];
  double p[DIM], ref[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    p[a] = (points[row * DIM + a] - ctr[(int64_t)e * DIM + a]) * s;
    ref[a] = (double)ref0[row * DIM + a];
  }

  bool ok = true;
  double l[DIM][N1], dl[DIM][N1], x[DIM], J[DIM][DIM];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int a = 0; a < DIM; ++a) lagrange<ORDER, true>(ref[a], l[a], dl[a]);
    eval_map<ORDER, DIM>(nd, l, dl, x, J);
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

#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const float hi = (float)ref[a];
    ref_hi[row * DIM + a] = hi;
    ref_lo[row * DIM + a] = (float)(ref[a] - (double)hi);
  }
  ok_out[row] = ok ? 1 : 0;
}

template <int ORDER, int DIM>
cudaError_t launch(const void* points, const void* ids, const void* ref0,
                   const void* ctr, const void* inv_scale, const void* nodes,
                   int64_t M, int64_t E, int iters, void* ref_hi,
                   void* ref_lo, void* ok, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  polish_pairs_kernel<ORDER, DIM><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const double*>(points), static_cast<const int*>(ids),
      static_cast<const float*>(ref0), static_cast<const double*>(ctr),
      static_cast<const double*>(inv_scale),
      static_cast<const double*>(nodes), M, E, iters,
      static_cast<float*>(ref_hi), static_cast<float*>(ref_lo),
      static_cast<uint8_t*>(ok));
  return cudaGetLastError();
}

}  // namespace

extern "C" int mmt_polish_pairs(const void* points, const void* ids,
                                const void* ref0, const void* ctr,
                                const void* inv_scale, const void* nodes,
                                int64_t M, int64_t E, int order, int dim,
                                int iters, void* ref_hi, void* ref_lo,
                                void* ok, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  if (M > (int64_t)0x7fffffff * 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (order * 10 + dim) {
    case 12: return (int)launch<1, 2>(points, ids, ref0, ctr, inv_scale,
                                      nodes, M, E, iters, ref_hi, ref_lo, ok,
                                      s);
    case 13: return (int)launch<1, 3>(points, ids, ref0, ctr, inv_scale,
                                      nodes, M, E, iters, ref_hi, ref_lo, ok,
                                      s);
    case 22: return (int)launch<2, 2>(points, ids, ref0, ctr, inv_scale,
                                      nodes, M, E, iters, ref_hi, ref_lo, ok,
                                      s);
    case 23: return (int)launch<2, 3>(points, ids, ref0, ctr, inv_scale,
                                      nodes, M, E, iters, ref_hi, ref_lo, ok,
                                      s);
    case 42: return (int)launch<4, 2>(points, ids, ref0, ctr, inv_scale,
                                      nodes, M, E, iters, ref_hi, ref_lo, ok,
                                      s);
    case 43: return (int)launch<4, 3>(points, ids, ref0, ctr, inv_scale,
                                      nodes, M, E, iters, ref_hi, ref_lo, ok,
                                      s);
    default: return (int)cudaErrorInvalidValue;
  }
}
