// K1: fixed Newton inversion of the order-p tensor GLL map over
// (point, element) rows, one thread per row.
//
// Replaces the Pallas TPU kernels of the JAX package, search/pallas_newton.py
// :: newton_refs_rows (K1, every round of the locate ladder) and
// :: newton_refs (K3, the scan retry of crowded-out rows, which calls this
// kernel once per candidate column).
//
// Contract, as the TPU kernel's: the point is centred and scaled into the
// element's unit frame, p_c = (p - ctr[e]) * inv_scale[e] (here in f64,
// then cast to f32 -- the card has native f64, so the split-f32 centring
// of the TPU path is not needed), then `iters` Newton steps from ref = 0
// run in f32 on the element's f32 unit-frame lattice: 3x3 / 2x2 adjugate
// solve, det == 0 gives a zero step, a non-finite step is zeroed, refs
// are clamped to +/- clamp.  Outputs are the refs and the max-abs
// residual at the last iterate.  An out-of-range element id writes NaN
// refs and residual (never converged) instead of reading out of bounds.
//
// What bounds it on Hopper: the reads of the lattice rows.  Each step
// re-reads the row's (p+1)^d * d floats (1.5 KB at order 4 in 3-D), so a
// row moves ~28 KB over 19 map evaluations against ~19 x 2,000 FMAs; the
// lattice of the main path (E = 4,096 elements, 6 MB) sits in L2 and the
// row being solved mostly in L1.  Design choices: the lattice is gathered
// by element id inside the kernel (no [M, n*d] gather in device memory,
// as the TPU path materialises); the 1-D Lagrange values and derivatives
// use the product form with the GLL nodes and barycentric weights as
// compile-time constants; the node loop keeps its outer axis rolled so the
// order-4 body stays far from the 255-register ceiling.  Lattice staging
// in shared memory (rows of one block share few elements) is left for a
// later change.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// GLL nodes x_i and barycentric weights w_i = 1 / prod_{j != i}(x_i - x_j)
// (multimesh_tpu_torch/core/gll.py), as f32 like the TPU kernel's tables.
template <int ORDER> struct Gll;

template <> struct Gll<1> {
  __device__ __forceinline__ static float x(int i) {
    return i == 0 ? -1.0f : 1.0f;
  }
  __device__ __forceinline__ static float w(int i) {
    return i == 0 ? -0.5f : 0.5f;
  }
};

template <> struct Gll<2> {
  __device__ __forceinline__ static float x(int i) {
    return i == 0 ? -1.0f : (i == 1 ? 0.0f : 1.0f);
  }
  __device__ __forceinline__ static float w(int i) {
    return i == 1 ? -1.0f : 0.5f;
  }
};

template <> struct Gll<4> {
  __device__ __forceinline__ static float x(int i) {
    switch (i) {
      case 0: return -1.0f;
      case 1: return (float)-0.6546536707079771;
      case 2: return 0.0f;
      case 3: return (float)0.6546536707079771;
      default: return 1.0f;
    }
  }
  __device__ __forceinline__ static float w(int i) {
    switch (i) {
      case 0: return (float)0.8749999999999999;
      case 1: return (float)-2.041666666666667;
      case 2: return (float)2.333333333333334;
      case 3: return (float)-2.0416666666666665;
      default: return (float)0.8749999999999999;
    }
  }
};

// Cardinal values l_i(t) and derivatives l_i'(t), product form (the TPU
// kernel's _eval_lagrange), fully unrolled.
template <int ORDER>
__device__ __forceinline__ void lagrange(float t, float (&l)[ORDER + 1],
                                         float (&dl)[ORDER + 1]) {
  constexpr int N1 = ORDER + 1;
  float diff[N1];
#pragma unroll
  for (int j = 0; j < N1; ++j) diff[j] = t - Gll<ORDER>::x(j);
#pragma unroll
  for (int i = 0; i < N1; ++i) {
    float prod = 1.0f;
#pragma unroll
    for (int j = 0; j < N1; ++j)
      if (j != i) prod *= diff[j];
    l[i] = Gll<ORDER>::w(i) * prod;
    float total = 0.0f;
#pragma unroll
    for (int k = 0; k < N1; ++k) {
      if (k == i) continue;
      float term = 1.0f;
#pragma unroll
      for (int j = 0; j < N1; ++j)
        if (j != i && j != k) term *= diff[j];
      total += term;
    }
    dl[i] = Gll<ORDER>::w(i) * total;
  }
}

// a[i] for a runtime i without spilling the register array to local memory
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int i) {
  float v = a[0];
#pragma unroll
  for (int q = 1; q < N; ++q)
    if (i == q) v = a[q];
  return v;
}

// x(ref) and, with JAC, J[a][b] = dx_a/dref_b over all lattice nodes of
// the row nd (layout m * DIM + a, canonical row-major node order).
template <int ORDER, int DIM, bool JAC>
__device__ __forceinline__ void eval_map(const float* __restrict__ nd,
                                         const float (&l)[DIM][ORDER + 1],
                                         const float (&dl)[DIM][ORDER + 1],
                                         float (&x)[DIM],
                                         float (&J)[DIM][DIM]) {
  constexpr int N1 = ORDER + 1;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    x[a] = 0.0f;
#pragma unroll
    for (int b = 0; b < DIM; ++b) J[a][b] = 0.0f;
  }
#pragma unroll 1
  for (int i = 0; i < N1; ++i) {
    const float l0 = pick(l[0], i);
    const float d0 = pick(dl[0], i);
    if constexpr (DIM == 3) {
#pragma unroll
      for (int j = 0; j < N1; ++j) {
        const float l01 = l0 * l[1][j];
        const float d0l1 = d0 * l[1][j];
        const float l0d1 = l0 * dl[1][j];
#pragma unroll
        for (int k = 0; k < N1; ++k) {
          const float* v = nd + ((i * N1 + j) * N1 + k) * 3;
          const float N = l01 * l[2][k];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float va = __ldg(v + a);
            x[a] = fmaf(N, va, x[a]);
            if constexpr (JAC) {
              J[a][0] = fmaf(d0l1 * l[2][k], va, J[a][0]);
              J[a][1] = fmaf(l0d1 * l[2][k], va, J[a][1]);
              J[a][2] = fmaf(l01 * dl[2][k], va, J[a][2]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < N1; ++j) {
        const float* v = nd + (i * N1 + j) * 2;
        const float N = l0 * l[1][j];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float va = __ldg(v + a);
          x[a] = fmaf(N, va, x[a]);
          if constexpr (JAC) {
            J[a][0] = fmaf(d0 * l[1][j], va, J[a][0]);
            J[a][1] = fmaf(l0 * dl[1][j], va, J[a][1]);
          }
        }
      }
    }
  }
}

template <int ORDER, int DIM>
__device__ __forceinline__ void basis_1d(const float (&ref)[DIM],
                                         float (&l)[DIM][ORDER + 1],
                                         float (&dl)[DIM][ORDER + 1]) {
#pragma unroll
  for (int a = 0; a < DIM; ++a) lagrange<ORDER>(ref[a], l[a], dl[a]);
}

template <int ORDER, int DIM>
__global__ void __launch_bounds__(128)
newton_rows_kernel(const double* __restrict__ points,
                   const int* __restrict__ ids,
                   const double* __restrict__ ctr,
                   const double* __restrict__ inv_scale,
                   const float* __restrict__ nodes, int64_t M, int64_t E,
                   int iters, float clamp, float* __restrict__ refs,
                   float* __restrict__ res) {
  constexpr int N1 = ORDER + 1;
  constexpr int NN = DIM == 3 ? N1 * N1 * N1 : N1 * N1;
  const int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (row >= M) return;
  const int e = ids[row];
  if (e < 0 || e >= E) {
#pragma unroll
    for (int a = 0; a < DIM; ++a) refs[row * DIM + a] = NAN;
    res[row] = NAN;
    return;
  }
  const float* nd = nodes + (int64_t)e * (NN * DIM);
  const double s = inv_scale[e];
  float p[DIM], ref[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    p[a] = (float)((points[row * DIM + a] - ctr[(int64_t)e * DIM + a]) * s);
    ref[a] = 0.0f;
  }

  float l[DIM][N1], dl[DIM][N1], x[DIM], J[DIM][DIM];
  for (int it = 0; it < iters; ++it) {
    basis_1d<ORDER, DIM>(ref, l, dl);
    eval_map<ORDER, DIM, true>(nd, l, dl, x, J);
    float r[DIM], step[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) r[a] = p[a] - x[a];
    if constexpr (DIM == 3) {
      const float c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
      const float c01 = J[0][2] * J[2][1] - J[0][1] * J[2][2];
      const float c02 = J[0][1] * J[1][2] - J[0][2] * J[1][1];
      const float c10 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
      const float c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0];
      const float c12 = J[0][2] * J[1][0] - J[0][0] * J[1][2];
      const float c20 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
      const float c21 = J[0][1] * J[2][0] - J[0][0] * J[2][1];
      const float c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0];
      const float det = J[0][0] * c00 + J[0][1] * c10 + J[0][2] * c20;
      const float inv = det == 0.0f ? 0.0f : 1.0f / det;
      step[0] = (c00 * r[0] + c01 * r[1] + c02 * r[2]) * inv;
      step[1] = (c10 * r[0] + c11 * r[1] + c12 * r[2]) * inv;
      step[2] = (c20 * r[0] + c21 * r[1] + c22 * r[2]) * inv;
    } else {
      const float det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
      const float inv = det == 0.0f ? 0.0f : 1.0f / det;
      step[0] = (J[1][1] * r[0] - J[0][1] * r[1]) * inv;
      step[1] = (J[0][0] * r[1] - J[1][0] * r[0]) * inv;
    }
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      const float st = isfinite(step[a]) ? step[a] : 0.0f;
      ref[a] = fminf(fmaxf(ref[a] + st, -clamp), clamp);
    }
  }

  // residual at the last iterate, in the unit-element frame
  basis_1d<ORDER, DIM>(ref, l, dl);
  eval_map<ORDER, DIM, false>(nd, l, dl, x, J);
  float r_max = 0.0f;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    r_max = fmaxf(r_max, fabsf(p[a] - x[a]));
    refs[row * DIM + a] = ref[a];
  }
  res[row] = r_max;
}

template <int ORDER, int DIM>
cudaError_t launch(const void* points, const void* ids, const void* ctr,
                   const void* inv_scale, const void* nodes, int64_t M,
                   int64_t E, int iters, float clamp, void* refs, void* res,
                   cudaStream_t stream) {
  constexpr int kThreads = 128;
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  newton_rows_kernel<ORDER, DIM><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const double*>(points), static_cast<const int*>(ids),
      static_cast<const double*>(ctr), static_cast<const double*>(inv_scale),
      static_cast<const float*>(nodes), M, E, iters, clamp,
      static_cast<float*>(refs), static_cast<float*>(res));
  return cudaGetLastError();
}

}  // namespace

extern "C" int mmt_newton_rows(const void* points, const void* ids,
                               const void* ctr, const void* inv_scale,
                               const void* nodes, int64_t M, int64_t E,
                               int order, int dim, int iters, float clamp,
                               void* refs, void* res, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  if (M > (int64_t)0x7fffffff * 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (order * 10 + dim) {
    case 12: return (int)launch<1, 2>(points, ids, ctr, inv_scale, nodes, M,
                                      E, iters, clamp, refs, res, s);
    case 13: return (int)launch<1, 3>(points, ids, ctr, inv_scale, nodes, M,
                                      E, iters, clamp, refs, res, s);
    case 22: return (int)launch<2, 2>(points, ids, ctr, inv_scale, nodes, M,
                                      E, iters, clamp, refs, res, s);
    case 23: return (int)launch<2, 3>(points, ids, ctr, inv_scale, nodes, M,
                                      E, iters, clamp, refs, res, s);
    case 42: return (int)launch<4, 2>(points, ids, ctr, inv_scale, nodes, M,
                                      E, iters, clamp, refs, res, s);
    case 43: return (int)launch<4, 3>(points, ids, ctr, inv_scale, nodes, M,
                                      E, iters, clamp, refs, res, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
