// f64 GLL tables, 1-D Lagrange cardinals and the sum-factorised lattice
// evaluation of the f64 kernels (polish_pairs.cu, apply_pairs.cu).
//
// Nodes x_i and barycentric weights w_i = 1 / prod_{j != i}(x_i - x_j) are
// the f64 values of multimesh_tpu_torch/core/gll.py (gll_nodes,
// barycentric_weights), so a kernel and its plain twin evaluate the same
// polynomials.
#pragma once

#include <cuda_runtime.h>

namespace mmt_gll64 {

template <int ORDER> struct Gll;

template <> struct Gll<1> {
  __device__ __forceinline__ static double x(int i) {
    switch (i) {
      case 0: return -1.0;
      default: return 1.0;
    }
  }
  __device__ __forceinline__ static double w(int i) {
    switch (i) {
      case 0: return -0.5;
      default: return 0.5;
    }
  }
};

template <> struct Gll<2> {
  __device__ __forceinline__ static double x(int i) {
    switch (i) {
      case 0: return -1.0;
      case 1: return 0.0;
      default: return 1.0;
    }
  }
  __device__ __forceinline__ static double w(int i) {
    switch (i) {
      case 0: return 0.5;
      case 1: return -1.0;
      default: return 0.5;
    }
  }
};

template <> struct Gll<3> {
  __device__ __forceinline__ static double x(int i) {
    switch (i) {
      case 0: return -1.0;
      case 1: return -0.4472135954999579;
      case 2: return 0.4472135954999579;
      default: return 1.0;
    }
  }
  __device__ __forceinline__ static double w(int i) {
    switch (i) {
      case 0: return -0.625;
      case 1: return 1.3975424859373684;
      case 2: return -1.3975424859373684;
      default: return 0.625;
    }
  }
};

template <> struct Gll<4> {
  __device__ __forceinline__ static double x(int i) {
    switch (i) {
      case 0: return -1.0;
      case 1: return -0.6546536707079771;
      case 2: return 0.0;
      case 3: return 0.6546536707079771;
      default: return 1.0;
    }
  }
  __device__ __forceinline__ static double w(int i) {
    switch (i) {
      case 0: return 0.8749999999999999;
      case 1: return -2.041666666666667;
      case 2: return 2.333333333333334;
      case 3: return -2.0416666666666665;
      default: return 0.8749999999999999;
    }
  }
};

template <> struct Gll<5> {
  __device__ __forceinline__ static double x(int i) {
    switch (i) {
      case 0: return -1.0;
      case 1: return -0.7650553239294647;
      case 2: return -0.2852315164806451;
      case 3: return 0.2852315164806451;
      case 4: return 0.7650553239294647;
      default: return 1.0;
    }
  }
  __device__ __forceinline__ static double w(int i) {
    switch (i) {
      case 0: return -1.3125;
      case 1: return 3.1272565826974357;
      case 2: return -3.7864830338951148;
      case 3: return 3.786483033895115;
      case 4: return -3.1272565826974352;
      default: return 1.3125000000000002;
    }
  }
};

template <> struct Gll<6> {
  __device__ __forceinline__ static double x(int i) {
    switch (i) {
      case 0: return -1.0;
      case 1: return -0.830223896278567;
      case 2: return -0.46884879347071423;
      case 3: return 0.0;
      case 4: return 0.46884879347071423;
      case 5: return 0.830223896278567;
      default: return 1.0;
    }
  }
  __device__ __forceinline__ static double w(int i) {
    switch (i) {
      case 0: return 2.0625;
      case 1: return -4.972869706086958;
      case 2: return 6.210369706086957;
      case 3: return -6.6;
      case 4: return 6.210369706086957;
      case 5: return -4.972869706086958;
      default: return 2.0625000000000004;
    }
  }
};

template <> struct Gll<7> {
  __device__ __forceinline__ static double x(int i) {
    switch (i) {
      case 0: return -1.0;
      case 1: return -0.8717401485096066;
      case 2: return -0.5917001814331423;
      case 3: return -0.20929921790247885;
      case 4: return 0.20929921790247885;
      case 5: return 0.5917001814331423;
      case 6: return 0.8717401485096066;
      default: return 1.0;
    }
  }
  __device__ __forceinline__ static double w(int i) {
    switch (i) {
      case 0: return -3.3515624999999996;
      case 1: return 8.140722718253864;
      case 2: return -10.358136828950462;
      case 3: return 11.389813748486596;
      case 4: return -11.389813748486597;
      case 5: return 10.358136828950459;
      case 6: return -8.140722718253866;
      default: return 3.3515624999999987;
    }
  }
};

// Cardinal values l_i(t) = w_i P_i S_i and, with DERIV, derivatives
// l_i'(t), from the prefix products P_i = prod_{j<i}(t - x_j), the suffix
// products S_i = prod_{j>i}(t - x_j) and their derivatives, fully unrolled
// (the polynomials of gll.lagrange_eval / lagrange_deriv, rounded in
// another order).
template <int ORDER, bool DERIV>
__device__ __forceinline__ void lagrange(double t, double (&l)[ORDER + 1],
                                         double (&dl)[ORDER + 1]) {
  constexpr int N1 = ORDER + 1;
  double d[N1], P[N1], dP[N1], S[N1], dS[N1];
#pragma unroll
  for (int j = 0; j < N1; ++j) d[j] = t - Gll<ORDER>::x(j);
  P[1] = d[0];
  dP[1] = 1.0;
#pragma unroll
  for (int i = 2; i < N1; ++i) {
    P[i] = P[i - 1] * d[i - 1];
    if constexpr (DERIV) dP[i] = fma(dP[i - 1], d[i - 1], P[i - 1]);
  }
  S[N1 - 2] = d[N1 - 1];
  dS[N1 - 2] = 1.0;
#pragma unroll
  for (int i = N1 - 3; i >= 0; --i) {
    S[i] = S[i + 1] * d[i + 1];
    if constexpr (DERIV) dS[i] = fma(dS[i + 1], d[i + 1], S[i + 1]);
  }
  l[0] = Gll<ORDER>::w(0) * S[0];
#pragma unroll
  for (int i = 1; i < N1 - 1; ++i) l[i] = Gll<ORDER>::w(i) * (P[i] * S[i]);
  l[N1 - 1] = Gll<ORDER>::w(N1 - 1) * P[N1 - 1];
  if constexpr (DERIV) {
    dl[0] = Gll<ORDER>::w(0) * dS[0];
#pragma unroll
    for (int i = 1; i < N1 - 1; ++i)
      dl[i] = Gll<ORDER>::w(i) * fma(dP[i], S[i], P[i] * dS[i]);
    dl[N1 - 1] = Gll<ORDER>::w(N1 - 1) * dP[N1 - 1];
  }
}

// a[i] for a runtime i without spilling the register array to local memory
template <int N>
__device__ __forceinline__ double pick(const double (&a)[N], int i) {
  double v = a[0];
#pragma unroll
  for (int q = 1; q < N; ++q)
    if (i == q) v = a[q];
  return v;
}

// NC node components (the lattice's d coordinates, or one field value)
// staged in shared memory as NC planes of NN doubles: one LDS.64 broadcast
// per read.
template <int NC, int NN> struct SharedNodes {
  const double* p;
  __device__ __forceinline__ void node(int m, double (&v)[NC]) const {
#pragma unroll
    for (int a = 0; a < NC; ++a) v[a] = p[a * NN + m];
  }
};

// The same values in global memory, interleaved as m * NC + a.
template <int NC> struct GlobalNodes {
  const double* __restrict__ p;
  __device__ __forceinline__ void node(int m, double (&v)[NC]) const {
#pragma unroll
    for (int a = 0; a < NC; ++a) v[a] = __ldg(p + m * NC + a);
  }
};

// x[c] = sum_m N_m(ref) v_m[c] over the lattice nodes (canonical row-major
// order, axis 0 outermost) and, with JAC, J[c][b] = dx[c]/dref_b, by sum
// factorisation: over k, A = sum l2 v and B = sum dl2 v; over j, AA, AB,
// BA; over i, x and J.  At order 4, 3-D that is 155 FMAs a component for
// x alone and 345 with J.  The outer axis stays rolled to hold registers
// down; the same code serves shared and global nodes, so both give the
// same bits.
template <int ORDER, int DIM, int NC, bool JAC, class Nodes>
__device__ __forceinline__ void eval_nodes(const Nodes& nodes,
                                           const double (&l)[DIM][ORDER + 1],
                                           const double (&dl)[DIM][ORDER + 1],
                                           double (&x)[NC],
                                           double (&J)[NC][DIM]) {
  constexpr int N1 = ORDER + 1;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    x[c] = 0.0;
#pragma unroll
    for (int b = 0; b < DIM; ++b) J[c][b] = 0.0;
  }
#pragma unroll 1
  for (int i = 0; i < N1; ++i) {
    const double l0 = pick(l[0], i);
    const double d0 = JAC ? pick(dl[0], i) : 0.0;
    double AA[NC], AB[NC], BA[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) AA[c] = AB[c] = BA[c] = 0.0;
    if constexpr (DIM == 3) {
#pragma unroll
      for (int j = 0; j < N1; ++j) {
        double A[NC], B[NC];
#pragma unroll
        for (int k = 0; k < N1; ++k) {
          double v[NC];
          nodes.node((i * N1 + j) * N1 + k, v);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            A[c] = k == 0 ? l[2][0] * v[c] : fma(l[2][k], v[c], A[c]);
            if constexpr (JAC)
              B[c] = k == 0 ? dl[2][0] * v[c] : fma(dl[2][k], v[c], B[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          AA[c] = fma(l[1][j], A[c], AA[c]);
          if constexpr (JAC) {
            AB[c] = fma(l[1][j], B[c], AB[c]);
            BA[c] = fma(dl[1][j], A[c], BA[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        x[c] = fma(l0, AA[c], x[c]);
        if constexpr (JAC) {
          J[c][0] = fma(d0, AA[c], J[c][0]);
          J[c][1] = fma(l0, BA[c], J[c][1]);
          J[c][2] = fma(l0, AB[c], J[c][2]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < N1; ++j) {
        double v[NC];
        nodes.node(i * N1 + j, v);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          AA[c] = fma(l[1][j], v[c], AA[c]);
          if constexpr (JAC) AB[c] = fma(dl[1][j], v[c], AB[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        x[c] = fma(l0, AA[c], x[c]);
        if constexpr (JAC) {
          J[c][0] = fma(d0, AA[c], J[c][0]);
          J[c][1] = fma(l0, AB[c], J[c][1]);
        }
      }
    }
  }
}

}  // namespace mmt_gll64
